"""Shade-pack row gather and its backward: the CUDA kernels and their plain
versions.

Port of the Pallas TPU kernel cudatracerlib_tpu/ops/shade_gather.py:69
(`_gather_tpu`, the forward of `packed_gather` :103) and of its custom VJP
(`_gather_bwd` :127-131, a scatter-add). The forward kernel lives in
csrc/shade_gather.cu, the backward in csrc/shade_gather_bwd.cu (each
header note says what bounds it on the H100 and what the design does about
it). The forward is exact (no bf16 hi/lo split); the backward is
deterministic (no atomics).

Layout: the output is row-major (B, C), one table row per index, and
scene/shade_pack.py `cols` returns column views of it; the JAX package's
(C, B) layout was forced by the TPU's tiling.

`packed_gather` is the differentiable wrapper (an autograd Function whose
backward is `packed_gather_bwd`). `packed_gather_bwd` also sums the hit
refinement's Woop-row cotangent and, through `gather_rows`, the cotangent
of every per-lane lookup into a small scene table (textures, materials,
per-triangle shading, light triangles), where PyTorch's own index backward
serialises the many lanes that share a row. CUDA tensors launch the
kernels, CPU tensors run the plain versions; no wrapper falls back from one
to the other.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .._build_util import CudaKernel
from ..utils.timing import CounterGroup, count, span

MAX_ROWS = 16384   # the shade pack's band (scene/shade_pack.pack_enabled)
MAX_BWD_COLS = 64  # the backward kernel's widest row: 32 threads x 2 columns
BWD_TILE = 256        # lanes a tile of the backward (TILE in the .cu)
BWD_MAX_RANGES = 32   # ranges of tiles the final kernel folds while tiles allow (MAX_RANGES)
BWD_MAX_RANGE_TILES = 1024  # tiles a range, at most (MAX_RANGE_TILES)
BWD_BAND_WORDS = 12288      # a band's accumulators and hit bytes, at most (BAND_WORDS)
BWD_FILL_CTAS = 256         # range-kernel CTAs the bands aim at (FILL_CTAS)
BWD_MIN_BAND_ROWS = 256     # rows a band keeps while raised for fill (MIN_BAND_ROWS)
BWD_MASK_WORDS_PER_COL = 32  # word masks while 32-row words <= this x C (MASK_WORDS_PER_COL)

# Each launch of a CUDA kernel adds one here, the counters
# launches.shade_gather.<kernel> (plain-version calls do not).
launches = CounterGroup("launches.shade_gather",
                        ("gather", "gather_bwd_tile", "gather_bwd_range", "gather_bwd_final"))

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_KERNEL = CudaKernel("shade_gather", [_P, _I, _I, _P, _I, _P, _P])
_BWD_KERNEL = CudaKernel("shade_gather_bwd", [_P, _I, _P, _L, _I, _P, _P, _L, _P])


def get_lib():
    """Build (once per source hash) and load the forward kernel's launch
    function."""
    return _KERNEL.get()


def get_bwd_lib():
    """Build and load the backward kernels' launch function."""
    return _BWD_KERNEL.get()


def _check(table, idx):
    if table.dim() != 2 or table.shape[0] == 0 or table.shape[1] % 4:
        raise ValueError(f"table must be (Tr > 0, C % 4 == 0), got {tuple(table.shape)}")
    if table.dtype != torch.float32:
        raise TypeError(f"table must be float32, got {table.dtype}")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise TypeError(f"idx must be a (B,) int32 tensor, got {tuple(idx.shape)} {idx.dtype}")
    if idx.device != table.device:
        raise ValueError(f"idx is on {idx.device}, table on {table.device}")


def packed_gather_plain(table, idx):
    """Plain PyTorch version: rows of `table` at the clamped indices."""
    _check(table, idx)
    return table[torch.clamp(idx, 0, table.shape[0] - 1).long()]


def _gather(table, idx):
    """The forward: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if idx.device.type == "cpu":
        return packed_gather_plain(table, idx)
    if idx.device.type != "cuda":
        raise ValueError(f"packed_gather runs on cuda or cpu tensors, not {idx.device}")
    _check(table, idx)
    table, idx = table.contiguous(), idx.contiguous()
    if table.data_ptr() % 16:
        table = table.clone()  # the kernel moves float4s
    out = torch.empty(idx.shape[0], table.shape[1], dtype=torch.float32, device=idx.device)
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream().cuda_stream
    _KERNEL.launch(table.data_ptr(), table.shape[0], table.shape[1], idx.data_ptr(),
                   idx.shape[0], out.data_ptr(), stream)
    launches.add("gather")
    return out


class _PackedGather(torch.autograd.Function):
    """out = table[clamp(idx)]; the table's cotangent is the row sum of
    the output's (`packed_gather_bwd`), idx gets none."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return _gather(table, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return packed_gather_bwd(g, idx, ctx.n_rows), None


def packed_gather(table, idx):
    """out[b] = table[clamp(idx[b], 0, Tr - 1)]: (Tr, C) float32 x (B,)
    int32 -> (B, C) float32, differentiable in `table`. CUDA tensors go to
    the kernels, CPU tensors to the plain versions."""
    return _PackedGather.apply(table, idx)


class _GatherRows(torch.autograd.Function):
    """table[idx] for a (T, ...) table and indices in range; the table's
    cotangent is summed by `packed_gather_bwd`, a row of C = prod(...)
    columns (a 1-D table, a volume's grid, is a (T, 1) one)."""

    @staticmethod
    def forward(ctx, table, idx):
        # the flat int32 rows the backward reads, kept instead of idx: half
        # the bytes of an int64 index (a volume's grid lookups save 2^27 of them)
        ctx.save_for_backward(idx.reshape(-1).to(torch.int32))
        ctx.shape = table.shape
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (rows,) = ctx.saved_tensors
        shape = ctx.shape
        g = g.reshape(rows.numel(), math.prod(shape[1:])).contiguous()
        return packed_gather_bwd(g, rows, shape[0]).reshape(shape), None


def gather_rows(table, idx):
    """table[idx] for an integer tensor `idx` of valid rows, differentiable
    in `table` with the deterministic row sum as its backward; plain
    indexing for a Python int or when no graph is recorded."""
    if not (isinstance(idx, torch.Tensor) and torch.is_grad_enabled() and table.requires_grad):
        return table[idx]
    return _GatherRows.apply(table, idx)


def _check_bwd(g, idx, n_rows):
    if g.dim() != 2 or g.dtype != torch.float32:
        raise TypeError(f"g must be a (B, C) float32 tensor, got {tuple(g.shape)} {g.dtype}")
    if idx.dim() != 1 or idx.shape[0] != g.shape[0] or idx.dtype != torch.int32:
        raise TypeError(f"idx must be a ({g.shape[0]},) int32 tensor, got "
                        f"{tuple(idx.shape)} {idx.dtype}")
    if idx.device != g.device:
        raise ValueError(f"idx is on {idx.device}, g on {g.device}")
    if n_rows <= 0:
        raise ValueError(f"n_rows must be positive, got {n_rows}")


def packed_gather_bwd_plain(g, idx, n_rows: int):
    """Plain PyTorch version of the backward: the (n_rows, C) sums of g's
    rows by clamped index, accumulated in float64 and rounded to float32."""
    _check_bwd(g, idx, n_rows)
    rows = torch.clamp(idx, 0, n_rows - 1).long()
    out = torch.zeros(n_rows, g.shape[1], dtype=torch.float64, device=g.device)
    return out.index_add_(0, rows, g.double()).float()


def bwd_range_tiles(n_tiles: int) -> int:
    """Tiles a range of the backward's range kernel: ceil(n_tiles /
    BWD_MAX_RANGES) within [32, BWD_MAX_RANGE_TILES] (`range_tiles` in the
    .cu)."""
    return min(max(32, -(-n_tiles // BWD_MAX_RANGES)), BWD_MAX_RANGE_TILES)


def bwd_word_masks(n_rows: int, cols: int) -> bool:
    """The range stage's rule (`word_masks` in the .cu): per-32-row-word
    masks and the word kernel while a tile's masks (8 bytes a word) take at
    most a quarter of its span of g (256 lanes x C x 4 bytes), so they never
    outgrow the input; row lists and the band kernel otherwise."""
    return -(-n_rows // 32) <= BWD_MASK_WORDS_PER_COL * cols


def bwd_bands(n_tiles: int, n_rows: int, cols: int) -> tuple[int, int]:
    """(bands, rows a band) of the backward's range kernel, one CTA a (band,
    range) (`bands` in the .cu): the fewest bands whose rows' accumulators
    and hit bytes fit BWD_BAND_WORDS words of shared memory, raised towards
    BWD_FILL_CTAS CTAs over the ranges while a band keeps
    BWD_MIN_BAND_ROWS rows; then the rows evened out over the bands."""
    n_ranges = -(-n_tiles // bwd_range_tiles(n_tiles))
    most = 4 * BWD_BAND_WORDS // (4 * cols + 1)
    fill = min(-(-BWD_FILL_CTAS // max(n_ranges, 1)), -(-n_rows // BWD_MIN_BAND_ROWS))
    rows = -(-n_rows // max(-(-n_rows // most), fill))
    return -(-n_rows // rows), rows


def _fold(terms):
    """The left fold t0 + t1 + ... in float32, from the first term."""
    acc = None
    for t in terms:
        acc = t if acc is None else acc + t
    return acc


def packed_gather_bwd_emulated(g, idx, n_rows: int):
    """The backward kernels' float32 additions, in their order, in plain
    PyTorch (Python loops: small inputs only). Every sum is a left fold from
    its first term:
      1. the lanes are cut into tiles of BWD_TILE; a tile's lanes
         are ordered by (clamped row, lane) and that order is cut into blocks
         of 32 positions; a row's lanes within a block are folded in order,
         and its blocks' sums in block order: the tile partial;
      2. the tiles are cut into ranges of `bwd_range_tiles(n_tiles)`; a row's
         tile partials are folded in tile order within a range, and its
         range sums in range order;
      3. a row no lane hit is 0.
    On the same inputs the kernels give these sums bit for bit."""
    _check_bwd(g, idx, n_rows)
    n, C = g.shape
    T = BWD_TILE
    rows = torch.clamp(idx, 0, n_rows - 1).tolist()
    tiles = {}                                    # row -> [(tile, partial)]
    for t0 in range(0, n, T):
        order = sorted(range(t0, min(t0 + T, n)), key=lambda b: (rows[b], b))
        pieces = {}                               # row -> [block sums]
        for k in range(0, len(order), 32):
            blk = order[k:k + 32]
            for row in dict.fromkeys(rows[b] for b in blk):
                pieces.setdefault(row, []).append(_fold(g[b] for b in blk if rows[b] == row))
        for row, ps in pieces.items():
            tiles.setdefault(row, []).append((t0 // T, _fold(ps)))
    grad = torch.zeros(n_rows, C, dtype=torch.float32, device=g.device)
    span = bwd_range_tiles(-(-n // T))
    for row, tp in tiles.items():
        grad[row] = _fold(_fold(p for t, p in tp if t // span == j)
                          for j in dict.fromkeys(t // span for t, _ in tp))
    return grad


def bwd_scratch_floats(cols: int, n: int, n_rows: int) -> int:
    """Float32 words of scratch the backward kernels take
    (`shade_gather_bwd_scratch` in the .cu): the tile partials (a slot per
    tile and row it holds, at most min(T, n_rows) a tile), the tiles'
    records (by `bwd_word_masks`: two words per tile and 32 rows, at most a
    quarter of g's; else a row list, an int a slot, and a row count), the
    range partials and each row's mask of ranges (a word per 32 ranges),
    each rounded up to 16 bytes. No term grows with tiles x rows past g."""
    T = BWD_TILE
    n_tiles, cap = -(-n // T), min(T, n_rows)
    n_ranges = -(-n_tiles // bwd_range_tiles(n_tiles))
    r4 = lambda x: (x + 3) & ~3  # noqa: E731
    record = (r4(2 * n_tiles * -(-n_rows // 32)) if bwd_word_masks(n_rows, cols)
              else r4(n_tiles * cap) + r4(n_tiles))
    return (r4(n_tiles * cap * cols) + record + r4(n_ranges * n_rows * cols)
            + r4(-(-n_ranges // 32) * n_rows))


def bwd_launch_args(g, idx, n_rows: int):
    """The backward kernels' arguments for CUDA tensors: g (16-byte
    aligned), the indices (clamped in the kernel), the output and the
    scratch. Returns (args, grad)."""
    _check_bwd(g, idx, n_rows)
    n, C = g.shape
    if not 1 <= C <= MAX_BWD_COLS:
        raise ValueError(f"the backward kernel takes 1 <= C <= {MAX_BWD_COLS}, got {C}")
    if n_rows * BWD_TILE >= 1 << 32:
        raise ValueError(f"the backward kernel takes n_rows < {(1 << 32) // BWD_TILE}, "
                         f"got {n_rows}")
    if g.device.index != torch.cuda.current_device():
        raise ValueError(f"g is on {g.device}, the current device is cuda:"
                         f"{torch.cuda.current_device()}: the kernels launch on the current one")
    g, idx = g.contiguous(), idx.contiguous()
    if g.data_ptr() % 16:
        g = g.clone()  # the tile kernel's bulk copy moves 16-byte units
    grad = torch.empty(n_rows, C, dtype=torch.float32, device=g.device)
    size = bwd_scratch_floats(C, n, n_rows)
    scratch = torch.empty(max(size, 1), dtype=torch.float32, device=g.device)
    stream = torch.cuda.current_stream().cuda_stream
    args = (g.data_ptr(), C, idx.data_ptr(), n, n_rows, grad.data_ptr(), scratch.data_ptr(),
            size, stream)
    # the tensors behind the pointers live as long as the arguments do
    return (args, (g, idx, scratch)), grad


def bwd_launch(prepared) -> None:
    """Enqueue the backward kernels on prepared arguments."""
    args = prepared[0]
    _BWD_KERNEL.launch(*args)
    if args[3] > 0:  # no lanes: only the final kernel runs, writing zeros
        launches.add("gather_bwd_tile")
        launches.add("gather_bwd_range")
    launches.add("gather_bwd_final")


def packed_gather_bwd(g, idx, n_rows: int):
    """grad[r] = the sum of g[b] over the lanes b with clamp(idx[b], 0,
    n_rows - 1) = r: (B, C) float32 x (B,) int32 -> (n_rows, C) float32.
    CUDA tensors go to the deterministic kernels (C <= 64), CPU tensors to
    the plain version. Runs inside the span `ctl.gather_bwd` and counts
    its size: `gather_bwd.calls`, `.lanes` (B), `.values` (B C), `.rows`."""
    with span("ctl.gather_bwd"):
        count("gather_bwd.calls")
        count("gather_bwd.lanes", g.shape[0])
        count("gather_bwd.values", g.numel())
        count("gather_bwd.rows", n_rows)
        if g.device.type == "cpu":
            return packed_gather_bwd_plain(g, idx, n_rows)
        if g.device.type != "cuda":
            raise ValueError(f"packed_gather_bwd runs on cuda or cpu tensors, not {g.device}")
        prepared, grad = bwd_launch_args(g, idx, n_rows)
        bwd_launch(prepared)
        return grad
