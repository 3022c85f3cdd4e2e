"""Photon-major density estimate: the photon tiles, the CUDA kernel and its
plain version.

Port of the Pallas TPU kernel cudatracerlib_tpu/ops/photon_gather.py:164
(`photon_density_tpu`) and of its host preparation `build_photon_tiles`
(:213). For each gather query it returns [sum w * flux_rgb, sum w] with
w = max(1 - d^2/r^2, 0) * [n_q . n_p > 0.7] * [n_q . wi_p >= 0]; the caller
applies the Epanechnikov normalization 2/(pi r^2) and albedo/pi. The kernel
lives in csrc/photon_gather.cu (its header note says what bounds it on the
H100 and what the design does about it).

Layouts are the JAX package's: tiles (n_tiles, 16, 512) float32 of
attribute rows [x y z |p|^2 r g b nx ny nz wix wiy wiz 0 0 0] with photons
cell-sorted and padded to FAR, and aabbs (n_tiles, 8) = [lo, hi, 0, 0], so
one set of tiles feeds both packages.

`photon_density` is the wrapper: CUDA tensors launch the kernel, CPU tensors
run `photon_density_plain`; it never falls back from one to the other. The
plain version has the same contract and the same per-block tile cull, and
sweeps (query block, surviving tile) pairs in chunks. Both compute each
pair's weight with the same float32 operations in the same order; they sum
in another order, a relative difference of about 1e-5 on the sums. The
kernel also skips, per warp of 32 queries, the 32-photon chunks none of
whose photons lies within r of the warp's box; `warp_chunk_cull` is that
cull in plain PyTorch (it drops only pairs whose weight is exactly 0).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .._build_util import CudaKernel
from ..utils.timing import CounterGroup

BQ = 256       # queries per block (the JAX kernel's; the CUDA kernel's CTA size is its own)
PT = 512       # photons per tile
WARP = 32      # queries per warp of the chunk cull
CHUNK = 32     # photons per chunk of the chunk cull
FAR = 1.0e15   # padding position (FAR^2 stays finite in float32)
NORMAL_MIN_DOT = 0.7

# Each launch adds one here (the counters launches.photon_gather.<kernel>):
# "density" the estimate kernel, "density_reduce" the kernel that adds the
# splits' partial sums (plain-version calls do not).
launches = CounterGroup("launches.photon_gather", ("density", "density_reduce"))

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_KERNEL = CudaKernel("photon_gather", [_P, _I, _P, _P, _P, _P, _I, _F, _F, _P, _P, _P])
_PAIRS_PER_CHUNK = {"cpu": 1 << 22}   # (query, photon) pairs per plain-version chunk
_PAIRS_PER_CHUNK_DEFAULT = 1 << 25


def get_lib():
    """Build (once per source hash) and load the kernel's launch function."""
    return _KERNEL.get()


@functools.cache
def kernel_config() -> tuple[int, int]:
    """(queries per CTA, splits per query block), the kernel's constants."""
    out = (ctypes.c_int * 2)()
    _KERNEL.function("config", [_P])(out)
    return out[0], out[1]


def kernel_info() -> dict:
    """The kernel's build and residency on the current card: registers,
    local (spill) bytes, static and dynamic shared bytes, resident CTAs per
    SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    out = (ctypes.c_int * 5)()
    err = _KERNEL.function("info", [_P])(out)
    if err:
        raise RuntimeError(f"photon_gather info failed: cudaError {err}")
    keys = ("registers", "local_bytes", "static_shared_bytes", "dynamic_shared_bytes",
            "ctas_per_sm")
    return dict(zip(keys, out))


def build_photon_tiles(pos, power, normal, valid, box_min, box_max, res: int, wi):
    """Sort photons by grid cell and pack them into kernel tiles.

    One stable sort by cell id carries every attribute (invalid photons sort
    to the tail). Returns (tiles (n_tiles, 16, PT) float32, aabbs
    (n_tiles, 8) float32). `wi` (P, 3): the photons' incoming directions for
    the front-side test (a zero direction passes it)."""
    P, dev = pos.shape[0], pos.device
    box_min = torch.as_tensor(box_min, dtype=torch.float32, device=dev)
    box_max = torch.as_tensor(box_max, dtype=torch.float32, device=dev)
    inv_cell = res / torch.clamp(box_max - box_min, min=1e-9)
    q = torch.clamp(torch.floor((pos - box_min) * inv_cell).to(torch.int32), 0, res - 1)
    cid = (q[:, 0] * res + q[:, 1]) * res + q[:, 2]
    cid = torch.where(valid, cid, res ** 3)
    order = torch.sort(cid, stable=True)[1]

    sv = valid[order]
    sp, spow, sn, swi = pos[order], power[order], normal[order], wi[order]
    xyz = torch.where(sv[:, None], sp, FAR)
    p2 = (xyz[:, 0] * xyz[:, 0] + xyz[:, 1] * xyz[:, 1]) + xyz[:, 2] * xyz[:, 2]
    flux = torch.where(sv[:, None], spow, 0.0)
    Pp = (P + PT - 1) // PT * PT
    rows = torch.zeros(16, Pp, dtype=torch.float32, device=dev)
    rows[0:3, P:] = FAR
    rows[3, P:] = FAR * FAR
    rows[0:3, :P] = xyz.t()
    rows[3, :P] = p2
    rows[4:7, :P] = flux.t()
    rows[7:10, :P] = sn.t()
    rows[10:13, :P] = swi.t()
    tiles = rows.reshape(16, Pp // PT, PT).transpose(0, 1).contiguous()

    vm = torch.zeros(Pp, dtype=torch.bool, device=dev)
    vm[:P] = sv
    vm = vm.reshape(Pp // PT, 1, PT)
    pos_t = tiles[:, 0:3, :]
    lo = torch.where(vm, pos_t, FAR).amin(2)
    hi = torch.where(vm, pos_t, -FAR).amax(2)
    aabbs = torch.cat([lo, hi, torch.zeros(Pp // PT, 2, device=dev)], dim=1)
    return tiles, aabbs


def _radius2(radius):
    """(r^2, 1/r^2) as float32 host scalars; r^2 >= 1e-20 as in the JAX kernel."""
    r = np.float32(radius)
    r2 = max(r * r, np.float32(1e-20))
    return r2, np.float32(1.0) / r2


def _check(tiles, aabbs, q_pos, q_n, q_valid):
    if tiles.dim() != 3 or tiles.shape[1:] != (16, PT):
        raise ValueError(f"tiles must be (n_tiles, 16, {PT}), got {tuple(tiles.shape)}")
    if aabbs.shape != (tiles.shape[0], 8):
        raise ValueError(f"aabbs must be ({tiles.shape[0]}, 8), got {tuple(aabbs.shape)}")
    if q_pos.dim() != 2 or q_pos.shape[1] != 3 or q_n.shape != q_pos.shape:
        raise ValueError(f"q_pos, q_n must be (B, 3), got {tuple(q_pos.shape)}, {tuple(q_n.shape)}")
    if q_valid.shape != q_pos.shape[:1] or q_valid.dtype != torch.bool:
        raise TypeError(f"q_valid must be a (B,) bool tensor, got {tuple(q_valid.shape)} "
                        f"{q_valid.dtype}")
    for name, x in (("tiles", tiles), ("aabbs", aabbs), ("q_pos", q_pos), ("q_n", q_n)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
    for name, x in (("tiles", tiles), ("aabbs", aabbs), ("q_n", q_n), ("q_valid", q_valid)):
        if x.device != q_pos.device:
            raise ValueError(f"{name} is on {x.device}, q_pos on {q_pos.device}")


def _pad_to_blocks(x):
    """Pad the query dimension (0) with zeros / False to a multiple of BQ."""
    pad = -x.shape[0] % BQ
    return torch.nn.functional.pad(x, (0, 0) * (x.dim() - 1) + (0, pad))


def _query_boxes(q_pos, q_valid, n: int):
    """(lo, hi) (len / n, 3) of the valid queries of each group of n
    (+-FAR where a group has none); len a multiple of n."""
    g = q_pos.shape[0] // n
    lo = torch.where(q_valid[:, None], q_pos, FAR).reshape(g, n, 3).amin(1)
    hi = torch.where(q_valid[:, None], q_pos, -FAR).reshape(g, n, 3).amax(1)
    return lo, hi


def _gap2(lo, hi, blo, bhi):
    """Squared gap between boxes (or points, lo = hi) and boxes, coordinates
    on dim -2, summed as the kernel sums it."""
    g = torch.clamp(torch.maximum(lo - bhi, blo - hi), min=0.0)
    return (g[..., 0, :] * g[..., 0, :] + g[..., 1, :] * g[..., 1, :]) + g[..., 2, :] * g[..., 2, :]


def block_cull(aabbs, q_pos, q_valid, radius):
    """(n_blocks, n_tiles) bool: tile t can hold a photon within `radius` of
    some valid query of block b (blocks of BQ queries in the given order).
    The squared AABB gap is summed as the kernel sums it."""
    q_pos, q_valid = _pad_to_blocks(q_pos), _pad_to_blocks(q_valid)
    r2, _ = _radius2(radius)
    blo, bhi = _query_boxes(q_pos, q_valid, BQ)
    lo, hi = aabbs[None, :, 0:3, None], aabbs[None, :, 3:6, None]
    return _gap2(lo, hi, blo[:, None, :, None], bhi[:, None, :, None])[..., 0] <= float(r2)


def _kept_slices(blocks):
    """The (block, tile) pairs `blocks` keeps, as index slices of about the
    plain version's pairs per chunk each."""
    pb, pt = blocks.nonzero(as_tuple=True)
    step = max(1, _PAIRS_PER_CHUNK.get(blocks.device.type, _PAIRS_PER_CHUNK_DEFAULT) // (BQ * PT))
    for s in range(0, pb.shape[0], step):
        yield pb[s:s + step], pt[s:s + step]


def _warp_chunk_keep(tiles, q_pos, q_valid, radius, blocks):
    """`warp_chunk_cull` on padded queries, given their `block_cull`."""
    r2, _ = _radius2(radius)
    wlo, whi = _query_boxes(q_pos, q_valid, WARP)
    nw, wpb = wlo.shape[0], BQ // WARP
    keep = torch.zeros(nw, tiles.shape[0], PT // CHUNK, dtype=torch.bool, device=q_pos.device)
    lanes = torch.arange(wpb, device=q_pos.device)
    for b, t in _kept_slices(blocks):
        w = b[:, None] * wpb + lanes                            # (K, wpb)
        p = tiles[t, 0:3, None, :].transpose(1, 2)              # (K, 1, 3, PT)
        near = _gap2(p, p, wlo[w][..., None], whi[w][..., None]) <= float(r2)
        keep[w, t[:, None]] = near.reshape(*w.shape, PT // CHUNK, CHUNK).any(-1)
    per_warp = q_valid.reshape(nw, WARP).sum(1)
    return keep, int((keep.sum((1, 2)) * per_warp).sum()) * CHUNK


def warp_chunk_cull(tiles, aabbs, q_pos, q_valid, radius):
    """The kernel's cull in plain PyTorch. Returns (keep, pairs): keep
    (n_warps, n_tiles, PT // CHUNK) bool is True where the block of BQ
    queries holding warp w keeps tile t (`block_cull`) and some photon of
    chunk c lies within `radius` of the box of warp w's valid queries
    (squared gap summed as the kernel sums it; a warp with no valid query
    keeps nothing); pairs is the (valid query, photon) pairs the kernel
    weighs, valid queries of the warp x CHUNK for each kept chunk. Every
    pair of a dropped chunk has a plain weight of exactly +0."""
    q_pos, q_valid = _pad_to_blocks(q_pos), _pad_to_blocks(q_valid)
    blocks = block_cull(aabbs, q_pos, q_valid, radius)
    return _warp_chunk_keep(tiles, q_pos, q_valid, radius, blocks)


def _block_tile_pairs(blocks, q_valid) -> int:
    """`surviving_pairs` given the block cull `blocks`."""
    per_block = _pad_to_blocks(q_valid).reshape(-1, BQ).sum(1)
    return int((per_block * blocks.sum(1)).sum()) * PT


def surviving_pairs(aabbs, q_pos, q_valid, radius) -> int:
    """(valid query, photon slot) pairs of the block x tile cull: for each
    block of BQ, its valid queries times PT times its surviving tiles (a
    sweep of every photon of each kept tile)."""
    return _block_tile_pairs(block_cull(aabbs, q_pos, q_valid, radius), q_valid)


def cull_counts(tiles, aabbs, q_pos, q_n, q_valid, radius) -> dict:
    """(valid query, photon) pairs kept by each cull basis, for the bound:
    `block_tile` (blocks of BQ x tiles, `surviving_pairs`), `warp_chunk`
    (the kernel's, `warp_chunk_cull`), `within_r` (d^2 <= r^2) and
    `positive` (w > 0), the last two over the block-kept tiles, which hold
    every such pair; and `tiles_per_block`, the block cull's survivors
    (n_blocks,) int64. One block cull serves all of them."""
    qp, qn, qv = (_pad_to_blocks(x) for x in (q_pos, q_n, q_valid))
    blocks = block_cull(aabbs, qp, qv, radius)
    _, warp_chunk = _warp_chunk_keep(tiles, qp, qv, radius, blocks)
    nb = qp.shape[0] // BQ
    qp3, qn3, qv3 = qp.reshape(nb, BQ, 3, 1), qn.reshape(nb, BQ, 3, 1), qv.reshape(nb, BQ, 1)
    r2, inv_r2 = _radius2(radius)
    within = positive = 0
    for b, t in _kept_slices(blocks):
        ph, q, v = tiles[t][:, None], qp3[b], qv3[b]
        dx, dy, dz = (ph[..., c, :] - q[..., c, :] for c in range(3))
        within += int((((dx * dx + dy * dy) + dz * dz <= float(r2)) & v).sum())
        positive += int(((pair_weights(ph, q, qn3[b], inv_r2) > 0) & v).sum())
    return dict(block_tile=_block_tile_pairs(blocks, q_valid), warp_chunk=warp_chunk,
                within_r=within, positive=positive, tiles_per_block=blocks.sum(1))


def pair_weights(ph, q, n, inv_r2):
    """Plain weights w of (query, photon) pairs, in the kernel's float32
    operations and order: ph (..., 16, P) photon rows, q and n (..., 3, 1)
    query positions and normals, broadcasting to (..., P)."""
    dx, dy, dz = (ph[..., c, :] - q[..., c, :] for c in range(3))
    d2 = (dx * dx + dy * dy) + dz * dz
    w = torch.clamp(1.0 - d2 * float(inv_r2), min=0.0)
    ndot = (n[..., 0, :] * ph[..., 7, :] + n[..., 1, :] * ph[..., 8, :]) + n[..., 2, :] * ph[..., 9, :]
    wdot = ((n[..., 0, :] * ph[..., 10, :] + n[..., 1, :] * ph[..., 11, :])
            + n[..., 2, :] * ph[..., 12, :])
    return torch.where((ndot > NORMAL_MIN_DOT) & (wdot >= 0.0), w, 0.0)


def photon_density_plain(tiles, aabbs, q_pos, q_n, q_valid, radius):
    """Plain PyTorch version of the kernel's contract: per query
    (flux (B, 3), sum_w (B,)); 0 for invalid queries."""
    _check(tiles, aabbs, q_pos, q_n, q_valid)
    B, dev = q_pos.shape[0], q_pos.device
    r2, inv_r2 = _radius2(radius)
    keep = block_cull(aabbs, q_pos, q_valid, radius)
    qp, qn, qv = (_pad_to_blocks(x) for x in (q_pos, q_n, q_valid))
    nb = qp.shape[0] // BQ
    qp, qn = qp.reshape(nb, BQ, 3), qn.reshape(nb, BQ, 3)
    out = torch.zeros(nb, BQ, 4, device=dev)
    for b, t in _kept_slices(keep):
        ph = tiles[t][:, None]                                  # (K, 1, 16, PT)
        w = pair_weights(ph, qp[b][..., None], qn[b][..., None], inv_r2)
        sums = torch.stack([(w * ph[:, :, 4]).sum(-1), (w * ph[:, :, 5]).sum(-1),
                            (w * ph[:, :, 6]).sum(-1), w.sum(-1)], dim=-1)
        out.index_add_(0, b, sums)
    out = torch.where(qv[:, None], out.reshape(-1, 4), 0.0)[:B]
    return out[:, 0:3], out[:, 3]


def launch_args(tiles, aabbs, q_pos, q_n, q_valid, radius):
    """(arguments of one kernel launch, its outputs (B, 4)) for CUDA tensors:
    what `photon_density` launches, also for timing the kernel alone. The
    splits' partial sums go to a scratch (splits, B, 4) made here."""
    _check(tiles, aabbs, q_pos, q_n, q_valid)
    B, dev = q_pos.shape[0], q_pos.device
    with torch.cuda.device(dev):
        _, splits = kernel_config()
        stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty(B, 4, dtype=torch.float32, device=dev)
    part = torch.empty(splits, B, 4, dtype=torch.float32, device=dev)
    tiles, aabbs = tiles.contiguous(), aabbs.contiguous()
    if tiles.data_ptr() % 16:
        tiles = tiles.clone()  # the kernel stages tiles with 16-byte aligned TMA copies
    q_pos, q_n = q_pos.contiguous(), q_n.contiguous()
    q_valid = q_valid.contiguous().view(torch.uint8)
    r2, inv_r2 = _radius2(radius)
    args = (tiles.data_ptr(), tiles.shape[0], aabbs.data_ptr(), q_pos.data_ptr(),
            q_n.data_ptr(), q_valid.data_ptr(), B, float(r2), float(inv_r2),
            part.data_ptr(), out.data_ptr(), stream)
    keep = (tiles, aabbs, q_pos, q_n, q_valid, part, out)  # outlive the launch
    return (args, keep, dev), out


def launch(prepared) -> None:
    """Launch the kernel and the reduction of its splits with
    `launch_args`' arguments (not counted)."""
    args, _, device = prepared
    with torch.cuda.device(device):
        _KERNEL.launch(*args)


def photon_density(tiles, aabbs, q_pos, q_n, q_valid, radius):
    """Per query (sum w * flux_rgb (B, 3), sum w (B,)) over the tiled
    photons; `radius` a host scalar. CUDA tensors go to the kernel, CPU
    tensors to the plain version."""
    if q_pos.device.type == "cpu":
        return photon_density_plain(tiles, aabbs, q_pos, q_n, q_valid, radius)
    if q_pos.device.type != "cuda":
        raise ValueError(f"photon_density runs on cuda or cpu tensors, not {q_pos.device}")
    prepared, out = launch_args(tiles, aabbs, q_pos, q_n, q_valid, radius)
    if q_pos.shape[0] > 0:
        launch(prepared)
        launches.add("density")
        launches.add("density_reduce")
    return out[:, 0:3], out[:, 3]
