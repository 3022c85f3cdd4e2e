"""Film: sample accumulation and splatting (port of
cudatracerlib_tpu/image/film.py:16-44, 80-101).

`add_samples`, the scatter film of the photon-mapping eye pass, turns the
JAX package's deterministic `.at[].add` into `index_add_`, which on the card
sums with atomics: a pixel's samples may add in another order from run to
run, a float32 rounding difference. The splat path (`splat_sum`: the
light tracer's, BDPT's and VCM's camera splats) sums with the
deterministic segment-sum kernel of ops/shade_gather.py
(`packed_gather_bwd`), so a pinned splat image is the same on every run; on
the CPU it runs that kernel's plain version. The filtered film
(`add_samples_filtered`, filter-importance splatting of the path tracer's
samples) sums its taps with the same kernel; it is differentiable, its
backward a plain gather of the cotangent.

That kernel's scratch grows with lanes x rows (its row masks, two words
per tile of 256 lanes and 32 rows, and its range partials,
`bwd_scratch_floats`), so the filtered film cuts its samples into runs
whose call stays within SPLAT_SCRATCH_FLOATS and gives each call only the
image rows its run's taps reach (`splat_runs`; the path tracer's samples
lie in 32x32 screen tiles, so a run covers a band of rows). The runs' sums
are added in run order, so the film stays deterministic; a pass whose taps
fit at once (256x256 at 16 spp with a 3x3 support: one call of 0.79 GB) is
summed in one call, 1024x1024 at 16 spp in 64.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.shade_gather import bwd_scratch_floats, packed_gather_bwd
from .pipeline import filter_eval_1d


class Film(NamedTuple):
    rgb: torch.Tensor       # (H, W, 3) weighted sample accumulator
    weight: torch.Tensor    # (H, W) filter weight accumulator
    splat: torch.Tensor     # (H, W, 3) light-tracing splat accumulator
    n_passes: torch.Tensor  # () float, splat normalization

    @staticmethod
    def create(height: int, width: int, device="cuda") -> "Film":
        return Film(
            rgb=torch.zeros(height, width, 3, device=device),
            weight=torch.zeros(height, width, device=device),
            splat=torch.zeros(height, width, 3, device=device),
            n_passes=torch.zeros((), device=device),
        )


def add_samples(film: Film, pixel_id, value) -> Film:
    """Accumulate eye-path samples of weight 1: pixel_id (B,) flat indices,
    value (B, 3); non-finite values count as 0 (reference Image::AddSample)."""
    H, W = film.weight.shape
    value = torch.nan_to_num(value, nan=0.0, posinf=0.0, neginf=0.0)
    pid = pixel_id.long()
    rgb = film.rgb.reshape(-1, 3).index_add(0, pid, value)
    w = film.weight.reshape(-1).index_add(0, pid, torch.ones(value.shape[:-1], device=value.device))
    return film._replace(rgb=rgb.reshape(H, W, 3), weight=w.reshape(H, W))


class _SplatSum(torch.autograd.Function):
    """The segment sum with a gather of the cotangent as its backward."""

    @staticmethod
    def forward(ctx, value, pixel_id, n_px):
        ctx.save_for_backward(pixel_id)
        return packed_gather_bwd(value.contiguous(), pixel_id, n_px)

    @staticmethod
    def backward(ctx, g):
        (pixel_id,) = ctx.saved_tensors
        return g[pixel_id.long()], None, None


def splat_sum(pixel_id, value, n_px: int):
    """(n_px, C) sums of the splats `value` (B, C) by flat pixel index
    `pixel_id` (B,), which the caller has clipped into [0, n_px): the
    deterministic segment-sum kernel on the card, its plain version (float64
    sums rounded to float32) on the CPU. Zero where no splat lands.
    Differentiable in `value`: a splat's gradient is its pixel's."""
    return _SplatSum.apply(value, pixel_id.to(torch.int32), n_px)


def filter_taps(sx, sy, value, ftype: int, radius: float, support: int, height: int,
                width: int, rows: tuple[int, int] | None = None):
    """The filtered film's taps: for each sample and each pixel of the
    (2 support + 1)^2 around the one it falls in, the pixel id and the row
    (value * w, w), w the filter's weight there. Ids count from the first
    pixel of image row `rows[0]`, and a tap outside the image goes to the
    dropped id just past image row `rows[1]` (default: the whole image, the
    dropped id height * width); the caller's rows take in every tap inside
    the image. Returns (pixel_id (K B,) int32, rows (K B, 4)), taps in
    row-major order of (dy, dx)."""
    y0, y1 = (0, height - 1) if rows is None else rows
    dropped = (y1 + 1 - y0) * width
    ix = torch.floor(sx).to(torch.int32)
    iy = torch.floor(sy).to(torch.int32)
    pids, taps = [], []
    for dy in range(-support, support + 1):
        qy = iy + dy
        wy = filter_eval_1d(ftype, (qy.to(torch.float32) + 0.5) - sy, radius)
        for dx in range(-support, support + 1):
            qx = ix + dx
            wx = filter_eval_1d(ftype, (qx.to(torch.float32) + 0.5) - sx, radius)
            w = wx * wy
            inside = (qx >= 0) & (qx < width) & (qy >= 0) & (qy < height)
            pids.append(torch.where(inside, (qy - y0) * width + qx, dropped))
            taps.append(torch.cat([value * w[:, None], w[:, None]], dim=-1))
    return torch.cat(pids).to(torch.int32), torch.cat(taps)


# the most scratch one call of the filtered film's segment sum may take
# (float32 words: 1 GiB)
SPLAT_SCRATCH_FLOATS = 1 << 28


def splat_runs(sy, n_taps: int, support: int, height: int, width: int):
    """Runs (b0, b1, y0, y1) of the samples, in sample order, whose n_taps
    taps each one call of the segment sum adds onto image rows y0..y1 (the
    rows the run's taps reach) plus a dropped row within
    SPLAT_SCRATCH_FLOATS of scratch: the whole image first, then a run that
    does not fit is halved and each half's rows read from its samples'
    positions `sy` (one host read a half)."""
    todo = [(0, sy.shape[0], 0, height - 1)]
    while todo:
        b0, b1, y0, y1 = todo.pop()
        if (b1 - b0 == 1 or bwd_scratch_floats(4, n_taps * (b1 - b0), (y1 + 1 - y0) * width + 1)
                <= SPLAT_SCRATCH_FLOATS):
            yield b0, b1, y0, y1
            continue
        mid = (b0 + b1) // 2
        for h0, h1 in ((mid, b1), (b0, mid)):   # the first half runs first
            lo, hi = torch.stack(torch.aminmax(torch.floor(sy[h0:h1]))).tolist()
            todo.append((h0, h1, max(0, int(lo) - support), min(height - 1, int(hi) + support)))


def add_samples_filtered(film: Film, sx, sy, value, ftype: int, radius: float = 1.5,
                         support: int = 1) -> Film:
    """Filter-importance splatting: each camera sample adds value * w and w
    to every pixel of its filter support, w = filter(dx) filter(dy) at the
    pixel centre's offset (reference CanonicalFilter), so the developed
    image rgb / weight is the filtered estimate. sx, sy: (B,) sample
    positions in pixels (centres at integer + 0.5); value (B, 3), non-finite
    counted as 0; taps reach [-support, support] around the sample's pixel
    and out-of-image taps are dropped. The samples go in `splat_runs`,
    each run's taps in one deterministic segment sum (`splat_sum`) onto the
    image rows they reach plus a dropped row, the runs' sums added in
    order."""
    H, W = film.weight.shape
    value = torch.nan_to_num(value, nan=0.0, posinf=0.0, neginf=0.0)
    sums = torch.zeros(H * W, 4, device=value.device)
    for b0, b1, y0, y1 in splat_runs(sy, (2 * support + 1) ** 2, support, H, W):
        pid, taps = filter_taps(sx[b0:b1], sy[b0:b1], value[b0:b1], ftype, radius, support, H,
                                W, (y0, y1))
        n = (y1 + 1 - y0) * W
        sums[y0 * W:y0 * W + n] += splat_sum(pid, taps, n + 1)[:n]
    return film._replace(rgb=film.rgb + sums[:, :3].reshape(H, W, 3),
                         weight=film.weight + sums[:, 3].reshape(H, W))


def develop(film: Film) -> torch.Tensor:
    """Resolve to an (H, W, 3) radiance image."""
    img = film.rgb / torch.clamp(film.weight, min=1e-8)[..., None]
    return img + film.splat / torch.clamp(film.n_passes, min=1.0)
