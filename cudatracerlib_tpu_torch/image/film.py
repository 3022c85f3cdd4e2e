"""Film: sample accumulation and splatting (port of
cudatracerlib_tpu/image/film.py:16-44, 80-101).

`add_samples`, the scatter film of the photon-mapping eye pass, turns the
JAX package's deterministic `.at[].add` into `index_add_`, which on the card
sums with atomics: a pixel's samples may add in another order from run to
run, a float32 rounding difference. The splat path (`splat_sum`: the
light tracer's, BDPT's and VCM's camera splats) sums with the
deterministic segment-sum kernel of ops/shade_gather.py
(`packed_gather_bwd`), so a pinned splat image is the same on every run; on
the CPU it runs that kernel's plain version. The filtered film is not
ported.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.shade_gather import packed_gather_bwd


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


def splat_sum(pixel_id, value, n_px: int):
    """(n_px, 3) sums of the splats `value` (B, 3) by flat pixel index
    `pixel_id` (B,), which the caller has clipped into [0, n_px): the
    deterministic segment-sum kernel on the card, its plain version (float64
    sums rounded to float32) on the CPU. Zero where no splat lands."""
    return packed_gather_bwd(value.contiguous(), pixel_id.to(torch.int32), n_px)


def develop(film: Film) -> torch.Tensor:
    """Resolve to an (H, W, 3) radiance image."""
    img = film.rgb / torch.clamp(film.weight, min=1e-8)[..., None]
    return img + film.splat / torch.clamp(film.n_passes, min=1.0)
