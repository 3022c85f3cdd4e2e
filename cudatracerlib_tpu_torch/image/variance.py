"""Per-pixel variance buffers and adaptive block weights
(port of cudatracerlib_tpu/image/variance.py).

Online per-pixel moments of the luminance estimator (Welford) and the
even/odd half buffers of the reference's PixelVarianceBuffer, and the block
samplers' per-block weights: lambda * (block mean estimator stddev) + (1 -
lambda) * (block colour variance) (VARIANCE), the half-buffer error
(DIFFERENCE), a pixel rectangle (SELECT) or flat (UNIFORM). The weights
drive render/adaptive.py's ray -> pixel assignment.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

BLOCK = 16  # block edge in pixels

UNIFORM = 0
VARIANCE = 1
DIFFERENCE = 2
SELECT = 3


class VarianceBuffer(NamedTuple):
    """Online per-pixel moments of the luminance estimator + half buffers."""

    mean: torch.Tensor     # (H, W) running mean of luminance
    m2: torch.Tensor       # (H, W) running sum of squared deviations (Welford)
    n: torch.Tensor        # (H, W) sample counts
    half_a: torch.Tensor   # (H, W, 3) even-pass accumulator
    half_b: torch.Tensor   # (H, W, 3) odd-pass accumulator
    n_a: torch.Tensor      # ()
    n_b: torch.Tensor      # ()

    @staticmethod
    def create(height: int, width: int, device="cuda") -> "VarianceBuffer":
        """A zeroed buffer on `device` (the card unless the caller asks for
        the CPU)."""
        z = torch.zeros(height, width, device=device)
        z3 = torch.zeros(height, width, 3, device=device)
        zs = torch.zeros((), device=device)
        return VarianceBuffer(z, z, z, z3, z3, zs, zs)


def add_pass(vb: VarianceBuffer, pass_image, pass_idx: int, mask=None) -> VarianceBuffer:
    """Accumulate one pass's per-pixel radiance image (Welford update).
    `mask` (H, W) bool: the pixels that received samples this pass; the
    others keep their moments."""
    lum = (0.212671 * pass_image[..., 0] + 0.715160 * pass_image[..., 1]
           + 0.072169 * pass_image[..., 2])
    if mask is None:
        mask = torch.ones(lum.shape, dtype=torch.bool, device=lum.device)
    n = vb.n + torch.where(mask, 1.0, 0.0)
    delta = torch.where(mask, lum - vb.mean, 0.0)
    mean = vb.mean + delta / torch.clamp(n, min=1.0)
    m2 = vb.m2 + delta * torch.where(mask, lum - mean, 0.0)
    even = int(pass_idx) % 2 == 0
    upd = torch.where(mask[..., None], pass_image, 0.0)
    return VarianceBuffer(
        mean=mean, m2=m2, n=n,
        half_a=vb.half_a + upd if even else vb.half_a,
        half_b=vb.half_b if even else vb.half_b + upd,
        n_a=vb.n_a + (1.0 if even else 0.0),
        n_b=vb.n_b + (0.0 if even else 1.0),
    )


def pixel_variance(vb: VarianceBuffer):
    """Variance of the per-pass estimator (not of the mean)."""
    return vb.m2 / torch.clamp(vb.n - 1.0, min=1.0)


def half_buffer_error(vb: VarianceBuffer):
    """Relative half-buffer error ("Hierarchical Automatic Stopping")."""
    a = vb.half_a / torch.clamp(vb.n_a, min=1.0)
    b = vb.half_b / torch.clamp(vb.n_b, min=1.0)
    num = (a - b).abs().sum(-1)
    den = torch.sqrt(torch.clamp((a + b).sum(-1), min=1e-6))
    return num / den


def _block_reduce(x, block: int = BLOCK):
    H, W = x.shape
    hb, wb = H // block, W // block
    return x[: hb * block, : wb * block].reshape(hb, block, wb, block).mean((1, 3))


def block_weights(vb: VarianceBuffer, mode: int = VARIANCE, lam: float = 0.5,
                  block: int = BLOCK, rect=None):
    """Per-block sampling weights, normalized to mean 1. `rect` = (x0, y0,
    x1, y1): SELECT's pixel rectangle (default: the whole image)."""
    H, W = vb.mean.shape
    dev = vb.mean.device
    if mode == UNIFORM:
        return torch.ones(H // block, W // block, device=dev)
    if mode == SELECT:
        x0, y0, x1, y1 = rect if rect is not None else (0, 0, W, H)
        bx = torch.arange(W // block, device=dev) * block
        by = torch.arange(H // block, device=dev) * block
        inx = (bx + block > x0) & (bx < x1)
        iny = (by + block > y0) & (by < y1)
        w = (iny[:, None] & inx[None, :]).to(torch.float32) + 1e-3
        return w / torch.clamp(w.mean(), min=1e-9)
    if mode == VARIANCE:
        est_std = torch.sqrt(pixel_variance(vb)) / torch.clamp(vb.mean, min=1e-3)
        color_var = pixel_variance(vb)
        w = lam * _block_reduce(est_std, block) + (1 - lam) * _block_reduce(color_var, block)
    else:  # DIFFERENCE
        w = _block_reduce(half_buffer_error(vb), block)
    w = torch.clamp(w, min=1e-6)
    return w / torch.clamp(w.mean(), min=1e-9)


def expand_blocks(w_blocks, block: int = BLOCK):
    """Block values repeated over their pixels: (hb, wb) -> (hb*block, wb*block)."""
    return w_blocks.repeat_interleave(block, 0).repeat_interleave(block, 1)


def per_pixel_spp(vb: VarianceBuffer, base_spp: int, mode: int = VARIANCE,
                  max_factor: float = 4.0, block: int = BLOCK):
    """Block weights expanded to an integer (int32) per-pixel spp map for
    the next pass, each block's weight clipped to [1/max_factor,
    max_factor]."""
    w = torch.clamp(block_weights(vb, mode, block=block), 1.0 / max_factor, max_factor)
    spp = torch.clamp(torch.round(w * base_spp).to(torch.int32), min=1)
    return expand_blocks(spp, block)
