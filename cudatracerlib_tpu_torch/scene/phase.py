"""Phase functions of participating media (port of
cudatracerlib_tpu/scene/phase.py:22-79).

The tags ISOTROPIC, HG, RAYLEIGH and KAJIYA_KAY, with the JAX package's
branch-free dispatch: every family is computed for every lane and the
per-lane tag selects. Directions are world-space unit vectors; `wo` points
back along the incoming ray and `wi` is the new direction. `ptype` and `g`
are per-lane tensors (or broadcastable scalars). HG is sampled exactly; the
other tags sample isotropically and weight by phase / pdf. Nothing here
stops a gradient (the JAX module has no `stop_gradient`).
"""
from __future__ import annotations

import torch

from ..math.frame import Frame
from ..math.vecmath import INV_FOURPI, PI, dot, normalize, safe_sqrt
from ..sampling.records import PhaseSample

ISOTROPIC = 0
HG = 1
RAYLEIGH = 2
KAJIYA_KAY = 3


def _hg(g, cos_t):
    g2 = g * g
    denom = 1.0 + g2 - 2.0 * g * cos_t
    return INV_FOURPI * (1.0 - g2) / torch.clamp(denom * safe_sqrt(denom), min=1e-8)


def eval_phase(ptype, g, wo, wi):
    """Phase function value p(wo -> wi), normalised over the sphere."""
    cos_t = dot(-wo, wi)  # the angle between the propagation directions
    iso = torch.full(cos_t.shape, INV_FOURPI, device=cos_t.device)
    hg = _hg(g, cos_t)
    ray = (3.0 / (16.0 * PI)) * (1.0 + cos_t * cos_t)
    # Kajiya-Kay: the normalised sin-based diffuse term of the reference
    kk = safe_sqrt(1.0 - cos_t * cos_t) * (3.0 / (8.0 * PI))
    out = torch.where(ptype == HG, hg, iso)
    out = torch.where(ptype == RAYLEIGH, ray, out)
    return torch.where(ptype == KAJIYA_KAY, kk, out)


def pdf_phase(ptype, g, wo, wi):
    """Sampling pdf: HG's own for HG lanes, isotropic for the others."""
    cos_t = dot(-wo, wi)
    return torch.where(ptype == HG, _hg(g, cos_t),
                       torch.full(cos_t.shape, INV_FOURPI, device=cos_t.device))


def sample_phase(ptype, g, wo, u2) -> PhaseSample:
    """Sample a new direction from u2 (..., 2); weight = p / pdf (1 for HG)."""
    safe_g = torch.where(g.abs() < 1e-3, 1e-3, g)
    sqr_term = (1.0 - safe_g * safe_g) / (1.0 + safe_g * (2.0 * u2[..., 0] - 1.0))
    cos_hg = (1.0 + safe_g * safe_g - sqr_term * sqr_term) / (2.0 * safe_g)
    cos_iso = 1.0 - 2.0 * u2[..., 0]
    use_hg = (ptype == HG) & (g.abs() >= 1e-3)
    cos_t = torch.where(use_hg, torch.clamp(cos_hg, -1.0, 1.0), cos_iso)
    sin_t = safe_sqrt(1.0 - cos_t * cos_t)
    phi = 2.0 * PI * u2[..., 1]
    frame = Frame.from_normal(normalize(-wo))
    wi = frame.to_world(torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], -1))
    p = eval_phase(ptype, g, wo, wi)
    pdf = pdf_phase(ptype, g, wo, wi)
    return PhaseSample(wi=wi, weight=p / torch.clamp(pdf, min=1e-12), pdf=pdf)
