"""Density-estimation kernels for (progressive) photon mapping (port of
cudatracerlib_tpu/math/kernels.py; reference Math/Kernel.h:40-279).

Each kernel k(t) is a profile on t = d/r in [0, 1] with a dimension-dependent
normalization c_d such that k(d/r) * c_d / r^d integrates to 1 over the
d-ball. The profiles are copied as the JAX package writes them, PERLIN's
`* 0.0` term included.
"""
from __future__ import annotations

import numpy as np
import torch

from .vecmath import PI

UNIFORM = 0
EPANECHNIKOV = 1
TENT = 2
QUARTIC = 3
TRIWEIGHT = 4
TRICUBE = 5
GAUSSIAN = 6
COSINE = 7
SILVERMAN = 8
PERLIN = 9

_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def eval_kernel(kind, t):
    """Unnormalized kernel profile at t = distance / radius, clipped to
    [0, 1]. `kind` is an int or a per-lane integer tensor; an unknown kind
    gives UNIFORM."""
    t = torch.clamp(t, 0.0, 1.0)
    t2 = t * t
    one_m = torch.clamp(1.0 - t2, min=0.0)
    profiles = [
        torch.ones_like(t),                                 # UNIFORM
        one_m,                                              # EPANECHNIKOV
        1.0 - t,                                            # TENT
        one_m * one_m,                                      # QUARTIC
        one_m * one_m * one_m,                              # TRIWEIGHT
        (1.0 - t * t2) ** 3,                                # TRICUBE
        torch.exp(-0.5 * t2 * 9.0),                         # GAUSSIAN (3-sigma support)
        torch.cos(0.5 * PI * t),                            # COSINE
        one_m * one_m,                                      # SILVERMAN (quartic profile)
        1.0 + t2 * t * (2.0 * t2 * t - 3.0 * t2 * 0.0) - 3.0 * t2 + 2.0 * t2 * t,  # PERLIN smoothstep-ish
    ]
    out = profiles[0]
    for i, p in enumerate(profiles[1:], start=1):
        cond = kind == i
        if not isinstance(cond, torch.Tensor):
            cond = torch.tensor(cond, device=t.device)
        out = torch.where(cond, p, out)
    return out


def normalization(kind, d: int) -> float:
    """1 / the integral of the profile over the unit d-ball (d in 1-3): the
    profile in float32 at 4,097 points, the trapezoid rule in float64."""
    t = np.linspace(0.0, 1.0, 4097)
    dev = kind.device if isinstance(kind, torch.Tensor) else "cpu"
    prof = eval_kernel(kind, torch.as_tensor(t, dtype=torch.float32, device=dev)).cpu().numpy()
    if d == 1:
        integral = 2.0 * _trapezoid(prof, t)
    elif d == 2:
        integral = 2.0 * np.pi * _trapezoid(prof * t, t)
    else:
        integral = 4.0 * np.pi * _trapezoid(prof * t * t, t)
    return 1.0 / max(integral, 1e-12)


def density_weight(kind, dist, radius, d: int, norm=None):
    """k(dist / radius) * c_d / radius^d, the photon-gather weight; 0
    beyond the radius. `radius` is a number or a tensor."""
    if norm is None:
        norm = normalization(kind, d)
    r = torch.clamp(torch.as_tensor(radius, dtype=torch.float32, device=dist.device), min=1e-12)
    t = dist / r
    w = eval_kernel(kind, t) * norm / r ** d
    return torch.where(t <= 1.0, w, 0.0)
