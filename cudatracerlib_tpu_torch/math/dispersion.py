"""Wavelength-dependent index of refraction: Cauchy and Sellmeier (port of
cudatracerlib_tpu/math/dispersion.py; reference SceneTypes/Dispersion.h).
Wavelengths in micrometres; differentiable in the coefficients."""
from __future__ import annotations

import torch

# representative RGB wavelengths (um), the reference's spectral bins
LAMBDA_RGB = (0.62, 0.55, 0.45)

# named Cauchy presets (B, C), lambda in um
CAUCHY_PRESETS = {
    "fused_silica": (1.4580, 0.00354),
    "bk7": (1.5046, 0.00420),
    "k5": (1.5220, 0.00459),
    "baf10": (1.6700, 0.00743),
    "sf10": (1.7280, 0.01342),
}

# Sellmeier coefficients (B1..B3, C1..C3) of BK7
SELLMEIER_BK7 = (
    (1.03961212, 0.231792344, 1.01046945),
    (0.00600069867, 0.0200179144, 103.560653),
)


def cauchy_ior(wavelength_um, B, C):
    """n(lambda) = B + C / lambda^2."""
    lam2 = torch.as_tensor(wavelength_um, dtype=torch.float32) ** 2
    return B + C / lam2


def sellmeier_ior(wavelength_um, Bs, Cs):
    """n^2(lambda) = 1 + sum_i B_i lambda^2 / (lambda^2 - C_i)."""
    lam2 = torch.as_tensor(wavelength_um, dtype=torch.float32) ** 2
    n2 = 1.0
    for b, c in zip(Bs, Cs):
        n2 = n2 + b * lam2 / (lam2 - c)
    return torch.sqrt(n2)


def rgb_ior_cauchy(preset: str = "bk7", device="cuda"):
    """The (3,) per-RGB-channel IOR of a named Cauchy preset."""
    B, C = CAUCHY_PRESETS[preset]
    return torch.stack([cauchy_ior(lam, B, C) for lam in LAMBDA_RGB]).to(device)
