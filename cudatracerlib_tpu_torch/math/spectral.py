"""Spectral machinery: CIE curves, hero-wavelength sampling, RGB <->
spectrum uplift (port of cudatracerlib_tpu/math/spectral.py).

* The CIE 1931 colour-matching functions are the Wyman-Sloan-Shirley
  multi-lobe Gaussian fits (JCGT 2013), closed form and differentiable.
* Each path carries N_WAVES wavelengths: a uniform hero and its rotations
  by j / N_WAVES of the band (Wilkie et al., "Hero Wavelength Spectral
  Sampling", EGSR 2014).
* RGB uplifts onto a 3-band box basis calibrated at import (`_calibration`)
  so that a flat spectrum renders to white exactly and any RGB round-trips
  through one spectral event.

The calibration is the JAX package's, computed the same way: the curves in
float32 at float32 wavelengths, the trapezoid integrals in float64 over the
float64 grid, the results rounded to float32. The (3, 3) products of the
uplift and of the XYZ -> RGB step are explicit multiply-adds, as in
math/spectrum.py.
"""
from __future__ import annotations

import numpy as np
import torch

from .spectrum import _XYZ2RGB, mat3_apply

LAMBDA_MIN = 380.0   # nm, the visible band the CIE fits cover
LAMBDA_MAX = 720.0
LAMBDA_RANGE = LAMBDA_MAX - LAMBDA_MIN
N_WAVES = 4          # spectral samples a path (hero + 3 rotations)

# 3-band box-basis edges for the RGB uplift (nm): blue / green / red
_BAND_EDGES = (LAMBDA_MIN, 490.0, 580.0, LAMBDA_MAX)


def _g(x, alpha, mu, s1, s2):
    s = torch.where(x < mu, s1, s2)
    t = (x - mu) / s
    return alpha * torch.exp(-0.5 * t * t)


def cie_xyz(lam):
    """CIE 1931 2-degree colour-matching functions at lam (nm) -> (..., 3)."""
    x = (_g(lam, 0.362, 442.0, 16.0, 26.7)
         + _g(lam, 1.056, 599.8, 37.9, 31.0)
         + _g(lam, -0.065, 501.1, 20.4, 26.2))
    y = (_g(lam, 0.821, 568.8, 46.9, 40.5)
         + _g(lam, 0.286, 530.9, 16.3, 31.1))
    z = (_g(lam, 1.217, 437.0, 11.8, 36.0)
         + _g(lam, 0.681, 459.0, 26.0, 13.8))
    return torch.stack([x, y, z], -1)


def sample_wavelengths(u, n: int = N_WAVES):
    """Hero-wavelength sampling: u (...,) uniform -> (lam (..., n), pdf).
    lam[..., 0] is the hero, lam[..., j] its rotation by j / n of the band
    (wrapped); each sample's pdf is 1 / LAMBDA_RANGE (a float)."""
    hero = LAMBDA_MIN + u[..., None] * LAMBDA_RANGE
    j = torch.arange(n, dtype=torch.float32, device=u.device)
    lam = LAMBDA_MIN + torch.remainder(hero - LAMBDA_MIN + j * (LAMBDA_RANGE / n), LAMBDA_RANGE)
    return lam, 1.0 / LAMBDA_RANGE


def band_responses(lam):
    """(..., 3) indicator of the (blue, green, red) box bands at lam."""
    e = _BAND_EDGES
    b = (lam >= e[0]) & (lam < e[1])
    g = (lam >= e[1]) & (lam < e[2])
    r = (lam >= e[2]) & (lam <= e[3])
    return torch.stack([b, g, r], -1).to(torch.float32)


def _trapezoid(y, x, axis=0):
    fn = getattr(np, "trapezoid", None) or np.trapz
    return fn(y, x, axis=axis)


def _calibration():
    """(uplift matrix (3, 3), the integral of ybar, the white balance (3,)),
    each float32 as numpy: (a) a per-channel von Kries balance maps the flat
    spectrum (illuminant E) to sRGB white, so grays round-trip at every path
    depth; (b) A[c, band], the balanced sRGB response of a unit box-band
    emitter, whose inverse uplifts the non-gray residual so any RGB
    round-trips through one spectral event."""
    lam = np.linspace(LAMBDA_MIN, LAMBDA_MAX, 4096, dtype=np.float64)
    lam32 = torch.from_numpy(lam.astype(np.float32))
    xyz = cie_xyz(lam32).double().numpy()                  # (K, 3)
    bands = band_responses(lam32).double().numpy()
    y_int = _trapezoid(xyz[:, 1], lam)
    M = np.asarray(_XYZ2RGB, np.float32).astype(np.float64)
    rgb_flat = M @ (_trapezoid(xyz, lam, axis=0) / y_int)
    balance = 1.0 / rgb_flat
    A = np.zeros((3, 3))
    for b in range(3):
        xyz_b = _trapezoid(xyz * bands[:, b:b + 1], lam, axis=0) / y_int
        A[:, b] = balance * (M @ xyz_b)
    return (np.linalg.inv(A).astype(np.float32), np.float32(y_int),
            balance.astype(np.float32))


_UPLIFT_NP, _Y_INT, _BALANCE_NP = _calibration()
_UPLIFT_M = tuple(tuple(float(v) for v in row) for row in _UPLIFT_NP)
_BALANCE = tuple(float(v) for v in _BALANCE_NP)
# spectral_to_rgb's denominator pdf * int(ybar), rounded as float32
_PDF_Y = float(np.float32(np.float32(1.0 / LAMBDA_RANGE) * _Y_INT))


def rgb_to_spectrum(rgb, lam):
    """Uplift (..., 3) linear sRGB to spectral samples at lam (..., N): the
    gray part (the channels' minimum) is a flat spectrum, the residual a
    combination of the calibrated box bands. Linear in rgb, so emitters of
    any scale uplift."""
    w = rgb.amin(-1, keepdim=True)
    coeffs = mat3_apply(_UPLIFT_M, rgb - w)                 # (..., 3 bands)
    resp = band_responses(lam)                              # (..., N, 3)
    return w + (resp[..., 0] * coeffs[..., None, 0] + resp[..., 1] * coeffs[..., None, 1]
                + resp[..., 2] * coeffs[..., None, 2])


def spectral_to_rgb(L, lam, pdf):
    """The white-balanced sRGB estimate of spectral radiance samples L
    (..., N) at wavelengths lam (..., N) drawn with density `pdf` (the float
    of `sample_wavelengths`): the mean over samples of L cmf / (pdf
    int(ybar)), balanced so a flat spectrum is white."""
    cmf = cie_xyz(lam)                                     # (..., N, 3)
    denom = _PDF_Y if pdf == 1.0 / LAMBDA_RANGE else float(np.float32(pdf) * _Y_INT)
    xyz = (L[..., None] * cmf).mean(-2) / denom
    rgb = mat3_apply(_XYZ2RGB, xyz)
    return torch.stack([_BALANCE[c] * rgb[..., c] for c in range(3)], -1)
