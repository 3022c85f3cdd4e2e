"""Fresnel equations for dielectrics and conductors
(port of cudatracerlib_tpu/math/fresnel.py:14-88).

The dielectric form returns the signed transmitted cosine so BSDFs can build
the refracted direction without re-deriving it.
"""
from __future__ import annotations

import torch

from .vecmath import safe_sqrt


def fresnel_dielectric(cos_theta_i, eta):
    """Unpolarized Fresnel reflectance at a dielectric interface.

    cos_theta_i: signed incident cosine (positive = outside); eta: ratio
    int_ior / ext_ior, broadcastable. Returns (F, cos_theta_t, eta_it,
    eta_ti): reflectance, the signed transmitted cosine (opposite sign to
    cos_theta_i, 0 under total internal reflection), the relative IOR of the
    transmission and its inverse."""
    eta = torch.as_tensor(eta, dtype=torch.float32, device=cos_theta_i.device)
    outside = cos_theta_i >= 0.0
    eta_it = torch.where(outside, eta, 1.0 / eta)
    eta_ti = 1.0 / eta_it

    cti = cos_theta_i.abs()
    sin2_t = eta_ti * eta_ti * torch.clamp(1.0 - cti * cti, min=0.0)
    tir = sin2_t >= 1.0
    cos_t = safe_sqrt(1.0 - sin2_t)

    r_s = (cti - eta_it * cos_t) / torch.clamp(cti + eta_it * cos_t, min=1e-12)
    r_p = (eta_it * cti - cos_t) / torch.clamp(eta_it * cti + cos_t, min=1e-12)
    F = torch.where(tir, 1.0, 0.5 * (r_s * r_s + r_p * r_p))
    F = torch.where((eta_it - 1.0).abs() < 1e-6, 0.0, F)

    cos_theta_t = torch.where(tir, 0.0, cos_t) * torch.where(outside, -1.0, 1.0)
    return F, cos_theta_t, eta_it, eta_ti


def fresnel_conductor(cos_theta_i, eta, k):
    """Exact unpolarized conductor Fresnel (eta + i k), per channel.
    cos_theta_i: (...,); eta, k: (..., 3). Returns (..., 3)."""
    c = cos_theta_i.abs()[..., None]
    c2 = c * c
    s2 = 1.0 - c2
    e2 = eta * eta
    k2 = k * k

    t0 = e2 - k2 - s2
    a2b2 = safe_sqrt(t0 * t0 + 4.0 * e2 * k2)
    t1 = a2b2 + c2
    a = safe_sqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * c
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-12)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-12)
    return 0.5 * (rp + rs)


def fresnel_diffuse_reflectance(eta):
    """Average reflectance for diffuse illumination (the polynomial fit of
    d'Eon & Irving / Mitsuba), for the plastic interreflection term."""
    inv_eta = 1.0 / eta
    f_low = -0.4399 + 0.7099 * inv_eta - 0.3319 * inv_eta ** 2 + 0.0636 * inv_eta ** 3
    # torch.div(scalar, x) divides; `scalar / x` would multiply by 1 / x
    f_high = torch.div(-1.4399, eta * eta) + torch.div(0.7099, eta) + 0.6681 + 0.0636 * eta
    return torch.where(eta < 1.0, f_low, f_high)
