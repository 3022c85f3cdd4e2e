"""Vector math over trailing-dim-3 tensors (port of cudatracerlib_tpu/math/vecmath.py).

Dot products are written as explicit component sums, in the order the JAX
package's reductions take, so results agree to the last bit where possible.
"""
from __future__ import annotations

import math

import torch

PI = math.pi
INV_PI = 1.0 / PI
INV_TWOPI = 1.0 / (2.0 * PI)
INV_FOURPI = 1.0 / (4.0 * PI)


def dot(a, b, keepdims: bool = False):
    r = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return r.unsqueeze(-1) if keepdims else r


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def normalize(v):
    """Safe normalize; returns v/|v| (0 stays 0)."""
    return v * torch.rsqrt(torch.clamp(dot(v, v, keepdims=True), min=1e-20))


def safe_sqrt(x):
    """sqrt clamped away from 0 (keeps masked-branch gradients finite)."""
    return torch.sqrt(torch.clamp(x, min=1e-20))


def coordinate_system(n):
    """Branchless orthonormal basis from a unit vector (Duff et al. 2017).
    Returns (s, t) with (s, t, n) right-handed orthonormal."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    s = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    t = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return s, t


def reflect(w, n):
    """Mirror reflection of direction `w` about normal `n` (both pointing
    away from the surface)."""
    return 2.0 * dot(w, n, keepdims=True) * n - w


def refract(w, n, eta, cos_theta_t):
    """`w` refracted about `n`, given the relative IOR `eta` (per lane) and
    the signed transmitted cosine from `fresnel_dielectric`."""
    cos_theta_i = dot(w, n, keepdims=True)
    return n * (cos_theta_i * eta[..., None] + cos_theta_t[..., None]) - w * eta[..., None]
