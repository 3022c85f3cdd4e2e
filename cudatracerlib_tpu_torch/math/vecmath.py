"""Vector math over trailing-dim-3 tensors (port of cudatracerlib_tpu/math/vecmath.py).

Dot products are written as explicit component sums, in the order the JAX
package's reductions take, so results agree to the last bit where possible.
"""
from __future__ import annotations

import math

import torch

EPS = 1e-6
INF = math.inf
PI = math.pi
INV_PI = 1.0 / PI
INV_TWOPI = 1.0 / (2.0 * PI)
INV_FOURPI = 1.0 / (4.0 * PI)


def vec3(x, y, z, dtype=torch.float32, device="cuda"):
    """(..., 3) tensor of the components x, y, z (numbers or tensors), made
    on `device`."""
    return torch.stack([torch.as_tensor(c, dtype=dtype, device=device) for c in (x, y, z)], dim=-1)


def dot(a, b, keepdims: bool = False):
    r = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return r.unsqueeze(-1) if keepdims else r


def absdot(a, b, keepdims: bool = False):
    return dot(a, b, keepdims).abs()


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length(v, keepdims: bool = False):
    return torch.sqrt(torch.clamp(dot(v, v, keepdims), min=0.0))


def length_sqr(v, keepdims: bool = False):
    return dot(v, v, keepdims)


def normalize(v):
    """Safe normalize; returns v/|v| (0 stays 0)."""
    return v * torch.rsqrt(torch.clamp(dot(v, v, keepdims=True), min=1e-20))


def distance(a, b):
    return length(a - b)


def distance_sqr(a, b):
    return length_sqr(a - b)


def lerp(a, b, t):
    return a + (b - a) * t


def clamp(x, lo, hi):
    """min(max(x, lo), hi); the bounds are numbers or tensors."""
    if isinstance(lo, torch.Tensor) or isinstance(hi, torch.Tensor):
        return torch.minimum(torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype, device=x.device)),
                             torch.as_tensor(hi, dtype=x.dtype, device=x.device))
    return torch.clamp(x, lo, hi)


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def safe_sqrt(x):
    """sqrt clamped away from 0 (keeps masked-branch gradients finite)."""
    return torch.sqrt(torch.clamp(x, min=1e-20))


def safe_acos(x):
    return torch.arccos(torch.clamp(x, -1.0 + 1e-7, 1.0 - 1e-7))


def sqr(x):
    return x * x


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


def face_forward(n, ref):
    """Flip n so it lies in the same hemisphere as ref."""
    s = torch.sign(dot(n, ref, keepdims=True))
    return n * torch.where(s == 0.0, 1.0, s)


def spherical_direction(sin_theta, cos_theta, phi):
    return torch.stack([sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], dim=-1)


def spherical_coordinates(d):
    """Direction -> (theta, phi) with phi in [0, 2pi)."""
    theta = safe_acos(d[..., 2])
    phi = torch.atan2(d[..., 1], d[..., 0])
    return theta, torch.where(phi < 0.0, phi + 2.0 * PI, phi)


def max3(v):
    return v.amax(-1)


def min3(v):
    return v.amin(-1)


def mean3(v):
    return v.mean(-1)


def is_finite(v):
    return torch.isfinite(v).all(-1)
