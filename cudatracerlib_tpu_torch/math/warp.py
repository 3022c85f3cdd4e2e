"""Square -> distribution warps (port of the cudatracerlib_tpu/math/warp.py
warps the path tracer uses: cosine hemisphere, concentric disk, triangle,
uniform sphere, uniform cone)."""
from __future__ import annotations

import torch

from .vecmath import INV_PI, INV_TWOPI, PI, safe_sqrt


def square_to_uniform_sphere(u):
    z = 1.0 - 2.0 * u[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_uniform_disk_concentric(u):
    """Shirley-Chiu concentric disk map (low distortion)."""
    ox = 2.0 * u[..., 0] - 1.0
    oy = 2.0 * u[..., 1] - 1.0
    zero = (ox == 0.0) & (oy == 0.0)
    use_x = ox.abs() > oy.abs()
    r = torch.where(use_x, ox, oy)
    theta = torch.where(
        use_x,
        (PI / 4.0) * (oy / torch.where(ox == 0.0, 1.0, ox)),
        (PI / 2.0) - (PI / 4.0) * (ox / torch.where(oy == 0.0, 1.0, oy)),
    )
    r = torch.where(zero, 0.0, r)
    theta = torch.where(zero, 0.0, theta)
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def square_to_cosine_hemisphere(u):
    p = square_to_uniform_disk_concentric(u)
    z = safe_sqrt(1.0 - p[..., 0] ** 2 - p[..., 1] ** 2)
    return torch.stack([p[..., 0], p[..., 1], z], dim=-1)


def square_to_cosine_hemisphere_pdf(d):
    return torch.clamp(d[..., 2], min=0.0) * INV_PI


def square_to_uniform_triangle(u):
    """Barycentric warp (sqrt parameterization)."""
    a = safe_sqrt(1.0 - u[..., 0])
    return torch.stack([1.0 - a, a * u[..., 1]], dim=-1)


def square_to_uniform_cone(u, cos_cutoff):
    """Uniform direction in the cone about +z with cos(angle) >= cos_cutoff."""
    z = cos_cutoff + u[..., 0] * (1.0 - cos_cutoff)
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_uniform_cone_pdf(cos_cutoff):
    return INV_TWOPI / torch.clamp(1.0 - cos_cutoff, min=1e-12)
