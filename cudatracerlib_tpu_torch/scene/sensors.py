"""Camera (port of cudatracerlib_tpu/scene/sensors.py:30-182).

Cameras look down +z in camera space; `to_world` is a (4, 4) camera-to-world
transform. Film coordinates (u, v) in [0,1]^2 have (0,0) at the top-left
pixel. Ray generation and the lens connection (`sample_direct`) are ported
for PERSPECTIVE cameras. The 3x3 transforms are written as explicit float32
arithmetic, not matmuls, so no TF32 path can touch them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .._tree import tree_to
from ..math.vecmath import normalize

PERSPECTIVE = 0
THINLENS = 1
ORTHOGRAPHIC = 2
SPHERICAL = 3
TELECENTRIC = 4


class Camera(NamedTuple):
    ctype: torch.Tensor            # () int32
    to_world: torch.Tensor         # (4, 4) camera-to-world
    tan_half_fov: torch.Tensor     # () tan(fov_x / 2)
    aspect: torch.Tensor           # () width / height
    aperture_radius: torch.Tensor  # ()
    focal_distance: torch.Tensor   # ()
    ortho_scale: torch.Tensor      # () half-width of the ortho/telecentric view

    def to(self, device) -> "Camera":
        return tree_to(self, device)

    @staticmethod
    def look_at(origin, target, up=(0.0, 0.0, 1.0), fov_deg: float = 45.0,
                aspect: float = 1.0, ctype: int = PERSPECTIVE,
                aperture_radius: float = 0.0, focal_distance: float = 1.0,
                ortho_scale: float = 1.0) -> "Camera":
        origin = np.asarray(origin, np.float64)
        target = np.asarray(target, np.float64)
        up = np.asarray(up, np.float64)
        fwd = target - origin
        fwd = fwd / max(np.linalg.norm(fwd), 1e-12)
        right = np.cross(fwd, up)
        if np.linalg.norm(right) < 1e-9:
            right = np.cross(fwd, np.array([1.0, 0.0, 0.0]))
        right = right / max(np.linalg.norm(right), 1e-12)
        true_up = np.cross(right, fwd)
        m = np.eye(4)
        m[:3, 0] = right
        m[:3, 1] = true_up
        m[:3, 2] = fwd
        m[:3, 3] = origin
        f32 = lambda x: torch.tensor(np.float32(x))  # noqa: E731
        return Camera(
            ctype=torch.tensor(np.int32(ctype)),
            to_world=torch.from_numpy(m.astype(np.float32)),
            tan_half_fov=f32(np.tan(np.radians(fov_deg) / 2)),
            aspect=f32(aspect),
            aperture_radius=f32(aperture_radius),
            focal_distance=f32(focal_distance),
            ortho_scale=f32(ortho_scale),
        )


def _xform(m, v, point: bool):
    """m[:3, :3] @ v (+ m[:3, 3] for points), as explicit float32 sums."""
    rows = []
    for i in range(3):
        r = m[i, 0] * v[..., 0] + m[i, 1] * v[..., 1] + m[i, 2] * v[..., 2]
        rows.append(r + m[i, 3] if point else r)
    return torch.stack(rows, dim=-1)


def sample_ray(cam: Camera, film_uv):
    """Primary rays for film positions (..., 2) in [0,1]^2 of a PERSPECTIVE
    camera. Returns (origin, direction, importance_weight). The caller checks
    the camera type once per render (render/path_tracer.specialize_config)."""
    x = (film_uv[..., 0] * 2.0 - 1.0) * cam.tan_half_fov
    y = (1.0 - film_uv[..., 1] * 2.0) * cam.tan_half_fov / cam.aspect
    d_cam = normalize(torch.stack([x, y, torch.ones_like(x)], dim=-1))
    o = _xform(cam.to_world, torch.zeros_like(d_cam), point=True)
    d = normalize(_xform(cam.to_world, d_cam, point=False))
    return o, d, torch.ones(o.shape[:-1] + (3,), device=o.device)


def sample_direct(cam: Camera, ref_p):
    """Connect scene points (..., 3) to a pinhole camera (the light tracer's
    and BDPT's lens connection, reference Sensor::sampleDirect). Returns
    (film_uv (..., 2), unit direction ref -> camera, distance, importance
    W_e per unit film area, in_frustum)."""
    m = cam.to_world
    # world -> camera: the transpose of the rigid rotation
    q = ref_p - m[:3, 3]
    p_cam = torch.stack([m[0, i] * q[..., 0] + m[1, i] * q[..., 1] + m[2, i] * q[..., 2]
                         for i in range(3)], dim=-1)
    z = torch.clamp(p_cam[..., 2], min=1e-6)
    x_ndc = p_cam[..., 0] / (z * cam.tan_half_fov)
    y_ndc = p_cam[..., 1] / (z * cam.tan_half_fov / cam.aspect)
    u = (x_ndc + 1.0) * 0.5
    v = (1.0 - y_ndc) * 0.5
    to_cam = m[:3, 3] - ref_p
    dist = torch.sqrt(torch.clamp((to_cam * to_cam).sum(-1), min=1e-12))
    d = to_cam / dist[..., None]
    # pinhole importance over the film area: 1 / (A_film cos^4)
    cos_theta = torch.clamp(-(d * m[:3, 2]).sum(-1), min=1e-6)
    film_area = 4.0 * cam.tan_half_fov * (cam.tan_half_fov / cam.aspect)
    importance = 1.0 / (film_area * cos_theta ** 4)
    in_frustum = (u >= 0.0) & (u < 1.0) & (v >= 0.0) & (v < 1.0) & (p_cam[..., 2] > 1e-6)
    return torch.stack([u, v], dim=-1), d, dist, importance, in_frustum


def pixel_spread(cam: Camera, width: int, height: int):
    """Per-pixel ray-cone parameters (r0, slope): the world-space footprint
    radius of one pixel at distance t is ~ r0 + slope * t."""
    persp_slope = 2.0 * cam.tan_half_fov / width
    ortho_r0 = 2.0 * cam.ortho_scale / width
    is_ortho = (cam.ctype == ORTHOGRAPHIC) | (cam.ctype == TELECENTRIC)
    r0 = torch.where(is_ortho, ortho_r0, 0.0)
    slope = torch.where(is_ortho, 0.0,
                        torch.where(cam.ctype == SPHERICAL, 2.0 * math.pi / width,
                                    persp_slope))
    return r0, slope
