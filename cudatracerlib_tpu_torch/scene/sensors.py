"""Camera (port of cudatracerlib_tpu/scene/sensors.py:30-182).

Cameras look down +z in camera space; `to_world` is a (4, 4) camera-to-world
transform. Film coordinates (u, v) in [0,1]^2 have (0,0) at the top-left
pixel. Ray generation is ported for all five camera models (PERSPECTIVE,
THINLENS, ORTHOGRAPHIC, SPHERICAL, TELECENTRIC); the lens connection
(`sample_direct`) is the pinhole's for every model, as in the JAX package.
The model is scene-static, so `Camera.ctype` is a host int (the JAX
package's is an int32 array that every model's rays are selected by) and
`sample_ray` computes only that model's rays.
The 3x3 transforms are written as explicit float32 arithmetic, not matmuls,
so no TF32 path can touch them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .._tree import tree_to
from ..math import warp
from ..math.vecmath import PI, normalize

PERSPECTIVE = 0
THINLENS = 1
ORTHOGRAPHIC = 2
SPHERICAL = 3
TELECENTRIC = 4


class Camera(NamedTuple):
    ctype: int                     # camera model, on the host
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
            ctype=int(ctype),
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


def sample_ray(cam: Camera, film_uv, u_aperture):
    """Primary rays for film positions (..., 2) in [0,1]^2. Returns
    (origin, direction, importance_weight). `u_aperture` (..., 2) drives the
    lens of THINLENS and TELECENTRIC cameras (the other models ignore it).
    Only `cam.ctype`'s model is computed, with the JAX package's arithmetic
    for it."""
    t = cam.ctype

    def lens_point():
        disk = warp.square_to_uniform_disk_concentric(u_aperture) * cam.aperture_radius
        return torch.stack([disk[..., 0], disk[..., 1], torch.zeros_like(disk[..., 0])], dim=-1)

    if t in (PERSPECTIVE, THINLENS):
        x = (film_uv[..., 0] * 2.0 - 1.0) * cam.tan_half_fov
        y = (1.0 - film_uv[..., 1] * 2.0) * cam.tan_half_fov / cam.aspect
        d_cam = normalize(torch.stack([x, y, torch.ones_like(x)], dim=-1))
        o_cam = torch.zeros_like(d_cam)
        if t == THINLENS:  # the lens point, aimed at the focus plane at focal_distance
            focus_p = d_cam * (cam.focal_distance / torch.clamp(d_cam[..., 2:3], min=1e-6))
            o_cam = lens_point()
            d_cam = normalize(focus_p - o_cam)
    elif t in (ORTHOGRAPHIC, TELECENTRIC):  # telecentric: a lens offset on the origin
        ox = (film_uv[..., 0] * 2.0 - 1.0) * cam.ortho_scale
        oy = (1.0 - film_uv[..., 1] * 2.0) * cam.ortho_scale / cam.aspect
        o_cam = torch.stack([ox, oy, torch.zeros_like(ox)], dim=-1)
        if t == TELECENTRIC:
            o_cam = o_cam + lens_point()
        d_cam = torch.zeros_like(o_cam)
        d_cam[..., 2] = 1.0
    elif t == SPHERICAL:  # equirectangular over the full sphere
        phi = (1.0 - film_uv[..., 0]) * 2.0 * PI - PI
        theta = film_uv[..., 1] * PI
        st = torch.sin(theta)
        d_cam = torch.stack([st * torch.sin(phi), torch.cos(theta), st * torch.cos(phi)], dim=-1)
        o_cam = torch.zeros_like(d_cam)
    else:
        raise ValueError(f"camera type {t}: the models are 0 (perspective) to 4 (telecentric)")
    o = _xform(cam.to_world, o_cam, point=True)
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
    zero = torch.zeros((), device=cam.tan_half_fov.device)
    if cam.ctype in (ORTHOGRAPHIC, TELECENTRIC):
        return 2.0 * cam.ortho_scale / width, zero
    if cam.ctype == SPHERICAL:
        return zero, zero + 2.0 * math.pi / width
    return zero, 2.0 * cam.tan_half_fov / width
