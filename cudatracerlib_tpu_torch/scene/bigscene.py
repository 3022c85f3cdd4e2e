"""Procedural San-Miguel-class test scene, bench config 3
(port of cudatracerlib_tpu/scene/bigscene.py:20-128).

A displaced terrain plus a forest of rotated boxes and spheres: ~1M
triangles at the default target, with strongly non-uniform density. The
numpy generation, its seed and its draw order are the JAX package's, so
the vertex and material arrays equal JAX's exactly. The JAX package caches
the geometry and the built scene in npz files; the port regenerates both
(the geometry in about a second, the SBVH build on the host), so it reads
no cache and writes none.
"""
from __future__ import annotations

import numpy as np

from . import bsdf as B
from . import lights as L
from .scene import Materials, Scene, build_scene
from .sensors import Camera
from .shapes import box, sphere
from .textures import Textures

EXTENT = 20.0


def _terrain(n: int, extent: float, rng) -> np.ndarray:
    """Heightfield terrain: 2*(n-1)^2 triangles."""
    x = np.linspace(-extent, extent, n)
    y = np.linspace(-extent, extent, n)
    X, Y = np.meshgrid(x, y, indexing="ij")
    # value-noise-ish multi-octave height
    Z = np.zeros_like(X)
    for octv in range(4):
        f = 2.0 ** octv / extent
        phx, phy = rng.uniform(0, 2 * np.pi, 2)
        Z += (0.5 ** octv) * 0.6 * np.sin(X * f * 1.7 + phx) * np.cos(Y * f * 1.3 + phy)
    V = np.stack([X, Y, Z], axis=-1).astype(np.float32)
    a = V[:-1, :-1].reshape(-1, 3)
    b = V[1:, :-1].reshape(-1, 3)
    c = V[1:, 1:].reshape(-1, 3)
    d = V[:-1, 1:].reshape(-1, 3)
    t1 = np.stack([a, b, c], axis=1)
    t2 = np.stack([a, c, d], axis=1)
    return np.concatenate([t1, t2]).astype(np.float32)


def _big_geometry(n_tris_target: int, seed: int):
    """(vertices (T, 3, 3) float32, mat_id (T,) int32): terrain for about
    half the budget, then one object per 500 triangles of the rest, every
    third a sphere (material 2), the others boxes rotated about z
    (material 1)."""
    rng = np.random.default_rng(seed)
    extent = EXTENT
    parts = []
    mids = []

    n_grid = int(np.sqrt(n_tris_target * 0.5 / 2)) + 1
    terr = _terrain(n_grid, extent, rng)
    parts.append(terr)
    mids.extend([0] * len(terr))

    budget = n_tris_target - len(terr)
    n_obj = max(budget // 500, 1)
    for i in range(n_obj):
        px, py = rng.uniform(-extent * 0.9, extent * 0.9, 2)
        base_z = 0.0
        s = rng.uniform(0.1, 0.6)
        if i % 3 == 0:
            obj = sphere([px, py, base_z + s], s, n_theta=10, n_phi=20)
            mid = 2
        else:
            h = rng.uniform(0.5, 3.0)
            obj = box([px - s, py - s, base_z], [px + s, py + s, base_z + h])
            ang = rng.uniform(0, np.pi)
            ca, sa = np.cos(ang), np.sin(ang)
            R = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]], np.float32)
            ctr = np.array([px, py, 0], np.float32)
            obj = (obj.reshape(-1, 3) - ctr) @ R.T + ctr
            obj = obj.reshape(-1, 3, 3)
            mid = 1
        parts.append(obj.astype(np.float32))
        mids.extend([mid] * len(obj))

    return np.concatenate(parts), np.asarray(mids, np.int32)


def build_big_scene(n_tris_target: int = 1_000_000, seed: int = 0, light: str = "area",
                    device="cuda") -> Scene:
    """The bench-config-3 scene on `device` (the card unless the caller asks
    for the CPU): DIFFUSE terrain and boxes, ROUGHCONDUCTOR spheres, and a
    downward-facing 6x6 area light at z = 14 (`light="area"`) or a constant
    environment (`light="env"`)."""
    vertices, mat_id = _big_geometry(n_tris_target, seed)
    textures = Textures.build([
        {"type": 0, "color_a": [0.45, 0.4, 0.3]},
        {"type": 0, "color_a": [0.6, 0.55, 0.5]},
        {"type": 0, "color_a": [0.9, 0.9, 0.9]},
    ])
    materials = Materials.build([
        {"bsdf_type": B.DIFFUSE, "tex_albedo": 0},
        {"bsdf_type": B.DIFFUSE, "tex_albedo": 1},
        {"bsdf_type": B.ROUGHCONDUCTOR, "tex_albedo": 2, "alpha_u": 0.15, "alpha_v": 0.15},
    ])
    if light == "area":
        # wound so the normal points down toward the scene
        lt = np.asarray(
            [[[-3, -3, 14], [3, 3, 14], [3, -3, 14]],
             [[-3, -3, 14], [-3, 3, 14], [3, 3, 14]]], np.float32)
        light_records = [{"type": L.AREA_LIGHT, "radiance": [40.0, 38.0, 30.0], "tris": lt}]
    else:
        light_records = [{"type": L.CONSTANT_ENV, "radiance": [1.0, 1.0, 1.2]}]
    camera = Camera.look_at(origin=[0.0, -EXTENT * 1.2, 6.0], target=[0.0, 0.0, 1.0],
                            fov_deg=55.0)
    return build_scene(vertices, None, None, mat_id, materials, textures, light_records,
                       camera, device=device)
