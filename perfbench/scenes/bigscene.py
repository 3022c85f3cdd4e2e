"""The San-Miguel-class scene (a frozen copy of the port's
scene/bigscene.py generator: the same numpy draws in the same order, so the
same vertex and material arrays): a displaced terrain for half the triangle
budget, then one object a 500 triangles of the rest, every third a sphere,
the others boxes rotated about z, lit by one downward area light."""
from __future__ import annotations

import numpy as np

from .shapes import box, sphere


def _terrain(n: int, extent: float, rng) -> np.ndarray:
    """Heightfield terrain: 2 (n - 1)^2 triangles."""
    x = np.linspace(-extent, extent, n)
    y = np.linspace(-extent, extent, n)
    X, Y = np.meshgrid(x, y, indexing="ij")
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
    return np.concatenate([np.stack([a, b, c], axis=1),
                           np.stack([a, c, d], axis=1)]).astype(np.float32)


def geometry(n_tris_target: int, seed: int, extent: float):
    """(vertices (T, 3, 3) float32, material ids (T,) int32)."""
    rng = np.random.default_rng(seed)
    parts, mids = [], []
    n_grid = int(np.sqrt(n_tris_target * 0.5 / 2)) + 1
    terr = _terrain(n_grid, extent, rng)
    parts.append(terr)
    mids.extend([0] * len(terr))
    n_obj = max((n_tris_target - len(terr)) // 500, 1)
    for i in range(n_obj):
        px, py = rng.uniform(-extent * 0.9, extent * 0.9, 2)
        s = rng.uniform(0.1, 0.6)
        if i % 3 == 0:
            obj = sphere([px, py, s], s, n_theta=10, n_phi=20)
            mid = 2
        else:
            h = rng.uniform(0.5, 3.0)
            obj = box([px - s, py - s, 0.0], [px + s, py + s, h])
            ang = rng.uniform(0, np.pi)
            ca, sa = np.cos(ang), np.sin(ang)
            R = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]], np.float32)
            ctr = np.array([px, py, 0], np.float32)
            obj = ((obj.reshape(-1, 3) - ctr) @ R.T + ctr).reshape(-1, 3, 3)
            mid = 1
        parts.append(obj.astype(np.float32))
        mids.extend([mid] * len(obj))
    return np.concatenate(parts), np.asarray(mids, np.int32)


def build(cfg: dict) -> dict:
    """The scene of configuration `cfg` (configs/bigscene.json) as plain arrays
    and records (core/scene_data.py describes the layout)."""
    vertices, mat_id = geometry(cfg["n_tris_target"], cfg["geometry_seed"], cfg["extent"])
    h, z = cfg["light"]["half_size"], cfg["light"]["height"]
    # wound so the normal points down toward the scene
    light_tris = np.asarray([[[-h, -h, z], [h, h, z], [h, -h, z]],
                             [[-h, -h, z], [-h, h, z], [h, h, z]]], np.float32)
    return dict(
        vertices=vertices, mat_id=mat_id, materials=cfg["materials"],
        lights=[dict(type="area", radiance=cfg["light"]["radiance"], tris=light_tris)],
        camera=cfg["camera"], media=[], max_depth=cfg["max_depth"],
        rr_start=cfg["rr_start"], ray_eps=cfg["ray_eps"])
