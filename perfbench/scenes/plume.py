"""The Cornell box filled with the smoke plume (frozen copies of the port's
scene/shapes.cornell_box geometry and scene/media.plume_records grid: a sum
of Gaussians drawn from np.random.default_rng, spanning the box inset by a
margin), with the Henyey-Greenstein phase function."""
from __future__ import annotations

import numpy as np

from .shapes import box, quad


def cornell_geometry():
    """(vertices (60, 3, 3) float32, material ids (60,) int32, light quad):
    0 white, 1 red (left), 2 green (right), 3 the light."""
    tris, mids = [], []

    def add(t, mid):
        tris.append(t)
        mids.extend([mid] * len(t))

    add(quad([-1, 0, 0], [1, 0, 0], [1, 2, 0], [-1, 2, 0]), 0)      # floor
    add(quad([-1, 0, 2], [-1, 2, 2], [1, 2, 2], [1, 0, 2]), 0)      # ceiling
    add(quad([-1, 2, 0], [1, 2, 0], [1, 2, 2], [-1, 2, 2]), 0)      # back wall
    add(quad([-1, 0, 0], [-1, 2, 0], [-1, 2, 2], [-1, 0, 2]), 1)    # left (red)
    add(quad([1, 0, 0], [1, 0, 2], [1, 2, 2], [1, 2, 0]), 2)        # right (green)
    add(box([-0.65, 0.9, 0.0], [-0.05, 1.5, 1.2]), 0)               # tall block
    add(box([0.1, 0.5, 0.0], [0.65, 1.05, 0.6]), 0)                 # short block
    light = quad([-0.25, 0.75, 1.999], [-0.25, 1.25, 1.999],
                 [0.25, 1.25, 1.999], [0.25, 0.75, 1.999])
    add(light, 3)
    return np.concatenate(tris), np.asarray(mids, np.int32), light


def density(res: int, seed: int, n_blobs: int) -> np.ndarray:
    """The (res, res, res) float32 density: n_blobs Gaussians."""
    g = np.stack(np.meshgrid(*[np.linspace(0, 1, res)] * 3, indexing="ij"), -1)
    rng = np.random.default_rng(seed)
    dens = np.zeros((res,) * 3, np.float32)
    for _ in range(n_blobs):
        c = rng.uniform(0.2, 0.8, 3)
        s = rng.uniform(0.05, 0.2)
        dens += np.exp(-np.sum((g - c) ** 2, -1) / (2 * s * s)).astype(np.float32)
    return dens


def build(cfg: dict) -> dict:
    """The scene of configuration `cfg` (configs/plume.json) as plain arrays
    and records (core/scene_data.py describes the layout)."""
    vertices, mat_id, light = cornell_geometry()
    m = cfg["medium"]
    lo = vertices.reshape(-1, 3).min(axis=0)
    hi = vertices.reshape(-1, 3).max(axis=0)
    medium = dict(type="grid", sigma_a=m["sigma_a"], sigma_s=m["sigma_s"],
                  box_min=lo + m["inset"], box_max=hi - m["inset"], phase=m["phase"],
                  g=m["g"], density=density(m["res"], m["density_seed"], m["n_blobs"]))
    return dict(
        vertices=vertices, mat_id=mat_id, materials=cfg["materials"],
        lights=[dict(type="area", radiance=cfg["light_radiance"], tris=light)],
        camera=cfg["camera"], media=[medium], max_depth=cfg["max_depth"],
        rr_start=cfg["rr_start"], ray_eps=cfg["ray_eps"])
