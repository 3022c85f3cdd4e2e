"""The rays of chip_smoke.py phase 26 (a) and tests/test_torch_crack.py
that probe the ray / triangle test on the edges triangles share (numpy), and
the decision the watertight test replaced (torch).

  diagonal_quads   quads of two triangles that share a diagonal, at one
                   scale, random orientations and windings (the second
                   triangle's winding flipped on half of them), each with
                   rays aimed at points of its diagonal from a short
                   distance, so that no other quad lies in a ray's way;
  SCALES           the scales the checks take;
  through_wall     which rays a float64 test, tolerant by `eps` in the
                   barycentrics, finds a triangle for: a ray that the
                   float32 test misses but this one hits went through a
                   crack (pixel-centre rays on a closed wall are hit, the
                   open side of a box is not);
  woop_decision    the all-rows closest hit that the Woop test itself
                   decides, on tensors of either device: the decision the
                   JAX package takes, which chip_smoke.py and the tests
                   count the watertight test's changes against.
"""
from __future__ import annotations

import numpy as np
import torch

from cudatracerlib_tpu_torch.accel.traversal import woop_tuv

SCALES = (0.01, 1.0, 100.0)


def _rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                     [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                     [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def diagonal_quads(n_quads: int, rays_per_quad: int, scale: float, seed: int):
    """(tris (2 n, 3, 3) float32, o (n m, 3) float32, d (n m, 3) float32,
    quad (n m,) int64). Quad k is triangles 2k and 2k + 1, sharing the
    diagonal from corner a to corner c; its rays are aimed at points of
    that diagonal (its end points left out) from 0.5-3 scales away, on
    either side of the quad; quads lie on a grid 20 scales apart."""
    rng = np.random.default_rng(seed)
    tris, o, d, quad = [], [], [], []
    side = int(np.ceil(np.sqrt(n_quads)))
    for k in range(n_quads):
        R = _rotation(rng)
        centre = 20.0 * scale * np.array([k % side, k // side, 0.0])
        # a skewed planar quad: corners jittered in its own plane, then rotated
        a, b, c, e = (rng.uniform(-1, 1, size=(4, 2)) * 0.3
                      + np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]]))
        corners = [centre + scale * (R @ np.array([p[0], p[1], 0.0])) for p in (a, b, c, e)]
        A, B, C, E = (np.float32(x) for x in corners)
        second = [A, C, E] if k % 2 == 0 else [A, E, C]    # flipped winding on odd quads
        tris += [[A, B, C], second]
        s = rng.uniform(0.02, 0.98, size=rays_per_quad)
        target = A.astype(np.float64)[None] + s[:, None] * (C.astype(np.float64) - A)[None]
        n = R @ np.array([0.0, 0.0, 1.0])
        away = rng.normal(size=(rays_per_quad, 3))      # off the quad's plane, either side
        away += np.where(rng.uniform(size=(rays_per_quad, 1)) < 0.5, 1.5, -1.5) * n
        away /= np.linalg.norm(away, axis=1, keepdims=True)
        origin = target + scale * rng.uniform(0.5, 3.0, size=(rays_per_quad, 1)) * away
        dirs = target - origin
        o.append(origin)
        d.append(dirs / np.linalg.norm(dirs, axis=1, keepdims=True))
        quad.append(np.full(rays_per_quad, k))
    return (np.asarray(tris, np.float32), np.concatenate(o).astype(np.float32),
            np.concatenate(d).astype(np.float32), np.concatenate(quad))


def through_wall(tris, o, d, eps: float = 1e-6, t_min: float = 1e-4) -> np.ndarray:
    """(B,) bool: some triangle of (T, 3, 3) `tris` is hit by the ray in a
    float64 Moller-Trumbore test that accepts barycentrics down to -eps (a
    ray on an edge, within eps, counts as hitting)."""
    v0, v1, v2 = (np.asarray(tris, np.float64)[:, k] for k in range(3))
    e1, e2 = v1 - v0, v2 - v0
    o, d = np.asarray(o, np.float64), np.asarray(d, np.float64)
    out = np.zeros(o.shape[0], bool)
    for s in range(0, o.shape[0], 4096):
        oo, dd = o[s:s + 4096, None], d[s:s + 4096, None]
        p = np.cross(dd, e2[None])
        det = (e1[None] * p).sum(-1)
        ok = np.abs(det) > 1e-300
        inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
        tv = oo - v0[None]
        u = (tv * p).sum(-1) * inv
        q = np.cross(tv, e1[None])
        v = (dd * q).sum(-1) * inv
        t = (e2[None] * q).sum(-1) * inv
        hit = ok & (u >= -eps) & (v >= -eps) & (u + v <= 1 + eps) & (t > t_min)
        out[s:s + 4096] = hit.any(-1)
    return out


def woop_decision(woop, o, d, t_min=1e-4, t_max=torch.inf):
    """(valid, prim) of the all-rows closest hit decided by the Woop test
    itself: u >= 0, v >= 0, u + v <= 1 on the Woop rows, as the JAX package
    decides; the lowest row wins a tie. woop (T, 12), o and d (B, 3),
    t_min / t_max scalars or (B,), all on one device."""
    B, T = o.shape[0], woop.shape[0]
    t_min = torch.as_tensor(t_min, dtype=torch.float32, device=o.device).expand(B)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=o.device).expand(B)
    r = [c[None, :] for c in woop.t().contiguous()]
    valid = torch.zeros(B, dtype=torch.bool, device=o.device)
    prim = torch.full((B,), -1, dtype=torch.int32, device=o.device)
    chunk = max(1, (1 << (21 if o.device.type == "cpu" else 25)) // max(T, 1))
    for s in range(0, B, chunk):
        sl = slice(s, s + chunk)
        t, u, v = woop_tuv(r, [x[sl, None] for x in o.t()], [x[sl, None] for x in d.t()])
        h = ((t > t_min[sl, None]) & (t < t_max[sl, None]) & torch.isfinite(t)
             & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0))
        valid[sl] = h.any(-1)
        prim[sl] = torch.where(valid[sl], torch.where(h, t, torch.inf).argmin(-1), -1).to(torch.int32)
    return valid, prim
