"""Frozen numpy copies of the triangle primitives the scene generators use
(the port's scene/shapes.py quad, box and sphere, same order and winding)."""
from __future__ import annotations

import numpy as np


def quad(p0, p1, p2, p3):
    """Two triangles for quad p0-p1-p2-p3 (counter-clockwise winding)."""
    p0, p1, p2, p3 = [np.asarray(p, np.float32) for p in (p0, p1, p2, p3)]
    return np.stack([np.stack([p0, p1, p2]), np.stack([p0, p2, p3])])


def box(lo, hi):
    """12 triangles of an axis-aligned box, normals outward."""
    x0, y0, z0 = np.asarray(lo, np.float32)
    x1, y1, z1 = np.asarray(hi, np.float32)
    faces = [
        quad([x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0])[:, ::-1],
        quad([x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]),
        quad([x0, y0, z0], [x0, y1, z0], [x0, y1, z1], [x0, y0, z1])[:, ::-1],
        quad([x1, y0, z0], [x1, y1, z0], [x1, y1, z1], [x1, y0, z1]),
        quad([x0, y0, z0], [x1, y0, z0], [x1, y0, z1], [x0, y0, z1]),
        quad([x0, y1, z0], [x1, y1, z0], [x1, y1, z1], [x0, y1, z1])[:, ::-1],
    ]
    return np.concatenate(faces)


def sphere(center, radius, n_theta=16, n_phi=32):
    """A UV sphere; the pole rows keep one triangle a cell."""
    center = np.asarray(center, np.float32)
    vs = []
    for i in range(n_theta):
        t0 = np.pi * i / n_theta
        t1 = np.pi * (i + 1) / n_theta
        for j in range(n_phi):
            p0 = 2 * np.pi * j / n_phi
            p1 = 2 * np.pi * (j + 1) / n_phi

            def pt(t, p):
                return center + radius * np.array(
                    [np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)], np.float32)

            a, b, c, d = pt(t0, p0), pt(t1, p0), pt(t1, p1), pt(t0, p1)
            vs.append(np.stack([a, b, c]))
            if i != 0 and i != n_theta - 1:
                vs.append(np.stack([a, c, d]))
    return np.stack(vs)
