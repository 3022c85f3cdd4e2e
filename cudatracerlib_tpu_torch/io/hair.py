"""Hair geometry loader: strand control points -> ribbon triangles.

Port of cudatracerlib_tpu/io/hair.py, numpy only as there; the port keeps its own
copy so that it imports nothing of the JAX package.

Counterpart of the reference's `hair` shape plugin support
(Engine/SceneLoader/Mitsuba/ObjectParser.h:1104-1290 + Primitives.h hair
geometry): Mitsuba's hair format is a text file of per-line control points
with blank lines separating strands (or a binary variant tagged
"BINARY_HAIR"). Each strand segment becomes a thin ribbon (two triangles)
whose width is the fiber radius — fixed world-oriented ribbons rather than
camera-facing, so the geometry is static under XLA and BVH-friendly.
"""
from __future__ import annotations

import struct
from typing import Optional

import numpy as np


def _read_strands_text(path: str):
    strands = []
    cur = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                if len(cur) >= 2:
                    strands.append(np.asarray(cur, np.float32))
                cur = []
                continue
            parts = line.split()
            if len(parts) >= 3:
                cur.append([float(parts[0]), float(parts[1]), float(parts[2])])
    if len(cur) >= 2:
        strands.append(np.asarray(cur, np.float32))
    return strands


def _read_strands_binary(path: str):
    with open(path, "rb") as f:
        magic = f.read(11)
        if magic != b"BINARY_HAIR":
            return None
        (n_pts,) = struct.unpack("<I", f.read(4))
        data = f.read()
    strands = []
    cur = []
    off = 0
    count = 0
    while count < n_pts and off + 4 <= len(data):
        (x,) = struct.unpack_from("<f", data, off)
        if np.isinf(x):
            # +inf marks a new strand
            if len(cur) >= 2:
                strands.append(np.asarray(cur, np.float32))
            cur = []
            off += 4
            continue
        y, z = struct.unpack_from("<2f", data, off + 4)
        cur.append([x, y, z])
        off += 12
        count += 1
    if len(cur) >= 2:
        strands.append(np.asarray(cur, np.float32))
    return strands


def load_hair(path: str, radius: float = 0.025) -> Optional[np.ndarray]:
    """Returns ribbon triangle soup (T, 3, 3) float32, or None."""
    with open(path, "rb") as f:
        head = f.read(11)
    strands = _read_strands_binary(path) if head == b"BINARY_HAIR" \
        else _read_strands_text(path)
    if not strands:
        return None

    tris = []
    up_fallback = np.asarray([0.0, 0.0, 1.0], np.float32)
    for s in strands:
        d = s[1:] - s[:-1]
        ln = np.linalg.norm(d, axis=1, keepdims=True)
        d = d / np.maximum(ln, 1e-9)
        # per-segment side vector: perpendicular to the fiber direction
        side = np.cross(d, up_fallback)
        bad = np.linalg.norm(side, axis=1) < 1e-6
        side[bad] = np.cross(d[bad], [1.0, 0.0, 0.0])
        side = side / np.maximum(np.linalg.norm(side, axis=1, keepdims=True), 1e-9)
        a0 = s[:-1] - radius * side
        a1 = s[:-1] + radius * side
        b0 = s[1:] - radius * side
        b1 = s[1:] + radius * side
        tris.append(np.stack([a0, a1, b1], axis=1))
        tris.append(np.stack([a0, b1, b0], axis=1))
    return np.concatenate(tris).astype(np.float32)
