"""BVH arrays and the Woop triangle transform (port of cudatracerlib_tpu/accel/bvh.py:49-118).

The build runs on the host through the C++ SBVH builder (native/); the
result is a NamedTuple of flat tensors with the JAX package's layout:
16-float inner nodes holding both child boxes (child codes bitcast in lanes
12/13), and leaves of exactly LEAF_SIZE triangles padded by duplicating the
first one, so duplicate Woop rows are common.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._tree import tree_to
from ..native import build_bvh_native

LEAF_SIZE = 4
N_BINS = 16
MAX_DEPTH = 60


class BVH(NamedTuple):
    nodes: torch.Tensor       # (M, 16) float32, child codes bitcast in lanes 12/13
    woop: torch.Tensor        # (T_padded, 12) float32 Woop triangle transforms
    tri_index: torch.Tensor   # (T_padded,) int32 -> original triangle id
    root_code: np.int32       # inner index 0, or leaf code if tiny scene
    world_min: np.ndarray     # (3,) host-side bounds
    world_max: np.ndarray     # (3,)

    def to(self, device) -> "BVH":
        return tree_to(self, device)


def woop_transform(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """Per-triangle Woop matrices (T, 12): rows u, v, w of the inverse of
    [e1 e2 n v0] such that for a point p, w = r2.(p,1) vanishes on the
    triangle plane and u = r0.(p,1), v = r1.(p,1) are its barycentrics."""
    T = v0.shape[0]
    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)
    A = np.zeros((T, 4, 4), dtype=np.float64)
    A[:, :3, 0] = e1
    A[:, :3, 1] = e2
    A[:, :3, 2] = n
    A[:, :3, 3] = v0
    A[:, 3, 3] = 1.0
    # degenerate (zero-area) triangles get all-zero rows, which never hit
    det = np.einsum("tij,tij->t", A[:, :3, :3], A[:, :3, :3])
    bad = ~np.isfinite(det) | (np.linalg.norm(n, axis=1) < 1e-20)
    A[bad] = np.eye(4)
    inv = np.linalg.inv(A)
    out = np.concatenate([inv[:, 0, :], inv[:, 1, :], inv[:, 2, :]], axis=1)
    out[bad] = 0.0
    return out.astype(np.float32)


def build_bvh(vertices: np.ndarray, with_host: bool = False, device="cuda"):
    """Binned-SAH BVH over triangles given as (T, 3, 3) vertices, built by
    the native SBVH builder on the host, its tensors on `device` (the card
    unless the caller asks for the CPU). `with_host` also returns the host
    arrays."""
    tris = np.asarray(vertices, dtype=np.float32)
    T = tris.shape[0]
    if T == 0:
        raise ValueError("build_bvh needs at least one triangle")
    node_arr, order, root = build_bvh_native(tris, LEAF_SIZE, N_BINS, MAX_DEPTH)
    order = np.clip(order, 0, T - 1).astype(np.int32)
    woop = woop_transform(tris[order, 0], tris[order, 1], tris[order, 2])
    bvh = BVH(
        nodes=torch.from_numpy(node_arr).to(device),
        woop=torch.from_numpy(woop).to(device),
        tri_index=torch.from_numpy(order).to(device),
        root_code=np.int32(root),
        world_min=tris.min(axis=1).min(axis=0),
        world_max=tris.max(axis=1).max(axis=0),
    )
    if with_host:
        return bvh, {"nodes": node_arr, "woop": woop, "root": root,
                     "order": order, "tris": tris[order]}
    return bvh
