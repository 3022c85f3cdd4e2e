"""BVH arrays and the Woop triangle transform (port of cudatracerlib_tpu/accel/bvh.py:49-118).

The build runs on the host through the C++ SBVH builder (native/); the
result is a NamedTuple of flat tensors with the JAX package's layout:
16-float inner nodes holding both child boxes (child codes bitcast in lanes
12/13), and leaves of exactly LEAF_SIZE triangles padded by duplicating the
first one, so duplicate Woop rows are common. The dense intersector's chunk
boxes (one padded AABB per CHUNK_ROWS consecutive Woop rows) ride along, and
so do the rows' own vertices (`tri_verts`), which the watertight edge test
reads: two rows that share an edge hold its two vertices bit for bit, so
their edge functions are exact negatives of each other.
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
CHUNK_ROWS = 32        # Woop rows per chunk box: 8 leaves, one warp's sweep
BOX_PAD_REL = 1e-3     # box padding, relative to the box's extent plus its largest |coordinate|
BOX_PAD_ABS = 1e-6
# A row whose u, v coefficients times its triangle's extent plus largest
# |coordinate| exceed this is ill-conditioned: float32 rounding of its test
# can put a hit outside any padded box (a near-degenerate triangle whose
# Woop rows are not zero), so its chunk's box is all of space. Below it the
# rounding moves a hit by at most ~2.4e-7 times this times the extent,
# which BOX_PAD_REL covers.
MAX_WOOP_SCALE = 2000.0
EMPTY_BOX = 1e30       # a chunk of all-zero rows only: a point beyond the dense t clamp

class BVH(NamedTuple):
    nodes: torch.Tensor       # (M, 16) float32, child codes bitcast in lanes 12/13
    woop: torch.Tensor        # (T_padded, 12) float32 Woop triangle transforms
    tri_index: torch.Tensor   # (T_padded,) int32 -> original triangle id
    root_code: np.int32       # inner index 0, or leaf code if tiny scene
    world_min: np.ndarray     # (3,) host-side bounds
    world_max: np.ndarray     # (3,)
    chunk_boxes: torch.Tensor | None = None  # (ceil(T_padded / CHUNK_ROWS), 8) float32
    tri_verts: torch.Tensor | None = None    # (T_padded, 12) float32 `vertex_rows` of the rows;
    #                                          set wherever a BVH is made (build_bvh, refit, convert)

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


def chunk_boxes(verts: torch.Tensor, woop: torch.Tensor) -> torch.Tensor:
    """Padded AABBs of CHUNK_ROWS consecutive Woop rows, (C, 8) float32:
    lo xyz in lanes 0-2, hi xyz in lanes 4-6 (two 16-byte loads a box).

    verts (T, 3, 3) are the rows' triangles (non-finite where unknown),
    woop (T, 12) the rows. All-zero rows never hit (for t_min >= 0) and are
    left out; ill-conditioned rows (MAX_WOOP_SCALE) or rows of an unknown
    triangle make their chunk's box all of space. Each box grows by
    BOX_PAD_REL of its extent plus its largest |coordinate|, plus
    BOX_PAD_ABS, so a hit that the Woop test finds with float32 rounding
    lies inside the box of its row; axis-aligned triangles give
    zero-thickness boxes before the padding. A chunk of all-zero rows gets
    the point box (EMPTY_BOX,) * 3, which no ray reaches below t = 1e30."""
    v, w = verts.to(torch.float64), woop.to(torch.float64)
    lo, hi = v.amin(1), v.amax(1)
    zero = (w == 0).all(-1)
    scale = (w[:, [0, 1, 2, 4, 5, 6]].abs().amax(-1)
             * ((hi - lo).amax(-1) + torch.maximum(lo.abs(), hi.abs()).amax(-1)))
    wild = ~zero & ~(torch.isfinite(lo).all(-1) & torch.isfinite(hi).all(-1)
                     & (scale <= MAX_WOOP_SCALE))
    lo = torch.where(zero[:, None], torch.inf, torch.where(wild[:, None], -torch.inf, lo))
    hi = torch.where(zero[:, None], -torch.inf, torch.where(wild[:, None], torch.inf, hi))
    T = v.shape[0]
    C = -(-T // CHUNK_ROWS)
    fill = C * CHUNK_ROWS - T
    lo = torch.cat([lo, lo.new_full((fill, 3), torch.inf)]).reshape(C, CHUNK_ROWS, 3).amin(1)
    hi = torch.cat([hi, hi.new_full((fill, 3), -torch.inf)]).reshape(C, CHUNK_ROWS, 3).amax(1)
    empty = ~(lo <= hi).all(-1, keepdim=True)
    pad = (BOX_PAD_REL * ((hi - lo).amax(-1) + torch.maximum(lo.abs(), hi.abs()).amax(-1))
           + BOX_PAD_ABS)[:, None]
    lo = torch.where(empty, EMPTY_BOX, lo - pad)
    hi = torch.where(empty, EMPTY_BOX, hi + pad)
    col = lo.new_zeros(C, 1)
    return torch.cat([lo, col, hi, col], -1).to(torch.float32)


def woop_vertices(woop: torch.Tensor):
    """The triangles behind a (T, 12) Woop table: ((T, 3, 3) float64
    vertices v0, v0 + e1, v0 + e2, (T,) invertible). The Woop rows are the
    top three rows of the inverse of [e1 e2 n v0; 0 0 0 1], so inverting the
    completed 4x4 gives back e1, e2 and v0. Rows that do not invert (all
    zero, or singular) get NaN vertices."""
    T = woop.shape[0]
    M = torch.zeros(T, 4, 4, dtype=torch.float64, device=woop.device)
    M[:, :3, :] = woop.to(torch.float64).reshape(T, 3, 4)
    M[:, 3, 3] = 1.0
    det = torch.linalg.det(M)
    ok = torch.isfinite(det) & (det != 0)
    eye = torch.eye(4, dtype=torch.float64, device=woop.device)
    A = torch.linalg.inv(torch.where(ok[:, None, None], M, eye))
    e1, e2, v0 = A[:, :3, 0], A[:, :3, 1], A[:, :3, 3]
    verts = torch.stack([v0, v0 + e1, v0 + e2], 1)
    return torch.where(ok[:, None, None], verts, torch.nan), ok


def chunk_boxes_from_woop(woop: torch.Tensor) -> torch.Tensor:
    """Chunk boxes of a bare Woop table (no BVH at hand), on its device."""
    return chunk_boxes(woop_vertices(woop)[0], woop)


def vertex_rows(tris: torch.Tensor) -> torch.Tensor:
    """(T, 12) float32 vertex rows of (T, 3, 3) triangles: v0, v1, v2 in
    lanes 0-2, 4-6 and 8-10 (a float4 each), zeros in lanes 3, 7, 11."""
    t = tris.detach().to(torch.float32)
    return torch.cat([t, t.new_zeros(t.shape[0], 3, 1)], -1).reshape(-1, 12).contiguous()


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
        chunk_boxes=chunk_boxes(torch.from_numpy(tris[order]),
                                torch.from_numpy(woop)).to(device),
        tri_verts=vertex_rows(torch.from_numpy(tris[order])).to(device),
    )
    if with_host:
        return bvh, {"nodes": node_arr, "woop": woop, "root": root,
                     "order": order, "tris": tris[order]}
    return bvh


def tree_depth(nodes: np.ndarray, root_code: int) -> int:
    """Inner nodes on the longest root-to-leaf path of a BVH (host arrays):
    the most entries a traversal stack can hold, since a walk's pending
    far children belong to distinct ancestors of its node. 0 for a leaf
    root."""
    codes = np.ascontiguousarray(np.asarray(nodes, np.float32)[:, 12:14]).view(np.int32)
    level, depth = [int(root_code)], 0
    while level:
        inner = np.asarray([c for c in level if c >= 0], np.int64)
        if inner.size == 0:
            break
        depth += 1
        level = codes[inner].reshape(-1).tolist()
    return depth
