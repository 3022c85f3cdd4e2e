"""BVH refit for deformable geometry (port of cudatracerlib_tpu/accel/refit.py).

The tree topology is fixed after the build: a host-side `RefitPlan` groups
the inner nodes by depth, and `refit_bvh` walks the levels bottom-up on the
device, one gather of child boxes a level. The Woop rows are recomputed on
the device in JAX's closed form (float32; the determinant |n|^2 clamped at
1e-20, so a near-degenerate triangle gets huge rows rather than zero ones),
which keeps the whole animate -> refit -> trace step on the card and
differentiable in the vertices.

The port's BVH also carries the dense kernel's chunk boxes, which JAX's
lacks, and the rows' vertices for the watertight test: a refit that moved
the vertices but kept the old boxes would lose hits without an error, so
`refit_bvh` rebuilds both from the refitted vertices on the device
(`bvh.chunk_boxes`, `bvh.tri_verts`; an ill-conditioned row opens its
chunk's box to all of space, the safe side). `world_min` / `world_max` stay host
numpy arrays, as the photon engines read them there: one read of 6 floats
from the device a refit.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .bvh import BVH, LEAF_SIZE, chunk_boxes, vertex_rows


def _cross(a, b):
    """jnp.cross's component order."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def woop_transform_device(tri_verts):
    """(T, 12) Woop rows from (T, 3, 3) vertices, in closed form: the rows
    of the inverse of [e1 e2 n v0] are cross(e2, n), cross(n, e1) and n over
    det = |n|^2, each with its offset -r.v0."""
    v0 = tri_verts[:, 0]
    e1 = tri_verts[:, 1] - v0
    e2 = tri_verts[:, 2] - v0
    n = _cross(e1, e2)
    det = torch.clamp((n * n).sum(-1, keepdim=True), min=1e-20)
    rows = [_cross(e2, n) / det, _cross(n, e1) / det, n / det]
    return torch.cat([torch.cat([r, -(r * v0).sum(-1, keepdim=True)], -1) for r in rows], -1)


class RefitPlan(NamedTuple):
    """Per-level inner-node lists from the host (int64 tensors)."""

    level_nodes: tuple     # (K_l,) node ids a level, deepest first
    c0: torch.Tensor       # (M,) child-0 codes
    c1: torch.Tensor       # (M,) child-1 codes


def build_refit_plan(nodes_host: np.ndarray, root: int, device="cuda") -> RefitPlan:
    """The levels of the inner nodes reachable from `root` (breadth first;
    a parent is emitted before its children), on `device` (the card unless
    the caller asks for the CPU)."""
    codes = np.ascontiguousarray(np.asarray(nodes_host, np.float32)[:, 12:14]).view(np.int32)
    M = codes.shape[0]
    depth = np.zeros(M, np.int32)
    seen = np.zeros(M, bool)
    order = [max(int(root), 0)]
    seen[order[0]] = True
    qi = 0
    while qi < len(order):
        i = order[qi]
        qi += 1
        for c in codes[i]:
            if c >= 0 and not seen[c]:
                seen[c] = True
                depth[c] = depth[i] + 1
                order.append(int(c))
    max_d = int(depth[seen].max()) if seen.any() else 0
    levels = tuple(torch.from_numpy(np.nonzero(seen & (depth == dl))[0].astype(np.int64)).to(device)
                   for dl in range(max_d, -1, -1))
    as_t = lambda a: torch.from_numpy(a.astype(np.int64)).to(device)  # noqa: E731
    return RefitPlan(level_nodes=levels, c0=as_t(codes[:, 0]), c1=as_t(codes[:, 1]))


def refit_bvh(bvh: BVH, plan: RefitPlan, tri_verts) -> BVH:
    """The BVH for deformed vertices: Woop rows recomputed (differentiable
    in `tri_verts`), node boxes refitted level by level and chunk boxes
    rebuilt (both from the detached vertices: the intersectors read them
    detached). tri_verts: (T_padded, 3, 3) in BVH leaf order, as
    `scene.shading.verts` holds them."""
    woop = woop_transform_device(tri_verts)
    v = tri_verts.detach()
    lo_t, hi_t = v.amin(1), v.amax(1)
    n_leaf_slots = v.shape[0] // LEAF_SIZE
    leaf_lo = lo_t.reshape(n_leaf_slots, LEAF_SIZE, 3).amin(1)
    leaf_hi = hi_t.reshape(n_leaf_slots, LEAF_SIZE, 3).amax(1)
    nodes = bvh.nodes.detach().clone()
    n_nodes = nodes.shape[0]

    def child_box(codes):
        """(K,) child codes -> (K, 3) lo, (K, 3) hi."""
        is_leaf = (codes < 0)[:, None]
        slot = torch.clamp(torch.where(codes < 0, -(codes + 1), 0) // LEAF_SIZE,
                           0, n_leaf_slots - 1)
        rows = nodes[torch.clamp(codes, 0, n_nodes - 1)]
        n_lo = torch.minimum(rows[:, 0:3], rows[:, 6:9])
        n_hi = torch.maximum(rows[:, 3:6], rows[:, 9:12])
        return (torch.where(is_leaf, leaf_lo[slot], n_lo),
                torch.where(is_leaf, leaf_hi[slot], n_hi))

    for lvl in plan.level_nodes:
        lo0, hi0 = child_box(plan.c0[lvl])
        lo1, hi1 = child_box(plan.c1[lvl])
        nodes[lvl] = torch.cat([lo0, hi0, lo1, hi1, nodes[lvl, 12:16]], -1)

    bounds = torch.stack([lo_t.amin(0), hi_t.amax(0)]).cpu().numpy()
    return bvh._replace(nodes=nodes, woop=woop, world_min=bounds[0], world_max=bounds[1],
                        chunk_boxes=chunk_boxes(v, woop.detach()), tri_verts=vertex_rows(v))
