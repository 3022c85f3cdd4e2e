"""Instance-level TLAS: per-instance transforms at traversal time
(port of cudatracerlib_tpu/scene/instances.py).

The instance list is structural: a tuple of per-mesh `InstanceGroup`s
aligned with a tuple of per-mesh `BlasEntry`s. Each instance intersects the
whole ray batch against its mesh's BLAS, the rays mapped by the instance's
world-to-object affine transform; an affine map keeps the ray parameter, so
object-space t is world-space t and merging the best hit needs no rescale.

The JAX package's `lax.scan` over a mesh's instances is a Python loop over
them here, in creation order: one `traversal.intersect_auto` call an
instance (the dense kernel within its band, the BVH kernel above), so the
launches grow with the instance count. Before each call every lane's ray is
slab-tested against the instance's world box up to the running best t; a
lane that misses gets the empty range t_max = t_min, which the dense kernel
skips and the BVH kernel ends after its root test. The running best t is
every later call's t_max, and the strict `t < best` keeps the earlier
instance on a tie.

Memory is O(meshes): the winning instance rides the hit record as
`prim = inst * T_pad + local prim`, T_pad the largest BLAS's padded row
count; `decode_hit` recovers the instance and the shading row, and
`scene.make_interaction` maps the frame from object to world space. A
`BlasEntry` holds the BVH alone: the JAX entry's `clusters` are the TPU
kernel's layout, which the port does not use.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..accel import traversal as traversal_mod
from ..accel.bvh import BVH
from ..accel.traversal import Hit


class BlasEntry(NamedTuple):
    """One unique mesh's bottom-level acceleration structure."""

    bvh: BVH


class InstanceGroup(NamedTuple):
    """All instances of one mesh (aligned index-wise with the blas tuple);
    `prim_base` is the mesh's row offset into the concatenated object-space
    shading tables, repeated per instance."""

    to_object: torch.Tensor  # (Ik, 3, 4) world -> object affine rows
    to_world: torch.Tensor   # (Ik, 3, 4) object -> world affine rows
    mat_id: torch.Tensor     # (Ik,) int32 per-instance material
    prim_base: torch.Tensor  # (Ik,) int32 shading-row offset of this mesh
    world_lo: torch.Tensor   # (Ik, 3) per-instance world AABB (the top-level
    world_hi: torch.Tensor   # (Ik, 3)  cull; +-inf disables it)


def instance_tpad(blas: tuple) -> int:
    """The per-instance prim stride: the largest padded BLAS row count."""
    return max(int(e.bvh.woop.shape[0]) for e in blas)


def _xform_point(M, p):
    return p @ M[:, :3].T + M[:, 3]


def _xform_dir(M, d):
    return d @ M[:, :3].T


def intersect_instances(blas: tuple, groups: tuple, o, d, t_min, t_max,
                        any_hit: bool = False) -> Hit:
    """Two-level intersect: each mesh's instances in creation order against
    the shared BLAS, with the per-lane top-level box cull. Returns a Hit
    whose `prim` packs (instance index, local prim) as `inst * T_pad +
    prim` (decode with `decode_hit`); an any-hit query returns t = t_min
    where found and t_max elsewhere, prim 0 / -1."""
    B, dev = o.shape[0], o.device
    tpad = instance_tpad(blas)
    t_min_b = torch.as_tensor(t_min, dtype=torch.float32, device=dev).expand(B)
    t_max_b = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(B)
    # the cull is a mask only: no gradient flows through it
    od, dd = o.detach(), d.detach()
    inv_d = 1.0 / torch.where(dd.abs() < 1e-20, torch.where(dd < 0, -1e-20, 1e-20), dd)

    best_t = t_max_b.clone()
    best_prim = torch.full((B,), -1, dtype=torch.int32, device=dev)
    best_bary = torch.zeros(B, 2, device=dev)
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    inst_id = 0
    for entry, grp in zip(blas, groups):
        for k in range(grp.to_object.shape[0]):
            M = grp.to_object[k]
            t0 = (grp.world_lo[k] - od) * inv_d
            t1 = (grp.world_hi[k] - od) * inv_d
            bound = t_max_b if any_hit else best_t.detach()
            near = torch.maximum(torch.minimum(t0, t1).amax(-1), t_min_b)
            far = torch.minimum(torch.maximum(t0, t1).amin(-1), bound)
            overlap = near <= far
            cap = torch.where(overlap, bound, t_min_b)
            h = traversal_mod.intersect_auto(entry.bvh, _xform_point(M, o), _xform_dir(M, d),
                                             t_min, cap, any_hit=any_hit)
            if any_hit:
                found = found | (h.valid & overlap)
            else:
                better = h.valid & overlap & (h.t < best_t)
                best_t = torch.where(better, h.t, best_t)
                best_prim = torch.where(better, inst_id * tpad + h.prim, best_prim)
                best_bary = torch.where(better[:, None], h.bary, best_bary)
                found = found | better
            inst_id += 1
    if any_hit:
        return Hit(t=torch.where(found, t_min_b, t_max_b),
                   prim=torch.where(found, 0, -1).to(torch.int32),
                   bary=torch.zeros(B, 2, device=dev), valid=found)
    return Hit(t=best_t, prim=best_prim, bary=best_bary, valid=found)


def flat_instance_arrays(groups: tuple):
    """(to_object (I, 3, 4), to_world (I, 3, 4), mat_id (I,), prim_base
    (I,)) concatenated in the packed instance-index order."""
    def cat(f):
        return torch.cat([getattr(g, f) for g in groups], 0)

    return cat("to_object"), cat("to_world"), cat("mat_id"), cat("prim_base")


def decode_hit(groups: tuple, tpad: int, hit: Hit):
    """(instance id, local prim, shading row), int64, from a packed Hit."""
    prim = torch.clamp(hit.prim, min=0).long()
    inst = prim // tpad
    local = prim - inst * tpad
    _, _, _, prim_base = flat_instance_arrays(groups)
    return inst, local, prim_base.long()[inst] + local


def build_instance_groups(records, prim_bases, obj_bounds=None, device="cuda"):
    """Host-side constructor. `records`: per mesh, a list of (to_world
    (4, 4) float64, mat_id int); `prim_bases`: per mesh its row offset into
    the concatenated shading tables; `obj_bounds`: per mesh an optional (lo
    (3,), hi (3,)) object-space AABB, whose transformed corners give each
    instance's world box for the top-level cull (omitted: +-inf, no cull).
    Tensors on `device` (the card unless the caller asks for the CPU)."""
    groups = []
    for mi, (recs, base) in enumerate(zip(records, prim_bases)):
        tw = np.stack([np.asarray(m, np.float64)[:3, :4] for m, _ in recs])
        to_obj, wlo, whi = [], [], []
        for m, _ in recs:
            m4 = np.asarray(m, np.float64)
            to_obj.append(np.linalg.inv(m4)[:3, :4])
            if obj_bounds is not None:
                lo, hi = obj_bounds[mi]
                corners = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                                    for z in (lo[2], hi[2])])
                wc = corners @ m4[:3, :3].T + m4[:3, 3]
                eps = 1e-4 * (np.abs(wc).max() + 1.0)
                wlo.append(wc.min(0) - eps)
                whi.append(wc.max(0) + eps)
            else:
                wlo.append(np.full(3, -np.inf))
                whi.append(np.full(3, np.inf))
        f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
        i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(device)  # noqa: E731
        groups.append(InstanceGroup(
            to_object=f32(np.stack(to_obj)),
            to_world=f32(tw),
            mat_id=i32([mid for _, mid in recs]),
            prim_base=i32(np.full(len(recs), base)),
            world_lo=f32(np.stack(wlo)),
            world_hi=f32(np.stack(whi)),
        ))
    return tuple(groups)
