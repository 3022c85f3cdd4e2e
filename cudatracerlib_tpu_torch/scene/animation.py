"""Skeletal animation: linear-blend skinning and the per-frame scene update
(port of cudatracerlib_tpu/scene/animation.py).

Skinning is one einsum over the bone palette; the Woop rows, node boxes and
chunk boxes are refitted on the device (accel/refit.py), so an animation
step never leaves the card and is differentiable in the pose: the gradient
reaches the pose through the shading vertices (`gather_rows`, whose
backward is the deterministic gather-backward kernel) and the refitted Woop
rows (the hit refinement's Woop VJP). The palette lookup per vertex is a
`gather_rows` too, so its cotangent is summed by the same kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..accel.refit import RefitPlan, build_refit_plan, refit_bvh
from ..ops.shade_gather import gather_rows
from .scene import Scene, scene_spec

MAX_WEIGHTS = 4  # bone weights a vertex


class SkinnedMesh(NamedTuple):
    """Rig data in BVH leaf order (per padded-triangle corner)."""

    rest: torch.Tensor      # (T, 3, 3) rest-pose vertices
    bone_ids: torch.Tensor  # (T, 3, MAX_WEIGHTS) int32
    weights: torch.Tensor   # (T, 3, MAX_WEIGHTS)
    inv_bind: torch.Tensor  # (n_bones, 4, 4) inverse bind matrices
    plan: RefitPlan


def make_skinned(scene: Scene, host_nodes: np.ndarray, root: int, bone_ids: np.ndarray,
                 weights: np.ndarray, inv_bind: np.ndarray) -> SkinnedMesh:
    """A rig for `scene`'s mesh on the scene's device; bone_ids / weights
    are per padded-triangle corner, in leaf order (the permutation of
    scene.shading)."""
    dev = scene.shading.verts.device
    return SkinnedMesh(
        rest=scene.shading.verts,
        bone_ids=torch.from_numpy(np.asarray(bone_ids, np.int32)).to(dev),
        weights=torch.from_numpy(np.asarray(weights, np.float32)).to(dev),
        inv_bind=torch.from_numpy(np.asarray(inv_bind, np.float32)).to(dev),
        plan=build_refit_plan(host_nodes, root, device=dev),
    )


def skin_vertices(mesh: SkinnedMesh, pose) -> torch.Tensor:
    """Linear-blend skinning with `pose` (n_bones, 4, 4) world transforms:
    the deformed (T, 3, 3) vertices."""
    palette = torch.einsum("bij,bjk->bik", pose, mesh.inv_bind)    # (n_bones, 4, 4)
    M = gather_rows(palette, mesh.bone_ids.long())                # (T, 3, W, 4, 4)
    rest_h = torch.cat([mesh.rest, torch.ones_like(mesh.rest[..., :1])], -1)  # (T, 3, 4)
    moved = torch.einsum("tcwij,tcj->tcwi", M, rest_h)[..., :3]
    return (moved * mesh.weights[..., None]).sum(2)


def animate_scene(scene: Scene, mesh: SkinnedMesh, pose) -> Scene:
    """One animation step: skin -> refit -> the updated Scene. The vertex
    normals and `shading.n_face` become the posed face normals. (JAX's
    leaves n_face at the rest pose, and both its flat shading path and its
    shade pack read n_face as the geometric normal: a posed flat-shaded
    scene, or any posed scene in the pack's band on an accelerator, shades
    with rest-pose normals there.) The specialization (`spec`) rides along
    unchanged, as JAX's registry keys on the unchanged `shading.mat_id`; a
    scene without one (`convert.scene_from_numpy`'s) gets the rest pose's."""
    verts = skin_vertices(mesh, pose)
    bvh = refit_bvh(scene.bvh, mesh.plan, verts)
    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]
    n = torch.linalg.cross(e1, e2)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
    normals = n[:, None, :].repeat(1, 3, 1)
    return scene._replace(bvh=bvh, shading=scene.shading._replace(verts=verts, normals=normals,
                                                                  n_face=n),
                          spec=scene_spec(scene))


def rigid_pose(n_bones: int, transforms: list, device="cuda") -> torch.Tensor:
    """A list of (4, 4) transforms -> the (n_bones, 4, 4) float32 pose on
    `device` (the card unless the caller asks for the CPU)."""
    out = np.stack([np.asarray(t, np.float32) for t in transforms])
    if out.shape != (n_bones, 4, 4):
        raise ValueError(f"expected {n_bones} (4, 4) transforms, got {out.shape}")
    return torch.from_numpy(out).to(device)
