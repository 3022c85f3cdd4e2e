"""Packed per-triangle shading table for the fused-gather shade path
(port of cudatracerlib_tpu/scene/shade_pack.py:31-218).

One (Tp, 64) float32 table joins what the surface shading reads per hit
lane: vertices, normals, uvs, the face normal, uv density, the Woop rows and
the per-material parameters joined per triangle. One `packed_gather`
(ops/shade_gather.py) per bounce then replaces the per-lane gathers of
`make_interaction` and `gather_mat_params`. The column layout is the JAX
package's, so the two tables compare array for array.

Unlike the JAX pack path, `pack_interaction` honours `flat`: a flat-shaded
scene gets the frame `Frame.from_normal(n_face)` and uv = the barycentrics,
as `make_interaction(flat=True)` builds them, and t / u / v come from the
intersector's hit (exact float32 on both the dense and the BVH path) rather
than from a recompute. The card then computes the same estimator as the
CPU path: the microfacet samplers draw their azimuth relative to the frame's
tangent, so another frame gives other samples from the same numbers. Their
gradient is the JAX recompute's: the closed-form Woop re-evaluation on the
pack's Woop columns (`traversal.refine_lanes`), so it reaches the Woop rows
through the pack and its gather's backward.
"""
from __future__ import annotations

import torch

from ..accel.traversal import refine_lanes, wants_grad
from ..math.frame import Frame
from ..math.vecmath import cross, dot, normalize
from ..ops.shade_gather import MAX_ROWS, packed_gather
from . import bsdf as bsdf_mod
from . import textures as tex_mod

# ---- column layout (float32 columns, padded to 64) ----
VERTS = slice(0, 9)
NORMALS = slice(9, 18)
UVS = slice(18, 24)
N_FACE = slice(24, 27)
UV_DENSITY = 27
WOOP = slice(28, 40)
MAT_ID = 40
BSDF_TYPE = 41
DIST_TYPE = 42
ETA = 43
COND_ETA = slice(44, 47)
COND_K = slice(47, 50)
ALPHA_U = 50
ALPHA_V = 51
EXPONENT = 52
NONLINEAR = 53
BLEND_WEIGHT = 54
LIGHT_ID = 55
TEX_ALBEDO = 56
TEX_SPECULAR = 57
TEX_TRANS = 58
N_USED = 59
COLS = 64


def pack_enabled(scene) -> bool:
    """The fused shade path applies to scenes on the card whose padded
    triangle count lies in the JAX package's band, 1024 <= Tp <= 16384,
    and that are not instanced (the pack is indexed by a flat prim; JAX
    turns it off for instanced scenes too). Smaller scenes, Cornell among
    them, keep the per-lane gathers; CPU scenes always do."""
    if scene.instances:
        return False
    Tp = int(scene.bvh.woop.shape[0])
    return scene.bvh.woop.device.type == "cuda" and 1024 <= Tp <= MAX_ROWS


def build_shade_pack(scene) -> torch.Tensor:
    """(Tp, 64) float32 join of shading, Woop and per-material columns;
    Tp-sized work, built once per render. Differentiable in every source
    column (the material columns through the per-triangle gather)."""
    sh, m = scene.shading, scene.materials
    Tp = sh.verts.shape[0]
    mid = sh.mat_id.long()

    def col(x):
        return x.reshape(Tp, -1).to(torch.float32)

    parts = [
        col(sh.verts), col(sh.normals), col(sh.uvs), col(sh.n_face),
        col(sh.uv_density), col(scene.bvh.woop), col(sh.mat_id),
        col(m.bsdf_type[mid]), col(m.dist_type[mid]), col(m.eta[mid]),
        col(m.cond_eta[mid]), col(m.cond_k[mid]), col(m.alpha_u[mid]),
        col(m.alpha_v[mid]), col(m.exponent[mid]), col(m.nonlinear[mid]),
        col(m.blend_weight[mid]), col(m.light_id[mid]), col(m.tex_albedo[mid]),
        col(m.tex_specular[mid]), col(m.tex_transmittance[mid]),
    ]
    tbl = torch.cat(parts, dim=1)
    assert tbl.shape[1] == N_USED, tbl.shape
    return torch.nn.functional.pad(tbl, (0, COLS - N_USED))


def cols(rows, s: slice):
    """(B, n) column view of the gathered (B, 64) rows."""
    return rows[:, s]


def pack_interaction(rows, o, d, hit, flat: bool = False):
    """Interaction from the gathered pack rows (the fused fillDG), with the
    intersector's own t and barycentrics, differentiable in the rows' Woop
    columns and the ray."""
    from .scene import Interaction

    woop = cols(rows, WOOP)
    if wants_grad(woop, o, d):
        hit = refine_lanes(woop, o, d, hit)
    valid = hit.valid
    t_safe = torch.where(valid & torch.isfinite(hit.t), hit.t, 1.0)
    p = o + d * t_safe[..., None]
    n_geo = cols(rows, N_FACE)
    mat_id = torch.where(valid, rows[:, MAT_ID].to(torch.int32), 0)
    prim = torch.clamp(hit.prim, min=0).long()
    if flat:
        return Interaction(p=p, n_geo=n_geo, frame=Frame.from_normal(n_geo), uv=hit.bary,
                           t=hit.t, prim=prim, mat_id=mat_id, valid=valid)
    v = cols(rows, VERTS).reshape(-1, 3, 3)
    vn = cols(rows, NORMALS).reshape(-1, 3, 3)
    uvs = cols(rows, UVS).reshape(-1, 3, 2)
    b1 = hit.bary[..., 0:1]
    b2 = hit.bary[..., 1:2]
    b0 = 1.0 - b1 - b2
    n_sh = normalize(vn[:, 0] * b0 + vn[:, 1] * b1 + vn[:, 2] * b2)
    uv = uvs[:, 0] * b0 + uvs[:, 1] * b1 + uvs[:, 2] * b2

    # tangent from dpdu when the UVs are usable, else an arbitrary ONB
    duv1 = uvs[:, 1] - uvs[:, 0]
    duv2 = uvs[:, 2] - uvs[:, 0]
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    dpdu = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) / torch.where(
        det.abs() < 1e-9, 1.0, det)[:, None]
    use_uv = (det.abs() > 1e-9) & ((dpdu * dpdu).sum(-1) > 1e-12)
    s_uv = dpdu - n_sh * dot(n_sh, dpdu, keepdims=True)
    s_len = torch.sqrt(torch.clamp((s_uv * s_uv).sum(-1), min=1e-18))
    s = torch.where((use_uv & (s_len > 1e-9))[:, None], s_uv / s_len[:, None],
                    Frame.from_normal(n_sh).s)
    frame = Frame(s=s, t=cross(n_sh, s), n=n_sh)
    return Interaction(p=p, n_geo=n_geo, frame=frame, uv=uv, t=hit.t, prim=prim,
                       mat_id=mat_id, valid=valid)


def pack_mat_params(scene, rows, uv, tex_types=None, uv_width=None) -> bsdf_mod.MatParams:
    """MatParams from pack columns plus texture evaluation at uv (the fused
    gather_mat_params; `uv_width` as there)."""
    def i32(c):
        return rows[:, c].to(torch.int32)

    def tex(c):
        return tex_mod.eval_texture(scene.textures, i32(c).long(), uv, active=tex_types,
                                    uv_width=uv_width)

    return bsdf_mod.MatParams(
        bsdf_type=i32(BSDF_TYPE),
        dist_type=i32(DIST_TYPE),
        albedo=tex(TEX_ALBEDO),
        specular=tex(TEX_SPECULAR),
        transmittance=tex(TEX_TRANS),
        eta=rows[:, ETA],
        cond_eta=cols(rows, COND_ETA),
        cond_k=cols(rows, COND_K),
        alpha_u=rows[:, ALPHA_U],
        alpha_v=rows[:, ALPHA_V],
        exponent=rows[:, EXPONENT],
        nonlinear=rows[:, NONLINEAR],
        blend_weight=rows[:, BLEND_WEIGHT],
    )


def hit_shading(scene, o, d, hit, pack, tex_types=None, uv_width=None, flat: bool = False):
    """(Interaction, MatParams) for a hit batch: one packed gather when
    `pack` is set, the per-lane gathers otherwise. `uv_width`: the texture
    footprint of `gather_mat_params`."""
    if pack is not None:
        rows = packed_gather(pack, torch.clamp(hit.prim, min=0))
        it = pack_interaction(rows, o, d, hit, flat=flat)
        return it, pack_mat_params(scene, rows, it.uv, tex_types, uv_width)
    from .scene import gather_mat_params, make_interaction

    it = make_interaction(scene, o, d, hit, flat=flat)
    return it, gather_mat_params(scene, it, tex_types, uv_width)
