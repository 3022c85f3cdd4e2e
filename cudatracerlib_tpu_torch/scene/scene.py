"""The Scene — flat struct-of-arrays scene description
(port of cudatracerlib_tpu/scene/scene.py).

A Scene is a NamedTuple of tensors with `.to(device)`. Per-triangle shading
attributes are stored in BVH leaf order, so a hit's `prim` addresses them
directly. `build_scene` also derives the scene-static specialization (the
bsdf/light/texture type sets and flags the path tracer specializes on) from
its numpy inputs and keeps it on the scene itself, in `spec`.

On the card a gather is a load, so the JAX package's TPU-only select chains
(`small_gather`) and per-column takes (`gather_rows`) become plain indexing.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._tree import tree_to
from ..accel import traversal as traversal_mod
from ..accel.bvh import BVH, build_bvh
from ..math.frame import Frame
from ..math.vecmath import cross, dot, normalize
from ..ops.shade_gather import gather_rows
from . import bsdf as bsdf_mod
from . import lights as lights_mod
from . import textures as tex_mod
from .lights import Lights, build_lights, light_power
from .sensors import Camera
from .textures import Textures

_MATERIAL_DEFAULTS = dict(
    bsdf_type=(np.int32, 0),
    dist_type=(np.int32, 1),  # GGX
    tex_albedo=(np.int32, 0),
    tex_specular=(np.int32, 0),
    tex_transmittance=(np.int32, 0),
    eta=(np.float32, 1.5),
    cond_eta=(np.float32, [0.2, 0.92, 1.1]),
    cond_k=(np.float32, [3.9, 2.45, 2.14]),
    alpha_u=(np.float32, 0.1),
    alpha_v=(np.float32, 0.1),
    exponent=(np.float32, 30.0),
    nonlinear=(np.float32, 0.0),
    emission=(np.float32, [0.0, 0.0, 0.0]),
    light_id=(np.int32, -1),
    nested_id=(np.int32, 0),
    blend_weight=(np.float32, 0.5),
    tex_normal=(np.int32, -1),
    tex_height=(np.int32, -1),
    height_scale=(np.float32, 1.0),
    parallax=(np.int32, 0),
    alpha_mode=(np.int32, 0),
    tex_alpha=(np.int32, -1),
    alpha_ref=(np.float32, 0.5),
    alpha_ref_color=(np.float32, [0.0, 0.0, 0.0]),
    cauchy_c=(np.float32, 0.0),
    sellmeier_b=(np.float32, [0.0, 0.0, 0.0]),
    sellmeier_c=(np.float32, [1e6, 1e6, 1e6]),  # far poles
    sss=(np.int32, 0),
    sss_sigma_s=(np.float32, [0.0, 0.0, 0.0]),
    sss_sigma_a=(np.float32, [0.0, 0.0, 0.0]),
    sss_g=(np.float32, 0.0),
)


class Materials(NamedTuple):
    """SoA material table; field meanings as in the JAX package."""

    bsdf_type: torch.Tensor
    dist_type: torch.Tensor
    tex_albedo: torch.Tensor
    tex_specular: torch.Tensor
    tex_transmittance: torch.Tensor
    eta: torch.Tensor
    cond_eta: torch.Tensor
    cond_k: torch.Tensor
    alpha_u: torch.Tensor
    alpha_v: torch.Tensor
    exponent: torch.Tensor
    nonlinear: torch.Tensor
    emission: torch.Tensor
    light_id: torch.Tensor
    nested_id: torch.Tensor
    blend_weight: torch.Tensor
    tex_normal: torch.Tensor
    tex_height: torch.Tensor
    height_scale: torch.Tensor
    parallax: torch.Tensor
    alpha_mode: torch.Tensor
    tex_alpha: torch.Tensor
    alpha_ref: torch.Tensor
    alpha_ref_color: torch.Tensor
    cauchy_c: torch.Tensor
    sellmeier_b: torch.Tensor
    sellmeier_c: torch.Tensor
    sss: torch.Tensor
    sss_sigma_s: torch.Tensor
    sss_sigma_a: torch.Tensor
    sss_g: torch.Tensor

    def to(self, device) -> "Materials":
        return tree_to(self, device)

    @staticmethod
    def build(records: list[dict]) -> "Materials":
        m = max(len(records), 1)
        out = {k: np.tile(np.asarray(v, dt), (m,) + (1,) * np.ndim(v))
               for k, (dt, v) in _MATERIAL_DEFAULTS.items()}
        for i, r in enumerate(records):
            for k, v in r.items():
                if k in out:
                    out[k][i] = v
        return Materials(**{k: torch.from_numpy(v) for k, v in out.items()})


class ShadingData(NamedTuple):
    """Per-(padded, leaf-ordered)-triangle shading attributes."""

    verts: torch.Tensor       # (T, 3, 3)
    normals: torch.Tensor     # (T, 3, 3) vertex shading normals
    uvs: torch.Tensor         # (T, 3, 2)
    mat_id: torch.Tensor      # (T,) int32
    n_face: torch.Tensor      # (T, 3) unit geometric normals
    uv_density: torch.Tensor  # (T,) sqrt(uv area / world area)


class Scene(NamedTuple):
    bvh: BVH
    shading: ShadingData
    materials: Materials
    textures: Textures
    lights: Lights
    light_cdf: torch.Tensor     # (NL,) normalized power CDF for light selection
    camera: Camera
    env_light_id: torch.Tensor  # () int32, -1 if no environment light
    spec: dict | None = None    # scene-static specialization (PTConfig fields)

    @property
    def n_lights(self) -> int:
        return self.lights.count

    def to(self, device) -> "Scene":
        return tree_to(self, device)


def scene_intersect(scene: Scene, o, d, t_min=1e-4, t_max=torch.inf,
                    any_hit: bool = False):
    """Closest-hit (the scene-level traceRay)."""
    return traversal_mod.intersect_auto(scene.bvh, o, d, t_min, t_max, any_hit=any_hit)


def scene_occluded(scene: Scene, o, d, t_min=1e-4, t_max=torch.inf):
    return scene_intersect(scene, o, d, t_min, t_max, any_hit=True).valid


class Interaction(NamedTuple):
    """Surface interaction (reference DifferentialGeometry + fillDG)."""

    p: torch.Tensor       # (..., 3) hit point
    n_geo: torch.Tensor   # (..., 3) geometric normal
    frame: Frame          # shading frame
    uv: torch.Tensor      # (..., 2)
    t: torch.Tensor       # (...,) hit distance
    prim: torch.Tensor    # (...,) leaf-order triangle id
    mat_id: torch.Tensor  # (...,) int32
    valid: torch.Tensor   # (...,) bool


def make_interaction(scene: Scene, o, d, hit, flat: bool = False) -> Interaction:
    """Shading data at hit points (vectorized fillDG).

    `flat`: fast path for scenes whose shading normals equal face normals and
    whose UVs are the default barycentric chart (Cornell takes it)."""
    prim = torch.clamp(hit.prim, min=0).long()
    # missed lanes carry t = t_max (possibly inf): clamp so p stays finite
    t_safe = torch.where(hit.valid & torch.isfinite(hit.t), hit.t, 1.0)
    p = o + d * t_safe[..., None]
    mat_id = torch.where(hit.valid, scene.shading.mat_id[prim], 0)
    if flat:
        n = gather_rows(scene.shading.n_face, prim)
        return Interaction(p=p, n_geo=n, frame=Frame.from_normal(n), uv=hit.bary,
                           t=hit.t, prim=prim, mat_id=mat_id, valid=hit.valid)
    v = gather_rows(scene.shading.verts, prim)      # (..., 3, 3)
    vn = gather_rows(scene.shading.normals, prim)   # (..., 3, 3)
    uvs = gather_rows(scene.shading.uvs, prim)      # (..., 3, 2)
    b1 = hit.bary[..., 0:1]
    b2 = hit.bary[..., 1:2]
    b0 = 1.0 - b1 - b2
    e1 = v[..., 1, :] - v[..., 0, :]
    e2 = v[..., 2, :] - v[..., 0, :]
    n_geo = normalize(cross(e1, e2))
    n_sh = normalize(vn[..., 0, :] * b0 + vn[..., 1, :] * b1 + vn[..., 2, :] * b2)
    uv = uvs[..., 0, :] * b0 + uvs[..., 1, :] * b1 + uvs[..., 2, :] * b2

    # tangent from dpdu when the UVs are usable, else an arbitrary ONB
    duv1 = uvs[..., 1, :] - uvs[..., 0, :]
    duv2 = uvs[..., 2, :] - uvs[..., 0, :]
    det = duv1[..., 0] * duv2[..., 1] - duv1[..., 1] * duv2[..., 0]
    dpdu = (e1 * duv2[..., 1:2] - e2 * duv1[..., 1:2]) / torch.where(
        det.abs() < 1e-9, 1.0, det)[..., None]
    use_uv = (det.abs() > 1e-9) & ((dpdu * dpdu).sum(-1) > 1e-12)
    s_fallback = Frame.from_normal(n_sh).s
    s_uv = dpdu - n_sh * dot(n_sh, dpdu, keepdims=True)
    s_len = torch.sqrt(torch.clamp((s_uv * s_uv).sum(-1), min=1e-18))
    s = torch.where((use_uv & (s_len > 1e-9))[..., None], s_uv / s_len[..., None], s_fallback)
    frame = Frame(s=s, t=cross(n_sh, s), n=n_sh)
    return Interaction(p=p, n_geo=n_geo, frame=frame, uv=uv, t=hit.t, prim=prim,
                       mat_id=mat_id, valid=hit.valid)


def gather_mat_params(scene: Scene, it: Interaction, tex_types=None) -> bsdf_mod.MatParams:
    """Per-lane material parameters with textures evaluated (SampleTextures)."""
    m = scene.materials
    mid = it.mat_id.long()
    g = lambda t: gather_rows(t, mid)  # noqa: E731
    return bsdf_mod.MatParams(
        bsdf_type=g(m.bsdf_type),
        dist_type=g(m.dist_type),
        albedo=tex_mod.eval_texture(scene.textures, g(m.tex_albedo).long(), it.uv, tex_types),
        specular=tex_mod.eval_texture(scene.textures, g(m.tex_specular).long(), it.uv, tex_types),
        transmittance=tex_mod.eval_texture(scene.textures, g(m.tex_transmittance).long(),
                                           it.uv, tex_types),
        eta=g(m.eta),
        cond_eta=g(m.cond_eta),
        cond_k=g(m.cond_k),
        alpha_u=g(m.alpha_u),
        alpha_v=g(m.alpha_v),
        exponent=g(m.exponent),
        nonlinear=g(m.nonlinear),
        blend_weight=g(m.blend_weight),
    )


def gather_nested_params(scene: Scene, it: Interaction, tex_types=None) -> bsdf_mod.MatParams:
    """MatParams of each lane's nested material (the inner BSDF of a
    coating or blend, one level): `gather_mat_params` at the material's
    `nested_id`."""
    inner = gather_rows(scene.materials.nested_id, it.mat_id.long())
    return gather_mat_params(scene, it._replace(mat_id=inner), tex_types)


def specialization(mat_id: np.ndarray, materials: dict, tex_ttype: np.ndarray,
                   light_types, normals: np.ndarray, n_face: np.ndarray,
                   uvs: np.ndarray) -> dict:
    """The scene-static specialization, from host arrays: the bsdf, light
    and texture type sets in use, and flags (flat shading, maps, alpha
    test, sss). `materials` maps Materials field names to numpy arrays;
    `normals`, `n_face`, `uvs` are in leaf order."""
    used = np.unique(mat_id)
    used = np.unique(np.concatenate([used, materials["nested_id"][used]]))
    bsdf_types = tuple(sorted(int(x) for x in np.unique(materials["bsdf_type"][used])))
    map_ids = np.concatenate([materials["tex_normal"][used],
                              materials["tex_height"][used],
                              materials["tex_alpha"][used]])
    tex_ids = np.unique(np.concatenate([
        materials["tex_albedo"][used], materials["tex_specular"][used],
        materials["tex_transmittance"][used], map_ids[map_ids >= 0],
    ]))
    tex_types = tuple(sorted(int(x) for x in np.unique(tex_ttype[tex_ids])))
    flat = bool(np.allclose(normals, n_face[:, None, :], atol=1e-5)
                and np.allclose(uvs[:, 0], 0.0)
                and np.allclose(uvs[:, 1], [1.0, 0.0])
                and np.allclose(uvs[:, 2], [0.0, 1.0]))
    height = bool((materials["tex_height"][used] >= 0).any())
    return dict(
        bsdf_types=bsdf_types,
        light_types=tuple(sorted(int(x) for x in light_types)),
        tex_types=tex_types,
        flat_shading=flat,
        normal_maps=bool((materials["tex_normal"][used] >= 0).any()),
        height_maps=height,
        parallax=height and bool((materials["parallax"][used] > 0).any()),
        alpha_test=bool(((materials["alpha_mode"][used] > 0)
                         & (materials["tex_alpha"][used] >= 0)).any()),
        sss=bool((materials["sss"][used] > 0).any()),
    )


def build_scene(vertices: np.ndarray, normals: np.ndarray | None, uvs: np.ndarray | None,
                mat_id: np.ndarray, materials: Materials, textures: Textures,
                light_records: list[dict], camera: Camera,
                env_map: np.ndarray | None = None, device="cuda") -> Scene:
    """Scene assembly: builds the BVH, permutes the shading data into leaf
    order, builds the lights (with the environment tables of `env_map`, an
    (H, W, 3) equirectangular radiance map), derives the light-selection CDF
    and the specialization on the host, and puts every tensor on `device`:
    the card unless the caller asks for the CPU."""
    vertices = np.asarray(vertices, np.float32)
    T = vertices.shape[0]
    if normals is None:
        n = np.cross(vertices[:, 1] - vertices[:, 0], vertices[:, 2] - vertices[:, 0])
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        normals = np.repeat(n[:, None, :], 3, axis=1)
    if uvs is None:
        uvs = np.zeros((T, 3, 2), np.float32)
        uvs[:, 1, 0] = 1.0
        uvs[:, 2, 1] = 1.0
    mat_id = np.asarray(mat_id, np.int32)

    bvh, host = build_bvh(vertices, with_host=True, device=device)
    order = host["order"]
    v_ord = vertices[order]
    nf = np.cross(v_ord[:, 1] - v_ord[:, 0], v_ord[:, 2] - v_ord[:, 0])
    nf = nf / np.maximum(np.linalg.norm(nf, axis=-1, keepdims=True), 1e-12)
    uv_ord = np.asarray(uvs, np.float32)[order]
    nrm_ord = np.asarray(normals, np.float32)[order]
    duv1 = uv_ord[:, 1] - uv_ord[:, 0]
    duv2 = uv_ord[:, 2] - uv_ord[:, 0]
    uv_area = 0.5 * np.abs(duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0])
    w_area = 0.5 * np.linalg.norm(
        np.cross(v_ord[:, 1] - v_ord[:, 0], v_ord[:, 2] - v_ord[:, 0]), axis=-1)
    uv_density = np.sqrt(uv_area / np.maximum(w_area, 1e-20))
    shading = ShadingData(
        verts=torch.from_numpy(v_ord),
        normals=torch.from_numpy(nrm_ord),
        uvs=torch.from_numpy(uv_ord),
        mat_id=torch.from_numpy(mat_id[order]),
        n_face=torch.from_numpy(nf.astype(np.float32)),
        uv_density=torch.from_numpy(uv_density.astype(np.float32)),
    )

    world_min = vertices.reshape(-1, 3).min(axis=0)
    world_max = vertices.reshape(-1, 3).max(axis=0)
    center = 0.5 * (world_min + world_max)
    radius = 0.5 * float(np.linalg.norm(world_max - world_min)) + 1e-4
    lights = build_lights(light_records, center, radius, env_map)
    power = light_power(lights)
    if len(light_records) == 0:
        power = torch.zeros_like(power)
    cdf = torch.cumsum(power, 0) / torch.clamp(power.sum(), min=1e-20)
    env_id = -1
    for i, r in enumerate(light_records):
        if r["type"] in (lights_mod.INFINITE, lights_mod.CONSTANT_ENV):
            env_id = i

    spec = specialization(
        mat_id, {k: v.cpu().numpy() for k, v in materials._asdict().items()},
        textures.ttype.cpu().numpy(), {int(r["type"]) for r in light_records} or {0},
        nrm_ord, nf, uv_ord)
    return Scene(bvh=bvh, shading=shading, materials=materials, textures=textures,
                 lights=lights, light_cdf=cdf, camera=camera,
                 env_light_id=torch.tensor(np.int32(env_id)), spec=spec).to(device)
