"""Bidirectional path tracing with full multiple importance sampling
(port of cudatracerlib_tpu/render/bdpt.py:37-423).

Strategies as in the JAX package: s=0 (the eye path hits an emitter), s=1
(NEE, connectToLight), t=1 (light vertices splatted to the camera,
connectToCamera) and s>=2, t>=2 vertex-to-vertex connections, every one
weighted by the balance heuristic through the recursive quantities
dVCM / dVC (Georgiev's SmallVCM scheme). Camera pdfs use the pixel-area
convention, so t=1 splats divide by the light-path count only.

Light subpaths are traced first and kept as S_MAX per-depth vertex batches
of B lanes (one light path per eye sample); the eye walk then connects
every bounce against all of them. The t=1 splats are summed by the
deterministic splat film (`film.splat_sum`). A stored vertex's shading is
fetched again from its triangle at the barycentric centroid, as in the JAX
package; the port fetches it once per depth and reuses it at every eye
bounce (the JAX module fetches it again at each), which gives the same
values.

The streams (seed ^ 0x1117 for the light paths, the seed for the eye
paths), the draw order and the flat=False frames are the JAX package's, so
the CPU port traces the JAX package's paths lane for lane and counts the
same rays. Forward only: the entry points run under `torch.no_grad()`.
The light paths start from `sample_emitter_ray` for every light type, and
the lens connection is the pinhole's for every camera model, as in JAX.
`eval_bsdf` / `sample_bsdf` run without the nested dispatch, as in the JAX
module, so COATING / ROUGHCOATING / BLEND lanes carry no weight here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..accel.traversal import Hit
from ..image import film as film_mod
from ..math.vecmath import INV_PI, dot
from ..ops.shade_gather import packed_gather
from ..sampling.records import DISCRETE
from ..sampling.rng import MASK, Sampler
from ..scene import bsdf as bsdf_mod
from ..scene import lights as lights_mod
from ..scene import scene as scene_mod
from ..scene import sensors
from ..scene.scene import Scene, gather_mat_params, make_interaction
from ..scene.shade_pack import (build_shade_pack, hit_shading, pack_enabled,
                                pack_interaction, pack_mat_params)
from .light_tracer import emit_particles, splat_pixel
from .path_tracer import (PTConfig, _light_select_pmf, _offset_ray, _select_light,
                          specialize_config)

S_MAX = 5  # stored light vertices (reference MAX_LIGHT_PATH_LENGTH, VCMHelper.h:20-21)
SPECULAR_LOBES = 16 | 32 | 64


class BDPTConfig(NamedTuple):
    base: PTConfig = PTConfig(max_depth=5, rr_start=99)
    s_max: int = S_MAX


def _camera_pdf_w(cam, d_world, height: int):
    """Solid-angle pdf of camera ray sampling, pixel-area convention."""
    fwd = cam.to_world[:3, 2]
    cos_t = torch.clamp(dot(d_world, fwd), min=1e-6)
    tan_half_y = cam.tan_half_fov / cam.aspect
    img_dist = 0.5 * height / torch.clamp(tan_half_y, min=1e-9)
    return (img_dist * img_dist) / (cos_t ** 3)


class _LightVertex(NamedTuple):
    p: torch.Tensor       # (B, 3) position
    wo: torch.Tensor      # direction toward the previous (light-side) vertex
    thr: torch.Tensor     # (B, 3) throughput up to and including arrival here
    d_vcm: torch.Tensor
    d_vc: torch.Tensor
    prim: torch.Tensor    # leaf-order triangle, for the shading re-fetch
    uv: torch.Tensor      # (B, 2)
    valid: torch.Tensor   # bool: found and not delta


def light_start_mis(scene: Scene, d, lsel, lpmf):
    """(d_vcm, d_vc) of emitted rays d from lights lsel: an area
    light's position pdf is 1 / area and its direction pdf cos / pi about
    the normal of its first triangle; other lights take 1 and 1 / (4 pi)
    and start with d_vc = 0."""
    lights = scene.lights
    is_area = lights.ltype[lsel] == lights_mod.AREA_LIGHT
    area = torch.clamp(lights.area[lsel], min=1e-12)
    n_light = lights.tri_n[torch.clamp(lights.tri_first[lsel], 0, lights.tris.shape[0] - 1).long()]
    cos_light = torch.clamp(dot(d, n_light).abs(), min=1e-6)
    pdf_pos_a = torch.where(is_area, 1.0 / area, 1.0) * lpmf
    pdf_dir_w = torch.where(is_area, cos_light * INV_PI, INV_PI * 0.25)
    pdf_emit_w = torch.clamp(pdf_pos_a * pdf_dir_w, min=1e-20)
    return pdf_pos_a / pdf_emit_w, torch.where(is_area, cos_light / pdf_emit_w, 0.0)


def _trace_light_subpath(scene: Scene, B: int, seed, cfg: PTConfig, s_max: int, pack):
    """The light subpaths: s_max per-depth batches of light vertices, and
    the rays traced (alive lanes summed over the steps, int64)."""
    dev = scene.light_cdf.device
    smp = Sampler.create((int(seed) & MASK) ^ 0x1117, torch.arange(B, device=dev), 1)
    o, d, w, lsel, lpmf, smp = emit_particles(scene, B, smp, cfg)
    d_vcm, d_vc = light_start_mis(scene, d, lsel, lpmf)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)
    verts = []
    for _ in range(s_max):
        n_rays = n_rays + alive.sum()
        hit = scene_mod.scene_intersect(scene, o, d)
        it, mp = hit_shading(scene, o, d, hit, pack, cfg.tex_types)
        found = hit.valid & alive

        cos_in = torch.clamp(dot(it.frame.n, -d).abs(), min=1e-6)
        dist2 = torch.clamp(it.t * it.t, min=1e-12)
        d_vcm = d_vcm * dist2 / cos_in
        d_vc = d_vc / cos_in
        verts.append(_LightVertex(p=it.p, wo=-d, thr=w, d_vcm=d_vcm, d_vc=d_vc, prim=it.prim,
                                  uv=it.uv, valid=found & bsdf_mod.is_smooth(mp)))

        s, u2 = smp.next_2d()
        s, u1 = s.next_1d()
        wo_local = it.frame.to_local(-d)
        bs = bsdf_mod.sample_bsdf(mp, wo_local, u2, u1, active=cfg.bsdf_types)
        wi_world = it.frame.to_world(bs.wi)
        _, pdf_rev = bsdf_mod.eval_bsdf(mp, bs.wi, wo_local, active=cfg.bsdf_types)
        d_vcm, d_vc = _continue_mis(bs, pdf_rev, d_vcm, d_vc)
        cont = found & (bs.pdf > 0)
        c3 = cont[..., None]
        o = torch.where(c3, _offset_ray(it.p, it.n_geo, wi_world, cfg.ray_eps), o)
        d = torch.where(c3, wi_world, d)
        w = torch.where(c3, w * bs.weight, w)
        alive = cont
        smp = s
    return verts, n_rays


def _continue_mis(bs, pdf_rev, d_vcm, d_vc):
    """dVCM, dVC after sampling the BSDF at a vertex (SmallVCM's update; a
    specular lobe keeps dVC times the reverse pdf and zeroes dVCM)."""
    cos_out = torch.clamp(bs.wi[..., 2].abs(), min=1e-6)
    is_spec = (bs.sampled_type & SPECULAR_LOBES) > 0
    pdf_fwd = torch.clamp(bs.pdf, min=1e-20)
    new_d_vc = torch.where(is_spec, (cos_out / pdf_fwd) * d_vc * pdf_rev,
                           (cos_out / pdf_fwd) * (d_vc * pdf_rev + d_vcm))
    return torch.where(is_spec, 0.0, 1.0 / pdf_fwd), new_d_vc


def _mis_sum(mis_vm, d_vcm, d_vc, pdf_rev):
    """d_vcm + d_vc pdf_rev, with VCM's merging term first where given
    (the JAX package's order of additions)."""
    return (d_vcm if mis_vm is None else mis_vm + d_vcm) + d_vc * pdf_rev


def vertex_shading(scene: Scene, lv, cfg: PTConfig, pack):
    """(Interaction, MatParams) of stored light vertices, fetched again from
    their triangles at the barycentric centroid: one packed gather where the
    shade pack applies, the per-lane gathers otherwise."""
    B = lv.p.shape[0]
    g_hit = Hit(t=torch.zeros(B, device=lv.p.device), prim=lv.prim.to(torch.int32),
                bary=torch.full((B, 2), 1.0 / 3.0, device=lv.p.device), valid=lv.valid)
    if pack is not None:
        rows = packed_gather(pack, torch.clamp(lv.prim, min=0).to(torch.int32))
        it = pack_interaction(rows, lv.p, -lv.wo, g_hit)._replace(p=lv.p)
        return it, pack_mat_params(scene, rows, lv.uv, cfg.tex_types)
    it = make_interaction(scene, lv.p, -lv.wo, g_hit)._replace(p=lv.p)
    return it, gather_mat_params(scene, it._replace(uv=lv.uv), cfg.tex_types)


def camera_splats(scene: Scene, lverts, shading, B: int, width: int, height: int,
                  cfg: PTConfig, mis_vm=None):
    """t = 1: every light vertex splatted to the camera through a shadow
    ray. Returns ((n_px, 3) splat film, shadow rays cast). `mis_vm` (VCM)
    joins the light-side weight."""
    cam = scene.camera
    pix, vals = [], []
    n_rays = torch.zeros((), dtype=torch.int64, device=scene.light_cdf.device)
    for lv, (it_l, mp_l) in zip(lverts, shading):
        uv, d_cam, dist_cam, _, in_frustum = sensors.sample_direct(cam, lv.p)
        wo_local = it_l.frame.to_local(lv.wo)
        wi_local = it_l.frame.to_local(d_cam)
        f_cam, _ = bsdf_mod.eval_bsdf(mp_l, wo_local, wi_local, active=cfg.bsdf_types)
        _, pdf_rev = bsdf_mod.eval_bsdf(mp_l, wi_local, wo_local, active=cfg.bsdf_types)
        cos_cam = torch.clamp(wi_local[..., 2].abs(), min=1e-6)
        f_noc = f_cam / cos_cam[..., None]  # the folded cosine stripped: raw f
        cam_pdf_w = _camera_pdf_w(cam, -d_cam, height)
        cam_pdf_a = cam_pdf_w * cos_cam / torch.clamp(dist_cam * dist_cam, min=1e-9)
        mis = 1.0 / ((cam_pdf_a / B) * _mis_sum(mis_vm, lv.d_vcm, lv.d_vc, pdf_rev) + 1.0)

        sh_o = _offset_ray(lv.p, it_l.n_geo, d_cam, cfg.ray_eps)
        n_rays = n_rays + (lv.valid & in_frustum).sum()
        blocked = scene_mod.scene_occluded(scene, sh_o, d_cam, cfg.ray_eps,
                                           dist_cam - 2 * cfg.ray_eps)
        contrib = lv.thr * f_noc * (mis * cam_pdf_a / B)[..., None]
        ok = lv.valid & in_frustum & ~blocked
        pix.append(splat_pixel(uv, width, height))
        vals.append(torch.where(ok[..., None],
                                torch.nan_to_num(contrib, nan=0.0, posinf=0.0, neginf=0.0), 0.0))
    return film_mod.splat_sum(torch.cat(pix), torch.cat(vals), width * height), n_rays


def eye_rays(scene: Scene, width: int, height: int, spp: int, seed):
    """Pixel-major eye samples (pixel id repeated per sample, sample index
    outer): (o, d, importance weight, sampler)."""
    dev = scene.light_cdf.device
    n_px = width * height
    pixel_id = torch.arange(n_px, device=dev).repeat(spp)
    sample_idx = torch.arange(spp, device=dev).repeat_interleave(n_px)
    smp = Sampler.create(int(seed) & MASK, pixel_id, sample_idx)
    smp, jitter = smp.next_2d()
    px = (pixel_id % width).to(torch.float32)
    py = (pixel_id // width).to(torch.float32)
    film_uv = torch.stack([(px + jitter[:, 0]) / width, (py + jitter[:, 1]) / height], -1)
    smp, u_ap = smp.next_2d()
    o, d, w_cam = sensors.sample_ray(scene.camera, film_uv, u_ap)
    return o, d, w_cam, smp


def emission_mis(scene: Scene, it, d, found, d_vcm, d_vc, depth: int):
    """s = 0: radiance of the emitter an eye path hits and its MIS weight
    (1 at the first vertex). Returns (Le (B, 3), weight (B,), emissive mask)."""
    mat_light = scene.materials.light_id[it.mat_id.long()]
    lid = torch.clamp(mat_light, min=0).long()
    Le = lights_mod.eval_area_emission(scene.lights, lid, it.n_geo, -d)
    pdf_pos_a = (_light_select_pmf(scene, lid, d_vcm)
                 / torch.clamp(scene.lights.area[lid], min=1e-12))
    cos_l = torch.clamp(dot(it.n_geo, -d).abs(), min=1e-6)
    w_camera = pdf_pos_a * d_vcm + pdf_pos_a * cos_l * INV_PI * d_vc
    mis0 = torch.ones_like(w_camera) if depth == 0 else 1.0 / (1.0 + w_camera)
    return Le, mis0, found & (mat_light >= 0)


def nee_mis(scene: Scene, it, mp, w, wo_local, u_sel, u_l2, d_vcm, d_vc, cfg: PTConfig,
            mis_vm=None):
    """s = 1: one light sample with BDPT (or, with `mis_vm`, VCM) weights,
    for eye throughput w. Returns (contribution (B, 3), ok mask)."""
    lsel, lpmf, _ = _select_light(scene, u_sel)
    ds, Lrad = lights_mod.sample_direct(scene.lights, lsel, it.p, u_l2, active=cfg.light_types)
    wi_l = it.frame.to_local(ds.d)
    f_l, pdf_b_fwd = bsdf_mod.eval_bsdf(mp, wo_local, wi_l, active=cfg.bsdf_types)
    _, pdf_b_rev = bsdf_mod.eval_bsdf(mp, wi_l, wo_local, active=cfg.bsdf_types)
    sh_o = _offset_ray(it.p, it.n_geo, ds.d, cfg.ray_eps)
    blocked = scene_mod.scene_occluded(scene, sh_o, ds.d, cfg.ray_eps, ds.dist - 2 * cfg.ray_eps)
    is_delta_l = ds.measure == DISCRETE
    pdf_l_w = torch.where(is_delta_l, 1.0, ds.pdf) * lpmf
    cos_at_light = torch.clamp(dot(ds.n, -ds.d).abs(), min=1e-6)
    cos_to_light = torch.clamp(wi_l[..., 2].abs(), min=1e-6)
    pdf_emit = (lpmf / torch.clamp(scene.lights.area[lsel], min=1e-12)) * cos_at_light * INV_PI
    w_light = pdf_b_fwd / torch.clamp(pdf_l_w, min=1e-20)
    w_cam = (pdf_emit * cos_to_light / torch.clamp(pdf_l_w * cos_at_light, min=1e-20)
             * _mis_sum(mis_vm, d_vcm, d_vc, pdf_b_rev))
    mis1 = torch.where(is_delta_l, 1.0, 1.0 / (w_light + 1.0 + w_cam))
    contrib = w * f_l * Lrad * (mis1 / torch.clamp(pdf_l_w, min=1e-12))[..., None]
    return contrib, ~blocked & (ds.pdf > 0) & (lpmf > 0)


def connect(scene: Scene, it, mp, w, wo_local, lv, it_l, mp_l, d_vcm, d_vc, cfg: PTConfig,
            mis_vm=None):
    """s >= 2: the eye vertex (throughput w) joined to one stored light
    vertex through a shadow ray. Returns (contribution (B, 3), unblocked
    mask)."""
    to_l = lv.p - it.p
    dist2 = torch.clamp(dot(to_l, to_l), min=1e-9)
    dir_c = to_l / torch.sqrt(dist2)[..., None]
    wi_e = it.frame.to_local(dir_c)
    f_e, pdf_e_fwd = bsdf_mod.eval_bsdf(mp, wo_local, wi_e, active=cfg.bsdf_types)
    _, pdf_e_rev = bsdf_mod.eval_bsdf(mp, wi_e, wo_local, active=cfg.bsdf_types)
    cos_e = torch.clamp(wi_e[..., 2].abs(), min=1e-6)
    f_e_raw = f_e / cos_e[..., None]

    wo_l_loc = it_l.frame.to_local(lv.wo)
    wi_l_loc = it_l.frame.to_local(-dir_c)
    f_lv, pdf_l_fwd = bsdf_mod.eval_bsdf(mp_l, wo_l_loc, wi_l_loc, active=cfg.bsdf_types)
    _, pdf_l_rev = bsdf_mod.eval_bsdf(mp_l, wi_l_loc, wo_l_loc, active=cfg.bsdf_types)
    cos_lv = torch.clamp(wi_l_loc[..., 2].abs(), min=1e-6)
    f_lv_raw = f_lv / cos_lv[..., None]

    G = cos_e * cos_lv / dist2
    w_light = pdf_e_fwd * cos_lv / dist2 * _mis_sum(mis_vm, lv.d_vcm, lv.d_vc, pdf_l_rev)
    w_cam = pdf_l_fwd * cos_e / dist2 * _mis_sum(mis_vm, d_vcm, d_vc, pdf_e_rev)
    mis2 = 1.0 / (w_light + 1.0 + w_cam)

    sh_o = _offset_ray(it.p, it.n_geo, dir_c, cfg.ray_eps)
    blocked = scene_mod.scene_occluded(scene, sh_o, dir_c, cfg.ray_eps,
                                       torch.sqrt(dist2) - 2 * cfg.ray_eps)
    contrib = w * f_e_raw * f_lv_raw * lv.thr * (G * mis2)[..., None]
    return torch.nan_to_num(contrib, nan=0.0, posinf=0.0, neginf=0.0), ~blocked


def _bdpt_impl(scene: Scene, width: int, height: int, spp: int, seed, config: BDPTConfig):
    cfg = config.base
    n_px = width * height
    B = n_px * spp
    dev = scene.light_cdf.device
    pack = build_shade_pack(scene) if pack_enabled(scene) else None

    lverts, rays_total = _trace_light_subpath(scene, B, seed, cfg, config.s_max, pack)
    shading = [vertex_shading(scene, lv, cfg, pack) for lv in lverts]
    splat_film, n_splat = camera_splats(scene, lverts, shading, B, width, height, cfg)
    rays_total = rays_total + n_splat

    # ---- eye walk with the s = 0, s = 1 and s >= 2 strategies ----
    o, d, w_cam, smp = eye_rays(scene, width, height, spp, seed)
    w = torch.ones(B, 3, device=dev)
    L = torch.zeros(B, 3, device=dev)
    d_vcm = B / torch.clamp(_camera_pdf_w(scene.camera, d, height), min=1e-9)
    d_vc = torch.zeros(B, device=dev)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    for depth in range(cfg.max_depth):
        rays_total = rays_total + alive.sum()
        hit = scene_mod.scene_intersect(scene, o, d)
        it, mp = hit_shading(scene, o, d, hit, pack, cfg.tex_types)
        found = hit.valid & alive

        cos_in = torch.clamp(dot(it.frame.n, -d).abs(), min=1e-6)
        d_vcm = d_vcm * torch.clamp(it.t * it.t, min=1e-12) / cos_in
        d_vc = d_vc / cos_in

        Le, mis0, emissive = emission_mis(scene, it, d, found, d_vcm, d_vc, depth)
        L = L + torch.where(emissive[..., None], w * Le * mis0[..., None], 0.0)

        wo_local = it.frame.to_local(-d)
        s, u_sel = smp.next_1d()
        s, u_l2 = s.next_2d()
        if scene.n_lights > 0:
            rays_total = rays_total + found.sum()
            contrib, ok = nee_mis(scene, it, mp, w, wo_local, u_sel, u_l2, d_vcm, d_vc, cfg)
            L = L + torch.where((found & ok)[..., None], contrib, 0.0)

        for lv, (it_l, mp_l) in zip(lverts, shading):
            rays_total = rays_total + (found & lv.valid).sum()
            contrib, ok = connect(scene, it, mp, w, wo_local, lv, it_l, mp_l, d_vcm, d_vc, cfg)
            L = L + torch.where((found & lv.valid & ok)[..., None], contrib, 0.0)

        # ---- continue the eye path ----
        s, u2 = s.next_2d()
        s, u1 = s.next_1d()
        bs = bsdf_mod.sample_bsdf(mp, wo_local, u2, u1, active=cfg.bsdf_types)
        wi_world = it.frame.to_world(bs.wi)
        _, pdf_rev = bsdf_mod.eval_bsdf(mp, bs.wi, wo_local, active=cfg.bsdf_types)
        d_vcm, d_vc = _continue_mis(bs, pdf_rev, d_vcm, d_vc)
        cont = found & (bs.pdf > 0)
        c3 = cont[..., None]
        o = torch.where(c3, _offset_ray(it.p, it.n_geo, wi_world, cfg.ray_eps), o)
        d = torch.where(c3, wi_world, d)
        w = torch.where(c3, w * bs.weight, w)
        alive = cont
        smp = s

    eye = torch.nan_to_num(L * w_cam, nan=0.0, posinf=0.0, neginf=0.0)
    img = eye.reshape(spp, n_px, 3).sum(0) / spp + splat_film
    return img.reshape(height, width, 3), rays_total


@torch.no_grad()
def render_bdpt(scene: Scene, width: int, height: int, spp: int, seed,
                config: BDPTConfig = BDPTConfig()):
    """One BDPT pass on the scene's device (one light path per eye sample):
    (H, W, 3)."""
    return render_bdpt_counted(scene, width, height, spp, seed, config)[0]


@torch.no_grad()
def render_bdpt_counted(scene: Scene, width: int, height: int, spp: int, seed,
                        config: BDPTConfig = BDPTConfig()):
    """(image, rays traced): alive light and eye subpath lanes plus every
    shadow ray cast (t=1 splats, NEE, vertex connections), an int64 tensor
    (the reference's traced-ray counter, Kernel/TraceHelper.h:52-53)."""
    base = specialize_config(scene, config.base)
    return _bdpt_impl(scene, width, height, spp, seed, config._replace(base=base))
