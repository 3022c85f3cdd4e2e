"""Vertex Connection and Merging (port of cudatracerlib_tpu/render/vcm.py:37-430).

Light subpaths are stored and both connected (the BDPT strategies of
render/bdpt.py) and merged against camera subpaths, with the full recursive
MIS triple dVCM / dVC / dVM (Georgiev's SmallVCM formulation). The light
vertices of a pass go into the sort-based hash grid (accel/hashgrid.py),
and merging gathers at most `max_gather` of them within the progressive
radius of each eye vertex (`hashgrid.query_sphere`, the JAX package's
capped lookup on every device). The t=1 splats are summed by the
deterministic splat film.

The streams (seed ^ 0x7C77 for the light paths, the seed for the eye
paths), the draw order and the flat=False frames are the JAX package's, so
the CPU port traces the JAX package's paths lane for lane. Forward only:
the entry point runs under `torch.no_grad()`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..accel import hashgrid
from ..math.vecmath import PI, dot
from ..sampling.rng import MASK, Sampler
from ..scene import bsdf as bsdf_mod
from ..scene import scene as scene_mod
from ..scene.scene import Scene
from ..scene.shade_pack import build_shade_pack, hit_shading, pack_enabled
from .bdpt import (SPECULAR_LOBES, _camera_pdf_w, camera_splats, connect, emission_mis,
                   eye_rays, light_start_mis, nee_mis, vertex_shading)
from .light_tracer import emit_particles
from .path_tracer import PTConfig, _offset_ray, specialize_config
from .ppm import progressive_radius


class VCMConfig(NamedTuple):
    base: PTConfig = PTConfig(max_depth=5, rr_start=99)
    s_max: int = 4
    radius0: float = 0.05
    max_gather: int = 32
    grid_res: int = 64


class _LV(NamedTuple):
    """Stored light vertex with the VCM MIS triple."""

    p: torch.Tensor
    n: torch.Tensor
    wo: torch.Tensor
    thr: torch.Tensor
    d_vcm: torch.Tensor
    d_vc: torch.Tensor
    d_vm: torch.Tensor
    prim: torch.Tensor
    uv: torch.Tensor
    valid: torch.Tensor


def _continue_vcm(bs, pdf_rev, d_vcm, d_vc, d_vm, mis_vc, mis_vm):
    """dVCM, dVC, dVM after sampling the BSDF at a vertex."""
    cos_out = torch.clamp(bs.wi[..., 2].abs(), min=1e-6)
    is_spec = (bs.sampled_type & SPECULAR_LOBES) > 0
    p_fwd = torch.clamp(bs.pdf, min=1e-20)
    new_d_vc = torch.where(is_spec, (cos_out / p_fwd) * d_vc * pdf_rev,
                           (cos_out / p_fwd) * (d_vc * pdf_rev + d_vcm + mis_vm))
    new_d_vm = torch.where(is_spec, (cos_out / p_fwd) * d_vm * pdf_rev,
                           (cos_out / p_fwd) * (d_vm * pdf_rev + d_vcm * mis_vc + 1.0))
    return torch.where(is_spec, 0.0, 1.0 / p_fwd), new_d_vc, new_d_vm


def _light_walk(scene: Scene, B: int, seed, cfg: PTConfig, s_max: int, mis_vc, mis_vm, pack):
    """s_max per-depth batches of stored light vertices."""
    dev = scene.light_cdf.device
    smp = Sampler.create((int(seed) & MASK) ^ 0x7C77, torch.arange(B, device=dev), 2)
    o, d, w, lsel, lpmf, smp = emit_particles(scene, B, smp, cfg)
    d_vcm, d_vc = light_start_mis(scene, d, lsel, lpmf)
    d_vm = d_vc * mis_vc
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    verts = []
    for _ in range(s_max):
        hit = scene_mod.scene_intersect(scene, o, d)
        it, mp = hit_shading(scene, o, d, hit, pack, cfg.tex_types)
        found = hit.valid & alive

        cos_in = torch.clamp(dot(it.frame.n, -d).abs(), min=1e-6)
        d_vcm = d_vcm * torch.clamp(it.t * it.t, min=1e-12) / cos_in
        d_vc = d_vc / cos_in
        d_vm = d_vm / cos_in
        verts.append(_LV(p=it.p, n=it.frame.n, wo=-d, thr=w, d_vcm=d_vcm, d_vc=d_vc,
                         d_vm=d_vm, prim=it.prim, uv=it.uv,
                         valid=found & bsdf_mod.is_smooth(mp)))

        s, u2 = smp.next_2d()
        s, u1 = s.next_1d()
        wo_local = it.frame.to_local(-d)
        bs = bsdf_mod.sample_bsdf(mp, wo_local, u2, u1, active=cfg.bsdf_types)
        wi_world = it.frame.to_world(bs.wi)
        _, pdf_rev = bsdf_mod.eval_bsdf(mp, bs.wi, wo_local, active=cfg.bsdf_types)
        d_vcm, d_vc, d_vm = _continue_vcm(bs, pdf_rev, d_vcm, d_vc, d_vm, mis_vc, mis_vm)
        cont = found & (bs.pdf > 0)
        c3 = cont[..., None]
        o = torch.where(c3, _offset_ray(it.p, it.n_geo, wi_world, cfg.ray_eps), o)
        d = torch.where(c3, wi_world, d)
        w = torch.where(c3, w * bs.weight, w)
        alive = cont
        smp = s
    return verts


def _merge(it, mp, wo_local, found, grid, lv_flat, radius, r2, d_vcm, d_vm, mis_vc, B,
           cfg: PTConfig, max_gather: int):
    """Vertex merging at the eye vertices: the capped gather of stored light
    vertices within `radius`, each weighted by the raw BSDF, its throughput
    and its MIS weight, over pi r^2 B. Returns (B, 3) per unit eye
    throughput."""
    idx, valid_n = hashgrid.query_sphere(grid, it.p, radius, max_gather)
    ph = _LV(*(a[idx] for a in lv_flat))
    diff = ph.p - it.p[:, None, :]
    d2 = dot(diff, diff)
    use = (valid_n & ph.valid & found[:, None] & (d2 < r2)
           & (dot(ph.n, it.frame.n[:, None, :]) > 0.5))
    fs, ft, fn = (x[:, None, :] for x in it.frame)
    wi_ph = torch.stack([dot(ph.wo, fs), dot(ph.wo, ft), dot(ph.wo, fn)], dim=-1)
    mp_b = bsdf_mod.MatParams(*(a[:, None] for a in mp))
    wo_b = wo_local[:, None, :].expand(wi_ph.shape)
    f_m, pdf_m_fwd = bsdf_mod.eval_bsdf(mp_b, wo_b, wi_ph, active=cfg.bsdf_types)
    _, pdf_m_rev = bsdf_mod.eval_bsdf(mp_b, wi_ph, wo_b, active=cfg.bsdf_types)
    cos_ph = torch.clamp(wi_ph[..., 2].abs(), min=1e-6)
    f_m_raw = f_m / cos_ph[..., None]
    w_light = ph.d_vcm * mis_vc + ph.d_vm * pdf_m_fwd
    w_cam = d_vcm[:, None] * mis_vc + d_vm[:, None] * pdf_m_rev
    mis_m = 1.0 / (w_light + 1.0 + w_cam)
    # thr_cam * sum_k(f_raw * thr_ph * mis) / (pi r^2 N)
    merged = torch.where(use[..., None], f_m_raw * ph.thr * mis_m[..., None], 0.0).sum(1)
    return merged / max(np.float32(PI) * r2 * np.float32(B), np.float32(1e-9))


def _vcm_impl(scene: Scene, width: int, height: int, spp: int, seed, radius,
              config: VCMConfig):
    cfg = config.base
    dev = scene.light_cdf.device
    pack = build_shade_pack(scene) if pack_enabled(scene) else None
    n_px = width * height
    B = n_px * spp
    radius = np.float32(radius)
    r2 = radius * radius
    eta_vcm = np.float32(PI) * r2 * np.float32(B)
    mis_vc = np.float32(1.0) / max(eta_vcm, np.float32(1e-12))
    mis_vm = eta_vcm

    lverts = _light_walk(scene, B, seed, cfg, config.s_max, float(mis_vc), float(mis_vm), pack)
    lv_flat = _LV(*(torch.cat(x) for x in zip(*lverts)))
    grid = hashgrid.build_grid(lv_flat.p, scene.bvh.world_min - 1e-3,
                               scene.bvh.world_max + 1e-3, res=config.grid_res,
                               valid=lv_flat.valid)
    shading = [vertex_shading(scene, lv, cfg, pack) for lv in lverts]
    splat_film, _ = camera_splats(scene, lverts, shading, B, width, height, cfg,
                                  mis_vm=float(mis_vm))

    # ---- eye walk: s = 0, s = 1, connections and merging ----
    o, d, w_cam, smp = eye_rays(scene, width, height, spp, seed)
    w = torch.ones(B, 3, device=dev)
    L = torch.zeros(B, 3, device=dev)
    d_vcm = B / torch.clamp(_camera_pdf_w(scene.camera, d, height), min=1e-9)
    d_vc = torch.zeros(B, device=dev)
    d_vm = torch.zeros(B, device=dev)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    for depth in range(cfg.max_depth):
        hit = scene_mod.scene_intersect(scene, o, d)
        it, mp = hit_shading(scene, o, d, hit, pack, cfg.tex_types)
        found = hit.valid & alive

        cos_in = torch.clamp(dot(it.frame.n, -d).abs(), min=1e-6)
        d_vcm = d_vcm * torch.clamp(it.t * it.t, min=1e-12) / cos_in
        d_vc = d_vc / cos_in
        d_vm = d_vm / cos_in
        wo_local = it.frame.to_local(-d)

        Le, mis0, emissive = emission_mis(scene, it, d, found, d_vcm, d_vc, depth)
        L = L + torch.where(emissive[..., None], w * Le * mis0[..., None], 0.0)

        s, u_sel = smp.next_1d()
        s, u_l2 = s.next_2d()
        if scene.n_lights > 0:
            contrib, ok = nee_mis(scene, it, mp, w, wo_local, u_sel, u_l2, d_vcm, d_vc, cfg,
                                  mis_vm=float(mis_vm))
            L = L + torch.where((found & ok)[..., None], contrib, 0.0)

        for lv, (it_l, mp_l) in zip(lverts, shading):
            contrib, ok = connect(scene, it, mp, w, wo_local, lv, it_l, mp_l, d_vcm, d_vc, cfg,
                                  mis_vm=float(mis_vm))
            L = L + torch.where((found & lv.valid & ok)[..., None], contrib, 0.0)

        L = L + w * _merge(it, mp, wo_local, found, grid, lv_flat, radius, float(r2), d_vcm,
                           d_vm, float(mis_vc), B, cfg, config.max_gather)

        # ---- continue ----
        s, u2 = s.next_2d()
        s, u1 = s.next_1d()
        bs = bsdf_mod.sample_bsdf(mp, wo_local, u2, u1, active=cfg.bsdf_types)
        wi_world = it.frame.to_world(bs.wi)
        _, pdf_rev = bsdf_mod.eval_bsdf(mp, bs.wi, wo_local, active=cfg.bsdf_types)
        d_vcm, d_vc, d_vm = _continue_vcm(bs, pdf_rev, d_vcm, d_vc, d_vm, float(mis_vc),
                                          float(mis_vm))
        cont = found & (bs.pdf > 0)
        c3 = cont[..., None]
        o = torch.where(c3, _offset_ray(it.p, it.n_geo, wi_world, cfg.ray_eps), o)
        d = torch.where(c3, wi_world, d)
        w = torch.where(c3, w * bs.weight, w)
        alive = cont
        smp = s

    eye = torch.nan_to_num(L * w_cam, nan=0.0, posinf=0.0, neginf=0.0)
    return (eye.reshape(spp, n_px, 3).sum(0) / spp + splat_film).reshape(height, width, 3)


@torch.no_grad()
def render_vcm(scene: Scene, width: int, height: int, spp: int, seed, pass_idx=0,
               config: VCMConfig = VCMConfig()):
    """One VCM pass on the scene's device (average passes with increasing
    pass_idx to converge: the merging radius shrinks with it). All
    strategies: s >= 0 connections, t = 1 splats and merging."""
    base = specialize_config(scene, config.base)
    extent = float(np.min(np.asarray(scene.bvh.world_max) - np.asarray(scene.bvh.world_min))) + 2e-3
    res = max(4, min(config.grid_res, int(extent / max(config.radius0, 1e-6))))
    config = config._replace(base=base, grid_res=res)
    radius = progressive_radius(config.radius0, pass_idx)
    return _vcm_impl(scene, width, height, spp, seed, radius, config)
