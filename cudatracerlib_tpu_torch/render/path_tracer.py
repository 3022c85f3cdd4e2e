"""Unidirectional path tracer with next-event estimation and MIS
(port of cudatracerlib_tpu/render/path_tracer.py:34-154, 351-824).

The JAX bounce `lax.scan` becomes a Python loop over a SoA ray batch with
alive masks; the film is the box-filter reshape-sum. `surface_bounce` is
shared with the wavefront engine (render/wavefront.py).

`render` is differentiable, as the JAX package's is under `jax.grad`: with a
scene tensor that requires grad, autograd records the render, and its
backward gives gradients with respect to materials, textures, lights, the
camera and the Woop rows. Sampling is detached exactly where the JAX package
stops gradients (the BSDF samplers, the NEE light pdf and selection pmf, the
Russian-roulette probability), and hit tangents come from
`traversal.refine_hit`. `PTConfig.remat` recomputes each bounce in the
backward (`torch.utils.checkpoint`) instead of keeping its intermediates:
the sampler is counter-based, so the recompute is exact. With no tensor that
requires grad nothing is recorded; `render_counted` and
`render_progressive` run without gradients.

Ported: every BSDF tag (the nested COATING / ROUGHCOATING / BLEND through
`bsdf.eval_bsdf_nested` / `sample_bsdf_nested`), light type and texture
type, image textures MIP-filtered by the ray cone (`sensors.pixel_spread`
and each path's length), normal, height and parallax maps and the alpha
test (`scene.apply_material_maps`, `scene.alpha_test`), the subsurface
random walk (`_sss_walk`, `PTConfig.sss_steps`), all five camera models,
with or without NEE, path-space regularization (`_regularize`),
filter-importance splatting (`rec_filter` 1-4,
`image/film.add_samples_filtered`) and the fused shade-pack path on the
card. Media in `render` (`media_modes`) raise NotImplementedError:
render/volpath.py renders media.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..image import film as film_mod
from ..math import fresnel as fres
from ..math import montecarlo as mc
from ..math.vecmath import dot, normalize, reflect, refract
from ..ops.shade_gather import gather_rows, packed_gather
from ..sampling.records import DISCRETE
from ..sampling.rng import MASK, Sampler
from ..scene import bsdf as bsdf_mod
from ..scene import instances as inst_mod
from ..scene import lights as lights_mod
from ..scene import phase as phase_mod
from ..scene import sensors
from ..scene import shade_pack as sp_mod
from ..scene import textures as tex_mod
from ..scene import scene as scene_mod
from ..scene.scene import Scene, gather_mat_params, gather_nested_params, make_interaction
from ..utils.timing import span, spanned

RAY_EPS = 1e-3


class PTConfig(NamedTuple):
    max_depth: int = 6
    rr_start: int = 5
    direct: bool = True          # NEE on/off
    ray_eps: float = RAY_EPS
    # path-space regularization: after the first bounce, delta BSDFs are
    # mollified into rough lobes of this alpha (0 = off)
    regularization: float = 0.0
    # scene-static specialization (filled by specialize_config)
    bsdf_types: tuple | None = None
    light_types: tuple | None = None
    tex_types: tuple | None = None
    flat_shading: bool = False
    normal_maps: bool = False
    height_maps: bool = False
    parallax: bool = False
    alpha_test: bool = False
    remat: bool = False          # recompute each bounce in the backward
    # reconstruction filter at accumulation: 0 = box (the reshape-sum film),
    # 1 gaussian, 2 mitchell, 3 lanczos, 4 triangle (filter-importance splats)
    rec_filter: int = 0
    rec_radius: float = 1.5
    media_modes: tuple | None = None
    sss: bool = False            # the subsurface random walk (set from the scene)
    sss_steps: int = 16          # the walk's steps (truncation ~ albedo^N)


def _check_ported(config: PTConfig) -> None:
    if config.media_modes is not None:
        raise NotImplementedError("PTConfig.media_modes: render/volpath.py renders media")
    if config.rec_filter not in range(5):
        raise NotImplementedError(f"rec_filter {config.rec_filter}: the filters are 0 (box) "
                                  f"to 4 (triangle)")
    bsdf_mod.check_ported(config.bsdf_types)
    lights_mod.check_ported(config.light_types)
    tex_mod.check_ported(config.tex_types)


def _regularized_types(bsdf_types: tuple) -> tuple:
    """The type set under regularization: mollified delta lobes add the
    rough families they become."""
    mapped = set(bsdf_types)
    if bsdf_mod.CONDUCTOR in mapped:
        mapped.add(bsdf_mod.ROUGHCONDUCTOR)
    if bsdf_mod.DIELECTRIC in mapped or bsdf_mod.THINDIELECTRIC in mapped:
        mapped.add(bsdf_mod.ROUGHDIELECTRIC)
    return tuple(sorted(mapped))


def specialize_config(scene: Scene, config: PTConfig) -> PTConfig:
    """Fill the static type sets and flags from the scene (host side): from
    the specialization `build_scene` kept on the scene, or else from the
    scene's arrays; with `regularization`, the rough families the delta
    lobes become join the BSDF set. Raises NotImplementedError for what is
    not ported."""
    if config.bsdf_types is None:
        config = config._replace(**scene_mod.scene_spec(scene))
        if config.regularization > 0.0:
            config = config._replace(bsdf_types=_regularized_types(config.bsdf_types))
    _check_ported(config)
    return config


def _select_light(scene: Scene, u):
    """Power-CDF light selection with sample reuse. A single-light scene
    uses the scalar index 0, so per-lane light lookups become broadcasts."""
    if scene.light_cdf.shape[0] == 1:
        return 0, torch.ones_like(u), u
    return mc.sample_discrete(scene.light_cdf, u)


def _light_select_pmf(scene: Scene, lid, like):
    if scene.light_cdf.shape[0] == 1:
        return torch.ones_like(like)
    cdf = scene.light_cdf
    hi = cdf[lid]
    lo = torch.where(lid > 0, cdf[torch.clamp(lid - 1, min=0)], 0.0)
    return torch.clamp(hi - lo, min=0.0)


# ---- the bounce's light terms, shared by every engine that weights them with MIS ----

def has_env(config: PTConfig) -> bool:
    """The scene's specialization holds an environment light."""
    return bool({lights_mod.INFINITE, lights_mod.CONSTANT_ENV} & set(config.light_types))


def _has_delta(config: PTConfig) -> bool:
    return bool(set(lights_mod.DELTA) & set(config.light_types))


def env_term(scene: Scene, d, prev_pdf, no_mis):
    """(environment radiance (B, 3), its MIS weight) along d."""
    env_id = torch.clamp(scene.env_light_id, min=0).long()
    env_L = lights_mod.eval_env(scene.lights, env_id, d)
    pdf_l = lights_mod.pdf_env_dir(scene.lights, env_id, d) * _light_select_pmf(scene, env_id,
                                                                                prev_pdf)
    return env_L, torch.where(no_mis, 1.0, mc.mis_weight(prev_pdf, pdf_l))


def emission_term(scene: Scene, it, o, d, prev_pdf, no_mis):
    """(material light id (B,), emitted radiance (B, 3), its MIS weight)."""
    mat_light = scene.materials.light_id[it.mat_id.long()]
    lid = 0 if scene.n_lights == 1 else torch.clamp(mat_light, min=0).long()
    Le = lights_mod.eval_area_emission(scene.lights, lid, it.n_geo, -d)
    pdf_hit = (lights_mod.pdf_direct_area(scene.lights, lid, o, it.p, it.n_geo)
               * _light_select_pmf(scene, lid, prev_pdf))
    return mat_light, Le, torch.where(no_mis, 1.0, mc.mis_weight(prev_pdf, pdf_hit))


def nee_light_sample(scene: Scene, config: PTConfig, p, u_sel, u_l2):
    """The NEE light sample: (DirectSample, radiance, light pdf, selection
    pmf). The pdf is the solid-angle pdf times the pmf, the pmf alone for a
    delta light (DISCRETE measure, pdf 1); both are detached (JAX
    path_tracer.py:491-492)."""
    lsel, lpmf, _ = _select_light(scene, u_sel)
    ds, Lrad = lights_mod.sample_direct(scene.lights, lsel, p, u_l2, active=config.light_types)
    lpmf = lpmf.detach()
    pdf_l = ds.pdf.detach() * lpmf
    if _has_delta(config):
        pdf_l = torch.where(ds.measure == DISCRETE, lpmf, pdf_l)
    return ds, Lrad, pdf_l, lpmf


def nee_weight(config: PTConfig, ds, pdf_l, pdf_fwd):
    """The NEE estimate's factor w / pdf_l (B,): w the MIS weight against
    the forward pdf, 1 for a delta light."""
    w = mc.mis_weight(pdf_l, pdf_fwd)
    if _has_delta(config):
        w = torch.where(ds.measure == DISCRETE, 1.0, w)
    return w / torch.clamp(pdf_l, min=1e-12)


def _regularize(mp: bsdf_mod.MatParams, depth, alpha: float) -> bsdf_mod.MatParams:
    """Mollify delta lobes into rough microfacet lobes of roughness `alpha`
    after the first bounce (path-space regularization): CONDUCTOR becomes
    ROUGHCONDUCTOR, DIELECTRIC and THINDIELECTRIC ROUGHDIELECTRIC. `depth`
    is an int or a per-lane tensor."""
    t = mp.bsdf_type
    mollify = depth > 0
    new_t = torch.where(mollify & (t == bsdf_mod.CONDUCTOR), bsdf_mod.ROUGHCONDUCTOR, t)
    new_t = torch.where(mollify & ((t == bsdf_mod.DIELECTRIC) | (t == bsdf_mod.THINDIELECTRIC)),
                        bsdf_mod.ROUGHDIELECTRIC, new_t).to(t.dtype)
    was_delta = new_t != t
    return mp._replace(bsdf_type=new_t, alpha_u=torch.where(was_delta, alpha, mp.alpha_u),
                       alpha_v=torch.where(was_delta, alpha, mp.alpha_v))


def texture_cone(scene: Scene, width: int, height: int, config: PTConfig):
    """The per-pixel ray cone (`sensors.pixel_spread`) when the scene has
    IMAGE textures to filter with it, else None (no path length carried)."""
    if tex_mod.IMAGE in config.tex_types:
        return sensors.pixel_spread(scene.camera, width, height)
    return None


def _offset_ray(p, n_geo, w, eps):
    """Offset the origin along the geometric normal on w's side."""
    s = torch.sign(dot(n_geo, w, keepdims=True))
    return p + n_geo * s * eps


def _sss_walk(scene: Scene, config: PTConfig, *, entered, p0, d0, n_entry, mat_id,
              sampler: Sampler):
    """Random-walk subsurface transport (Engine/Material.h:66 GetBSSRDF and
    Kernel/ParticleProcess.h's SSS handling).

    A lane that refracted into an sss material walks its homogeneous
    interior: distances are sampled against the channel-mean sigma_t (its
    pdf detached; per-channel weights keep the estimator exact and
    differentiable in the sigmas), HG phase at each scatter, and a boundary
    hit either refracts out through the dielectric interface or reflects
    back inside by Fresnel. `config.sss_steps` steps, each one closest-hit
    trace of every lane; lanes still inside after the last step end.

    Returns (exited, exit_o, exit_d, weight (B, 3), sampler, rays traced)."""
    B = p0.shape[0]
    m = scene.materials
    mid = mat_id.long()
    sig_s = gather_rows(m.sss_sigma_s, mid)
    sig_a = gather_rows(m.sss_sigma_a, mid)
    sig_t = sig_s + sig_a
    hg = gather_rows(m.sss_g, mid)
    eta_mat = gather_rows(m.eta, mid)
    sig_mean = torch.clamp((sig_t[..., 0] + sig_t[..., 1] + sig_t[..., 2]) / 3.0,
                           min=1e-6).detach()
    hg_type = torch.full((B,), phase_mod.HG, dtype=torch.int32, device=p0.device)
    eps = config.ray_eps

    pos, dirn = p0 - n_entry * eps, d0      # start just inside the surface
    w = torch.ones(B, 3, device=p0.device)
    inside = entered
    exited = torch.zeros(B, dtype=torch.bool, device=p0.device)
    exit_o, exit_d = p0, d0
    s = sampler
    n_rays = torch.zeros((), dtype=torch.int64, device=p0.device)
    for _ in range(config.sss_steps):
        s, u_t = s.next_1d()
        t_s = -torch.log(torch.clamp(1.0 - u_t, min=1e-12)) / sig_mean
        hit = scene_mod.scene_intersect(scene, pos, dirn, eps, t_s)
        hit_bound = inside & hit.valid
        scat = inside & ~hit.valid

        # ---- scatter event: per-channel weight over the mean-sigma pdf ----
        tr_c = torch.exp(-sig_t * t_s[..., None])
        pdf_sc = (sig_mean * torch.exp(-sig_mean * t_s)).detach()[..., None]
        w_sc = sig_s * tr_c / torch.clamp(pdf_sc, min=1e-20)
        s, u_ph = s.next_2d()
        ps = phase_mod.sample_phase(hg_type, hg, -dirn, u_ph)
        p_sc = pos + dirn * t_s[..., None]

        # ---- boundary event: pass weight, Fresnel exit or TIR ----
        t_b = torch.where(hit.valid, hit.t, 1.0)
        tr_b = torch.exp(-sig_t * t_b[..., None])
        pdf_b = torch.exp(-sig_mean * t_b).detach()[..., None]
        w_b = tr_b / torch.clamp(pdf_b, min=1e-20)
        if scene.instances:
            # the packed prim decoded to its shading row (as make_interaction
            # does), the object-space face normal mapped to world space
            inst_id, _, row = inst_mod.decode_hit(scene.instances,
                                                  inst_mod.instance_tpad(scene.blas), hit)
            to_obj = inst_mod.flat_instance_arrays(scene.instances)[0]
            nf = normalize(torch.einsum("...ij,...i->...j", to_obj[inst_id][..., :, :3],
                                        gather_rows(scene.shading.n_face, row)))
        else:
            nf = gather_rows(scene.shading.n_face, torch.clamp(hit.prim, min=0).long())
        n_out = nf * torch.sign(dot(nf, dirn, keepdims=True))  # points along the exit
        p_b = pos + dirn * t_b[..., None]
        wo = -dirn
        F, cos_t, _, eta_ti = fres.fresnel_dielectric(dot(wo, n_out), eta_mat)
        s, u_f = s.next_1d()
        do_exit = hit_bound & (u_f >= F)          # transmit out
        tir = hit_bound & ~do_exit                # reflect back inside
        d_refr = refract(wo, n_out, eta_ti, cos_t)
        d_refl = reflect(wo, n_out)
        # radiance compression leaving the dense medium
        w_exit = (w_b * (eta_ti * eta_ti)[..., None]
                  * ((1.0 - F) / torch.clamp((1.0 - F).detach(), min=1e-12))[..., None])
        w_tir = w_b * (F / torch.clamp(F.detach(), min=1e-12))[..., None]

        n_rays = n_rays + inside.sum()
        scat3, tir3, exit3 = scat[..., None], tir[..., None], do_exit[..., None]
        pos = torch.where(scat3, p_sc, torch.where(tir3, p_b - dirn * eps, pos))
        new_dir = torch.where(scat3, ps.wi, torch.where(tir3, d_refl, dirn))
        w = torch.where(scat3, w * w_sc * ps.weight[..., None],
                        torch.where(tir3, w * w_tir, torch.where(exit3, w * w_exit, w)))
        exit_o = torch.where(exit3, p_b + n_out * eps, exit_o)
        exit_d = torch.where(exit3, d_refr, exit_d)
        dirn = new_dir
        inside = scat | tir
        exited = exited | do_exit
    return exited, exit_o, exit_d, w, s, n_rays


class BounceOut(NamedTuple):
    """Result of one surface bounce (see surface_bounce)."""
    o: torch.Tensor           # next ray origin
    d: torch.Tensor           # next ray direction
    throughput: torch.Tensor  # updated path throughput (RR-compensated)
    L_add: torch.Tensor       # radiance added this bounce (env, emission, NEE)
    cont: torch.Tensor        # path continues
    bs_pdf: torch.Tensor      # solid-angle pdf of the sampled direction
    delta_now: torch.Tensor   # sampled lobe was delta (suppress next MIS)
    eta_scale: torch.Tensor   # updated accumulated eta^2
    path_len: torch.Tensor    # updated path length (the ray cone's footprint)
    sampler: Sampler
    n_rays: torch.Tensor      # rays traced this bounce (int64 scalar)
    n_nonfinite: torch.Tensor  # lanes whose L or throughput went non-finite


def surface_bounce(scene: Scene, config: PTConfig, *, o, d, active, throughput,
                   prev_pdf, prev_delta, eta_scale, sampler: Sampler, depth,
                   path_len=None, cone=None, pack=None) -> BounceOut:
    """One surface-path bounce: intersect -> material maps and the alpha
    test -> environment on escape and area-light emission, each with MIS ->
    NEE -> BSDF sample -> Russian roulette -> the subsurface walk.
    `config` must be specialized; `depth` is an int (megakernel) or a
    per-lane tensor (wavefront pool).

    `cone`: the (r0, slope) ray cone of `sensors.pixel_spread` or None; with
    it and an IMAGE texture in the scene, image lookups are trilinear at the
    footprint (r0 + slope * path length) * the triangle's uv density, and
    the bounce returns the path length through this hit. `path_len`: each
    lane's path length so far (None: zeros).
    `pack`: the (Tp, 64) shade pack (scene/shade_pack.py) or None; with it
    the interaction and material parameters come from one packed gather.
    An alpha-tested-away hit passes the ray on unchanged from behind the
    surface, at the cost of a bounce."""
    B = o.shape[0]
    s = sampler
    if path_len is None:
        path_len = torch.zeros(B, device=o.device)
    filter_textures = cone is not None and tex_mod.IMAGE in config.tex_types
    hit = scene_mod.scene_intersect(scene, o, d)
    if pack is not None:
        rows = packed_gather(pack, torch.clamp(hit.prim, min=0))
        it = sp_mod.pack_interaction(rows, o, d, hit, flat=config.flat_shading)
    else:
        rows = None
        it = make_interaction(scene, o, d, hit, flat=config.flat_shading)
    found_any = hit.valid & active
    wo_world = -d
    if config.normal_maps or config.height_maps:
        it = scene_mod.apply_material_maps(scene, it, wo_world, config.tex_types,
                                           use_normal=config.normal_maps,
                                           use_height=config.height_maps,
                                           use_parallax=config.parallax)
    if config.alpha_test:
        passthru = found_any & ~scene_mod.alpha_test(scene, it, config.tex_types)
        found = found_any & ~passthru
    else:
        passthru = None
        found = found_any
    if filter_textures:
        r0, slope = cone
        path_t = path_len + torch.where(found_any, hit.t, 0.0)
        density = (rows[:, sp_mod.UV_DENSITY] if rows is not None
                   else gather_rows(scene.shading.uv_density, it.prim))
        uv_width = (r0 + slope * path_t) * density
    else:
        path_t, uv_width = path_len, None
    if rows is not None:
        mp = sp_mod.pack_mat_params(scene, rows, it.uv, config.tex_types, uv_width)
    else:
        mp = gather_mat_params(scene, it, config.tex_types, uv_width)
    nested = any(x in config.bsdf_types for x in bsdf_mod.NESTED)
    mp_in = gather_nested_params(scene, it, config.tex_types, uv_width) if nested else None
    if config.regularization > 0.0:
        mp = _regularize(mp, depth, config.regularization)
    L = torch.zeros(B, 3, device=o.device)
    no_mis = prev_delta if config.direct else torch.ones_like(prev_delta)

    # ---- environment on escape (PathTracer.cu:98-111) ----
    if has_env(config):
        env_L, w_env = env_term(scene, d, prev_pdf, no_mis)
        escaped = active & ~hit.valid & (scene.env_light_id >= 0)
        L = L + torch.where(escaped[..., None], throughput * env_L * w_env[..., None], 0.0)

    # ---- emission at the hit (MIS against NEE) ----
    if lights_mod.AREA_LIGHT in config.light_types:
        mat_light, Le, w_hit = emission_term(scene, it, o, d, prev_pdf, no_mis)
        emissive = found & (mat_light >= 0)
        L = L + torch.where(emissive[..., None], throughput * Le * w_hit[..., None], 0.0)

    wo_local = it.frame.to_local(wo_world)

    # ---- next-event estimation ----
    s, u_sel = s.next_1d()
    s, u_l2 = s.next_2d()
    if config.direct and scene.n_lights > 0:
        ds, Lrad, pdf_l, lpmf = nee_light_sample(scene, config, it.p, u_sel, u_l2)
        wi_l = it.frame.to_local(ds.d)
        if nested:
            f_l, pdf_b_l = bsdf_mod.eval_bsdf_nested(mp, mp_in, wo_local, wi_l,
                                                     active=config.bsdf_types)
        else:
            f_l, pdf_b_l = bsdf_mod.eval_bsdf(mp, wo_local, wi_l, active=config.bsdf_types)
        sh_o = _offset_ray(it.p, it.n_geo, ds.d, config.ray_eps)
        blocked = scene_mod.scene_occluded(scene, sh_o, ds.d, t_min=config.ray_eps,
                                           t_max=ds.dist - 2.0 * config.ray_eps)
        contrib = throughput * f_l * Lrad * nee_weight(config, ds, pdf_l, pdf_b_l)[..., None]
        nee_ok = found & ~blocked & (ds.pdf > 0) & (lpmf > 0)
        L = L + torch.where(nee_ok[..., None], contrib, 0.0)
        n_shadow = found.sum()
    else:
        n_shadow = torch.zeros((), dtype=torch.int64, device=o.device)

    # ---- BSDF sampling ----
    s, u_b2 = s.next_2d()
    s, u_b1 = s.next_1d()
    if nested:
        bs = bsdf_mod.sample_bsdf_nested(mp, mp_in, wo_local, u_b2, u_b1,
                                         active=config.bsdf_types)
    else:
        bs = bsdf_mod.sample_bsdf(mp, wo_local, u_b2, u_b1, active=config.bsdf_types)
    wi_world = it.frame.to_world(bs.wi)
    new_o = _offset_ray(it.p, it.n_geo, wi_world, config.ray_eps)
    new_tp = throughput * bs.weight
    cont = found & (bs.pdf > 0) & (new_tp.abs().amax(-1) > 0)

    # ---- Russian roulette ----
    s, u_rr = s.next_1d()
    p_cont = mc.russian_roulette_prob(new_tp.amax(-1) * eta_scale, depth,
                                      config.rr_start).detach()
    new_tp = new_tp / torch.clamp(p_cont, min=1e-6)[..., None]
    cont = cont & (u_rr < p_cont)

    delta_now = bsdf_mod.is_delta(mp) | ((bs.sampled_type & (16 | 32 | 64)) > 0)
    n_rays = active.sum() + n_shadow
    if config.sss:
        # ---- BSSRDF: a refraction into an sss material starts the interior
        # walk, and the path resumes from its exit point and direction ----
        sss_mask = scene.materials.sss[it.mat_id.long()] > 0
        entering = (cont & sss_mask & ((bs.sampled_type & (32 | 8)) > 0)
                    & (dot(wi_world, it.n_geo) * dot(wo_world, it.n_geo) < 0.0))
        n_out_entry = it.n_geo * torch.sign(dot(it.n_geo, wo_world, keepdims=True))
        ex, ex_o, ex_d, w_sss, s, n_sss = _sss_walk(
            scene, config, entered=entering, p0=it.p, d0=wi_world, n_entry=n_out_entry,
            mat_id=it.mat_id, sampler=s)
        e3 = entering[..., None]
        new_o = torch.where(e3, ex_o, new_o)
        wi_world = torch.where(e3, ex_d, wi_world)
        new_tp = torch.where(e3, new_tp * w_sss, new_tp)
        cont = torch.where(entering, ex, cont)
        delta_now = delta_now | entering
        n_rays = n_rays + n_sss
    eta_next = eta_scale * bs.eta * bs.eta
    bs_pdf = bs.pdf
    if passthru is not None:
        # alpha pass-through: the unchanged ray goes on from behind the
        # surface with its throughput and MIS state untouched
        p3 = passthru[..., None]
        new_o = torch.where(p3, it.p + d * config.ray_eps, new_o)
        wi_world = torch.where(p3, d, wi_world)
        new_tp = torch.where(p3, throughput, new_tp)
        cont = cont | passthru
        bs_pdf = torch.where(passthru, prev_pdf, bs_pdf)
        delta_now = torch.where(passthru, prev_delta, delta_now)
        eta_next = torch.where(passthru, eta_scale, eta_next)
    bad = active & (~torch.isfinite(L).all(-1)
                    | (cont & ~torch.isfinite(new_tp).all(-1)))
    return BounceOut(
        o=new_o, d=wi_world, throughput=new_tp, L_add=L, cont=cont,
        bs_pdf=bs_pdf, delta_now=delta_now, eta_scale=eta_next, path_len=path_t,
        sampler=s, n_rays=n_rays,
        n_nonfinite=bad.sum(),
    )


def trace_radiance(scene: Scene, o, d, sampler: Sampler, config: PTConfig, cone=None,
                   with_stats: bool = False):
    """Radiance along a batch of rays. Returns (L (B, 3), sampler), plus with
    `with_stats` the rays traced (alive closest-hit lanes plus NEE shadow
    rays and the subsurface walk's rays, summed over bounces) and the
    non-finite lane count. `cone`: the per-pixel ray cone
    (`sensors.pixel_spread`) that MIP-filters image textures, or None (then
    no path length is carried). The
    shade pack is built once here, outside the bounce loop, where it
    applies. With `config.remat` and a graph being recorded, each bounce is
    checkpointed: the backward runs it again (its kernels launch again)
    instead of keeping its intermediates."""
    B = o.shape[0]
    dev = o.device
    pack = sp_mod.build_shade_pack(scene) if sp_mod.pack_enabled(scene) else None

    def bounce(depth, o, d, active, throughput, prev_pdf, prev_delta, eta_scale, path_len,
               state):
        out = surface_bounce(scene, config, o=o, d=d, active=active,
                             throughput=throughput, prev_pdf=prev_pdf,
                             prev_delta=prev_delta, eta_scale=eta_scale, path_len=path_len,
                             sampler=Sampler(state=state), depth=depth, cone=cone, pack=pack)
        c, c3 = out.cont, out.cont[..., None]
        return (torch.where(c3, out.o, o), torch.where(c3, out.d, d), c,
                torch.where(c3, out.throughput, throughput), out.L_add,
                torch.where(c, out.bs_pdf, prev_pdf), torch.where(c, out.delta_now, prev_delta),
                torch.where(c, out.eta_scale, eta_scale),
                None if path_len is None else torch.where(c, out.path_len, path_len),
                out.sampler.state, out.n_rays, out.n_nonfinite)

    step = bounce
    if config.remat and torch.is_grad_enabled():
        def step(*args):
            return checkpoint(bounce, *args, use_reentrant=False)

    throughput = torch.ones(B, 3, device=dev)
    L = torch.zeros(B, 3, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros(B, device=dev)
    prev_delta = torch.ones(B, dtype=torch.bool, device=dev)  # depth 0: emission counts fully
    eta_scale = torch.ones(B, device=dev)
    path_len = None if cone is None else torch.zeros(B, device=dev)
    state = sampler.state
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)
    n_bad = torch.zeros((), dtype=torch.int64, device=dev)
    for depth in range(config.max_depth):
        with span("ctl.bounce"):
            (o, d, active, throughput, L_add, prev_pdf, prev_delta, eta_scale, path_len, state,
             n_r, n_b) = step(depth, o, d, active, throughput, prev_pdf, prev_delta,
                              eta_scale, path_len, state)
            L = L + L_add
            n_rays = n_rays + n_r
            n_bad = n_bad + n_b
    if with_stats:
        return L, Sampler(state=state), n_rays, n_bad
    return L, Sampler(state=state)


def block_order(width: int, height: int, device, block: int = 32):
    """Block-major pixel order (32x32 screen tiles, each row-major), built
    on `device`: (pid, pos), pid (W H,) int64 the pixel ids in that order
    and pos its inverse, pixel id -> slot."""
    y = torch.arange(height, device=device)[:, None]
    x = torch.arange(width, device=device)[None, :]
    by, bx = y // block, x // block
    bh = torch.clamp(height - by * block, max=block)   # the block's rows, columns
    bw = torch.clamp(width - bx * block, max=block)
    pos = (by * block * width + bx * block * bh + (y % block) * bw + x % block).reshape(-1)
    pid = torch.empty_like(pos)
    pid[pos] = torch.arange(width * height, device=device)
    return pid, pos


def block_order_pixels(width: int, height: int, block: int = 32, device="cuda"):
    """Pixel ids in block-major order (32x32 screen tiles), an int64 tensor
    on `device`: consecutive rays form compact screen tiles."""
    return block_order(width, height, device, block)[0]


def block_order_pixels_np(width: int, height: int, block: int = 32) -> np.ndarray:
    """Pixel ids in block-major order (32x32 screen tiles)."""
    return block_order(width, height, "cpu", block)[0].numpy()


def _camera_samples(scene: Scene, width: int, height: int, spp: int, seed):
    """The pass prologue: block-ordered pixel ids repeated spp times, the
    per-lane sampler, jittered film positions, the aperture sample and the
    camera rays. Returns (o, d, w_cam, sampler, sx, sy), (sx, sy) the
    samples' continuous film positions in pixels."""
    dev = scene.light_cdf.device
    pixel_id = block_order(width, height, dev)[0].repeat(spp)
    sample_idx = torch.arange(spp, device=dev).repeat_interleave(width * height)
    sampler = Sampler.create(int(seed) & MASK, pixel_id, sample_idx)
    px = (pixel_id % width).to(torch.float32)
    py = (pixel_id // width).to(torch.float32)
    sampler, jitter = sampler.next_2d()
    sx, sy = px + jitter[:, 0], py + jitter[:, 1]
    film_uv = torch.stack([sx / width, sy / height], -1)
    sampler, u_ap = sampler.next_2d()
    o, d, w_cam = sensors.sample_ray(scene.camera, film_uv, u_ap)
    return o, d, w_cam, sampler, sx, sy


def camera_rays(scene: Scene, width: int, height: int, spp: int, seed):
    """The camera rays of a pass (see `_camera_samples`): (o, d, w_cam,
    sampler)."""
    return _camera_samples(scene, width, height, spp, seed)[:4]


@spanned("ctl.pass")
def _render_body(scene: Scene, width: int, height: int, spp: int, seed,
                 config: PTConfig, with_stats: bool):
    o, d, w_cam, sampler, sx, sy = _camera_samples(scene, width, height, spp, seed)
    cone = texture_cone(scene, width, height, config)
    out = trace_radiance(scene, o, d, sampler, config, cone=cone, with_stats=with_stats)
    L = torch.nan_to_num(out[0] * w_cam, nan=0.0, posinf=0.0, neginf=0.0)
    stats = (out[2], out[3]) if with_stats else None
    if config.rec_filter != 0:
        # filter-importance splatting: each sample lands in the pixels of its
        # filter support with continuous weights
        film = film_mod.add_samples_filtered(
            film_mod.Film.create(height, width, device=o.device), sx, sy, L,
            config.rec_filter, config.rec_radius,
            support=max(1, int(np.ceil(config.rec_radius - 0.5))))
        img = film.rgb / torch.clamp(film.weight, min=1e-8)[..., None]
        return (img, stats) if with_stats else img
    # the sample -> pixel map is a fixed permutation repeated spp times, so
    # the film is a reshape-sum plus a static inverse-permutation gather
    n_px = width * height
    slot_sum = L.reshape(spp, n_px, 3).sum(0) / spp
    img = slot_sum[block_order(width, height, o.device)[1]].reshape(height, width, 3)
    return (img, stats) if with_stats else img


def render(scene: Scene, width: int, height: int, spp: int, seed,
           config: PTConfig = PTConfig()):
    """Render a full frame on the scene's device: returns (H, W, 3) radiance.
    One pass = spp camera samples per pixel, jittered, box filter.
    Differentiable in every float tensor of the scene that requires grad."""
    config = specialize_config(scene, config)
    return _render_body(scene, width, height, spp, seed, config, False)


def render_pass_fn(scene: Scene, width: int, height: int, spp: int,
                   config: PTConfig = PTConfig()):
    """fn(seed) -> image, one `render` pass, for progressive accumulation."""
    return partial(render, scene, width, height, spp, config=config)


@torch.no_grad()
def render_counted(scene: Scene, width: int, height: int, spp: int, seed,
                   config: PTConfig = PTConfig()):
    """Like `render`, and also returns the number of rays traced (alive
    closest-hit lanes + NEE shadow rays, summed over bounces), an int64
    tensor."""
    config = specialize_config(scene, config)
    img, (n_rays, _) = _render_body(scene, width, height, spp, seed, config, True)
    return img, n_rays


@torch.no_grad()
def render_with_counters(scene: Scene, width: int, height: int, spp: int, seed,
                         config: PTConfig = PTConfig()):
    """`render` plus debug counters {"n_rays", "n_nonfinite"} (int64
    tensors): n_nonfinite counts the lanes whose bounce contribution or
    throughput went non-finite before the film's nan_to_num, which the
    engine cross-checks hold at zero."""
    config = specialize_config(scene, config)
    img, (n_rays, n_bad) = _render_body(scene, width, height, spp, seed, config, True)
    return img, {"n_rays": n_rays, "n_nonfinite": n_bad}


@torch.no_grad()
def render_progressive(scene: Scene, width: int, height: int, spp: int,
                       n_passes: int, seed, config: PTConfig = PTConfig()):
    """The mean of `n_passes` passes with seeds seed, seed+1, ... (uint32)."""
    config = specialize_config(scene, config)
    acc = torch.zeros(height, width, 3, device=scene.light_cdf.device)
    for i in range(n_passes):
        acc += _render_body(scene, width, height, spp, (int(seed) + i) & MASK, config, False)
    return acc / n_passes
