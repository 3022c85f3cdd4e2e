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
`bsdf.eval_bsdf_nested` / `sample_bsdf_nested`) and light type, the texture
types of scene/textures.py `PORTED`, all five camera models, with or
without NEE, path-space regularization (`_regularize`), filter-importance
splatting (`rec_filter` 1-4, `image/film.add_samples_filtered`) and the
fused shade-pack path on the card. What stays unported raises
NotImplementedError: media in `render` (`media_modes`; render/volpath.py
renders media), `sss`, `alpha_test`, normal/height/parallax maps and the
texture types scene/textures.py does not port.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..image import film as film_mod
from ..math import montecarlo as mc
from ..math.vecmath import dot
from ..sampling.records import DISCRETE
from ..sampling.rng import MASK, Sampler
from ..scene import bsdf as bsdf_mod
from ..scene import lights as lights_mod
from ..scene import sensors
from ..scene import textures as tex_mod
from ..scene import scene as scene_mod
from ..scene.scene import Scene, gather_nested_params
from ..scene.shade_pack import build_shade_pack, hit_shading, pack_enabled

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
    sss: bool = False


def _check_ported(config: PTConfig) -> None:
    unported = [name for name, on in (
        ("media_modes", config.media_modes is not None),
        ("sss", config.sss),
        ("alpha_test", config.alpha_test),
        ("normal_maps", config.normal_maps),
        ("height_maps", config.height_maps),
        ("parallax", config.parallax),
    ) if on]
    if unported:
        raise NotImplementedError(f"PTConfig features not ported: {unported}")
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
        spec = scene.spec
        if spec is None:
            sh = scene.shading
            host = lambda x: x.detach().cpu().numpy()  # noqa: E731
            spec = scene_mod.specialization(
                host(sh.mat_id), {k: host(v) for k, v in scene.materials._asdict().items()},
                host(scene.textures.ttype), np.unique(host(scene.lights.ltype)),
                host(sh.normals), host(sh.n_face), host(sh.uvs))
        config = config._replace(**spec)
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


def _offset_ray(p, n_geo, w, eps):
    """Offset the origin along the geometric normal on w's side."""
    s = torch.sign(dot(n_geo, w, keepdims=True))
    return p + n_geo * s * eps


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
    sampler: Sampler
    n_rays: torch.Tensor      # rays traced this bounce (int64 scalar)
    n_nonfinite: torch.Tensor  # lanes whose L or throughput went non-finite


def surface_bounce(scene: Scene, config: PTConfig, *, o, d, active, throughput,
                   prev_pdf, prev_delta, eta_scale, sampler: Sampler, depth,
                   pack=None) -> BounceOut:
    """One surface-path bounce: intersect -> environment on escape and
    area-light emission, each with MIS -> NEE -> BSDF sample -> Russian
    roulette. `config` must be specialized; `depth` is an int (megakernel)
    or a per-lane tensor (wavefront pool).

    `pack`: the (Tp, 64) shade pack (scene/shade_pack.py) or None; with it
    the interaction and material parameters come from one packed gather.
    The JAX `cone` and `path_len` arguments feed the ray cone of
    image-texture filtering, which is not ported (image textures raise), so
    they are left out."""
    B = o.shape[0]
    s = sampler
    hit = scene_mod.scene_intersect(scene, o, d)
    it, mp = hit_shading(scene, o, d, hit, pack, config.tex_types, flat=config.flat_shading)
    nested = any(x in config.bsdf_types for x in bsdf_mod.NESTED)
    mp_in = gather_nested_params(scene, it, config.tex_types) if nested else None
    if config.regularization > 0.0:
        mp = _regularize(mp, depth, config.regularization)
    found = hit.valid & active
    L = torch.zeros(B, 3, device=o.device)
    no_mis = prev_delta if config.direct else torch.ones_like(prev_delta)

    # ---- environment on escape (PathTracer.cu:98-111) ----
    if {lights_mod.INFINITE, lights_mod.CONSTANT_ENV} & set(config.light_types):
        env_id = torch.clamp(scene.env_light_id, min=0).long()
        env_L = lights_mod.eval_env(scene.lights, env_id, d)
        env_pdf_l = (lights_mod.pdf_env_dir(scene.lights, env_id, d)
                     * _light_select_pmf(scene, env_id, prev_pdf))
        w_env = torch.where(no_mis, 1.0, mc.mis_weight(prev_pdf, env_pdf_l))
        escaped = active & ~hit.valid & (scene.env_light_id >= 0)
        L = L + torch.where(escaped[..., None], throughput * env_L * w_env[..., None], 0.0)

    # ---- emission at the hit (MIS against NEE) ----
    wo_world = -d
    if lights_mod.AREA_LIGHT in config.light_types:
        mat_light = scene.materials.light_id[it.mat_id.long()]
        emissive = found & (mat_light >= 0)
        lid = 0 if scene.n_lights == 1 else torch.clamp(mat_light, min=0).long()
        Le = lights_mod.eval_area_emission(scene.lights, lid, it.n_geo, wo_world)
        pdf_light_hit = (lights_mod.pdf_direct_area(scene.lights, lid, o, it.p, it.n_geo)
                         * _light_select_pmf(scene, lid, prev_pdf))
        w_hit = torch.where(no_mis, 1.0, mc.mis_weight(prev_pdf, pdf_light_hit))
        L = L + torch.where(emissive[..., None], throughput * Le * w_hit[..., None], 0.0)

    wo_local = it.frame.to_local(wo_world)

    # ---- next-event estimation ----
    s, u_sel = s.next_1d()
    s, u_l2 = s.next_2d()
    if config.direct and scene.n_lights > 0:
        lsel, lpmf, _ = _select_light(scene, u_sel)
        ds, Lrad = lights_mod.sample_direct(scene.lights, lsel, it.p, u_l2,
                                            active=config.light_types)
        wi_l = it.frame.to_local(ds.d)
        if nested:
            f_l, pdf_b_l = bsdf_mod.eval_bsdf_nested(mp, mp_in, wo_local, wi_l,
                                                     active=config.bsdf_types)
        else:
            f_l, pdf_b_l = bsdf_mod.eval_bsdf(mp, wo_local, wi_l, active=config.bsdf_types)
        sh_o = _offset_ray(it.p, it.n_geo, ds.d, config.ray_eps)
        blocked = scene_mod.scene_occluded(scene, sh_o, ds.d, t_min=config.ray_eps,
                                           t_max=ds.dist - 2.0 * config.ray_eps)
        # the light's pdf and pmf are detached (JAX path_tracer.py:491-492);
        # a delta light (DISCRETE measure) takes weight 1 and pdf 1
        lpmf = lpmf.detach()
        pdf_l_sa = ds.pdf.detach() * lpmf
        w_nee = mc.mis_weight(pdf_l_sa, pdf_b_l)
        if set(lights_mod.DELTA) & set(config.light_types):
            is_delta_l = ds.measure == DISCRETE
            pdf_l_sa = torch.where(is_delta_l, lpmf, pdf_l_sa)
            w_nee = torch.where(is_delta_l, 1.0, w_nee)
        contrib = (throughput * f_l * Lrad
                   * (w_nee / torch.clamp(pdf_l_sa, min=1e-12))[..., None])
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
    bad = active & (~torch.isfinite(L).all(-1)
                    | (cont & ~torch.isfinite(new_tp).all(-1)))
    return BounceOut(
        o=new_o, d=wi_world, throughput=new_tp, L_add=L, cont=cont,
        bs_pdf=bs.pdf, delta_now=delta_now, eta_scale=eta_scale * bs.eta * bs.eta,
        sampler=s, n_rays=active.sum() + n_shadow,
        n_nonfinite=bad.sum(),
    )


def trace_radiance(scene: Scene, o, d, sampler: Sampler, config: PTConfig,
                   with_stats: bool = False):
    """Radiance along a batch of rays. Returns (L (B, 3), sampler), plus with
    `with_stats` the rays traced (alive closest-hit lanes plus NEE shadow
    rays, summed over bounces) and the non-finite lane count. The shade pack
    is built once here, outside the bounce loop, where it applies. With
    `config.remat` and a graph being recorded, each bounce is checkpointed:
    the backward runs it again (its kernels launch again) instead of keeping
    its intermediates."""
    B = o.shape[0]
    dev = o.device
    pack = build_shade_pack(scene) if pack_enabled(scene) else None

    def bounce(depth, o, d, active, throughput, prev_pdf, prev_delta, eta_scale, state):
        out = surface_bounce(scene, config, o=o, d=d, active=active,
                             throughput=throughput, prev_pdf=prev_pdf,
                             prev_delta=prev_delta, eta_scale=eta_scale,
                             sampler=Sampler(state=state), depth=depth, pack=pack)
        c, c3 = out.cont, out.cont[..., None]
        return (torch.where(c3, out.o, o), torch.where(c3, out.d, d), c,
                torch.where(c3, out.throughput, throughput), out.L_add,
                torch.where(c, out.bs_pdf, prev_pdf), torch.where(c, out.delta_now, prev_delta),
                torch.where(c, out.eta_scale, eta_scale), out.sampler.state,
                out.n_rays, out.n_nonfinite)

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
    state = sampler.state
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)
    n_bad = torch.zeros((), dtype=torch.int64, device=dev)
    for depth in range(config.max_depth):
        (o, d, active, throughput, L_add, prev_pdf, prev_delta, eta_scale, state,
         n_r, n_b) = step(depth, o, d, active, throughput, prev_pdf, prev_delta,
                          eta_scale, state)
        L = L + L_add
        n_rays = n_rays + n_r
        n_bad = n_bad + n_b
    if with_stats:
        return L, Sampler(state=state), n_rays, n_bad
    return L, Sampler(state=state)


def block_order_pixels_np(width: int, height: int, block: int = 32) -> np.ndarray:
    """Pixel ids in block-major order (32x32 screen tiles)."""
    ids = []
    for by in range(0, height, block):
        for bx in range(0, width, block):
            Y, X = np.meshgrid(np.arange(by, min(by + block, height)),
                               np.arange(bx, min(bx + block, width)), indexing="ij")
            ids.append((Y * width + X).reshape(-1))
    return np.concatenate(ids).astype(np.int64)


def _camera_samples(scene: Scene, width: int, height: int, spp: int, seed):
    """The pass prologue: block-ordered pixel ids repeated spp times, the
    per-lane sampler, jittered film positions, the aperture sample and the
    camera rays. Returns (o, d, w_cam, sampler, sx, sy), (sx, sy) the
    samples' continuous film positions in pixels."""
    dev = scene.light_cdf.device
    pixel_id = torch.from_numpy(block_order_pixels_np(width, height)).to(dev).repeat(spp)
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


def _render_body(scene: Scene, width: int, height: int, spp: int, seed,
                 config: PTConfig, with_stats: bool):
    o, d, w_cam, sampler, sx, sy = _camera_samples(scene, width, height, spp, seed)
    out = trace_radiance(scene, o, d, sampler, config, with_stats=with_stats)
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
    inv_perm = torch.from_numpy(np.argsort(block_order_pixels_np(width, height))).to(o.device)
    img = slot_sum[inv_perm].reshape(height, width, 3)
    return (img, stats) if with_stats else img


def render(scene: Scene, width: int, height: int, spp: int, seed,
           config: PTConfig = PTConfig()):
    """Render a full frame on the scene's device: returns (H, W, 3) radiance.
    One pass = spp camera samples per pixel, jittered, box filter.
    Differentiable in every float tensor of the scene that requires grad."""
    config = specialize_config(scene, config)
    return _render_body(scene, width, height, spp, seed, config, False)


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
def render_progressive(scene: Scene, width: int, height: int, spp: int,
                       n_passes: int, seed, config: PTConfig = PTConfig()):
    """The mean of `n_passes` passes with seeds seed, seed+1, ... (uint32)."""
    config = specialize_config(scene, config)
    acc = torch.zeros(height, width, 3, device=scene.light_cdf.device)
    for i in range(n_passes):
        acc += _render_body(scene, width, height, spp, (int(seed) + i) & MASK, config, False)
    return acc / n_passes
