"""Volumetric path tracer: surfaces and participating media (port of
cudatracerlib_tpu/render/volpath.py).

Each bounce intersects the scene, then samples a medium event along
[ray_eps, t_surf] against the union of the volumes (scene/media.py delta
tracking). A lane that scatters in the medium does next-event estimation
with the phase function from the scatter point and samples the phase
function; any other lane shades the surface as the path tracer does. Shadow
rays are weighted by the transmittance of the media along them.

The JAX bounce `lax.scan` becomes a Python loop over the same bounce body
(`vol_bounce`); with `PTConfig.remat` and a graph being recorded each bounce
is checkpointed, as in `render`. The JAX package keeps `render_vol_stepwise`
(one dispatch per bounce) as a workaround of a TPU compiler fault; here
every entry point runs the same loop, so `render_vol_stepwise` equals
`render_vol_progressive` and stays only as an API name. The camera batch is
in row order (`_camera_lanes`, not the path tracer's block order), and each
pass's film is the reshape-sum over spp of `tile(arange(n_px), spp)`, which
equals the JAX package's `film.add_samples` and needs no atomics on the
card. `lane_radiance` traces any lanes given as (pixel_id, sample_idx) as
one batch: parallel/shard.make_sharded_render_vol runs a rank's block of
lanes through it.

`render_vol` is the differentiable entry point, like `render`: in every
float tensor of the scene and of the media (`grid_data`, `sigma_a`,
`sigma_s`, `le`, `phase_g`; convert.with_grad / convert.grads name them by
field), with `PTConfig.remat` checkpointing each bounce. The media's table
lookups and the volume's phase_g go through ops/shade_gather.gather_rows
(the deterministic gather-backward kernel on the card). `render_vol_counted`,
`render_vol_stepwise` and `render_vol_progressive` run without gradients.
The JAX module's `stop_gradient`s are `.detach()`s here at the same sites
in `vol_bounce`: the light selection pmf and the NEE light pdf (JAX
volpath.py:105, :128) and the Russian-roulette probability (:161); the
media's own are listed in scene/media.py.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..math import montecarlo as mc
from ..ops.shade_gather import gather_rows
from ..sampling.rng import MASK, Sampler, draws_between
from ..scene import bsdf as bsdf_mod
from ..scene import lights as lights_mod
from ..scene import media as media_mod
from ..scene import phase as phase_mod
from ..scene import scene as scene_mod
from ..scene import sensors
from ..scene.scene import Scene, gather_mat_params, make_interaction
from ..utils.timing import span, spanned
from .path_tracer import (PTConfig, _offset_ray, emission_term, env_term, has_env,
                          nee_light_sample, nee_weight, specialize_config)


# a bounce's draws besides delta tracking: NEE 3, phase 2, BSDF 3, roulette 1, volume choice 1
BOUNCE_DRAWS = 10


def tracking_trips(state_before, state_after) -> int:
    """A bounce's delta-tracking trip count T (scene/media.py) from one lane's
    sampler state before and after it: every lane draws 2 T + BOUNCE_DRAWS."""
    return (draws_between(state_before, state_after) - BOUNCE_DRAWS) // 2


class VolCarry(NamedTuple):
    o: torch.Tensor
    d: torch.Tensor
    throughput: torch.Tensor
    L: torch.Tensor
    active: torch.Tensor
    sampler: Sampler
    prev_pdf: torch.Tensor
    prev_delta: torch.Tensor
    n_rays: torch.Tensor  # int64 scalar (JAX counts in float32, exact below 2^24)


def vol_bounce(scene: Scene, media: media_mod.Media, config: PTConfig, carry: VolCarry,
               depth: int) -> VolCarry:
    """One volumetric bounce; `config` specialized (specialize_media_config)."""
    s = carry.sampler
    modes = config.media_modes
    hit = scene_mod.scene_intersect(scene, carry.o, carry.d)
    it = make_interaction(scene, carry.o, carry.d, hit)
    found = hit.valid & carry.active
    t_surf = torch.where(hit.valid, hit.t, 1e8)

    # ---- medium event along [eps, t_surf] ----
    s, _, scat, w_med, vid, p_scat, v_emit = media_mod.sample_distance(
        media, carry.o, carry.d, config.ray_eps, t_surf, s, modes=modes)
    throughput = carry.throughput * torch.where(carry.active[..., None], w_med, 1.0)
    medium_event = carry.active & scat
    L = carry.L

    # ---- escaped to the environment (no medium scatter, no surface) ----
    if has_env(config):
        env_L, w_env = env_term(scene, carry.d, carry.prev_pdf, carry.prev_delta)
        escaped = carry.active & ~hit.valid & ~scat & (scene.env_light_id >= 0)
        L = L + torch.where(escaped[..., None], throughput * env_L * w_env[..., None], 0.0)

    # ---- surface emission with MIS ----
    if lights_mod.AREA_LIGHT in config.light_types:
        mat_light, Le, w_hit = emission_term(scene, it, carry.o, carry.d, carry.prev_pdf,
                                             carry.prev_delta)
        emissive = found & ~scat & (mat_light >= 0)
        L = L + torch.where(emissive[..., None], throughput * Le * w_hit[..., None], 0.0)

    # ---- medium emission (v_emit carries Tr * Le / pdf of this segment) ----
    L = L + torch.where(medium_event[..., None], carry.throughput * v_emit, 0.0)

    # ---- NEE from the medium point or the surface point ----
    mp = gather_mat_params(scene, it, config.tex_types)
    wo_world = -carry.d
    wo_local = it.frame.to_local(wo_world)
    nee_p = torch.where(medium_event[..., None], p_scat, it.p)
    ptype, pg = media.phase_type[vid], gather_rows(media.phase_g, vid)
    me3 = medium_event[..., None]

    s, u_sel = s.next_1d()
    s, u_l2 = s.next_2d()
    if config.direct and scene.n_lights > 0:
        ds, Lrad, pdf_l, lpmf = nee_light_sample(scene, config, nee_p, u_sel, u_l2)
        f_surf, pdf_b_surf = bsdf_mod.eval_bsdf(mp, wo_local, it.frame.to_local(ds.d),
                                                active=config.bsdf_types)
        ph = phase_mod.eval_phase(ptype, pg, wo_world, ds.d)
        pdf_ph = phase_mod.pdf_phase(ptype, pg, wo_world, ds.d)
        f_val = torch.where(me3, ph[..., None], f_surf)
        pdf_fwd = torch.where(medium_event, pdf_ph, pdf_b_surf)
        sh_o = torch.where(me3, nee_p, _offset_ray(it.p, it.n_geo, ds.d, config.ray_eps))
        t_sh = ds.dist - 2.0 * config.ray_eps
        blocked = scene_mod.scene_occluded(scene, sh_o, ds.d, config.ray_eps, t_sh)
        tr_shadow = media_mod.transmittance(media, sh_o, ds.d, config.ray_eps, t_sh, modes)
        contrib = (throughput * f_val * Lrad * tr_shadow
                   * nee_weight(config, ds, pdf_l, pdf_fwd)[..., None])
        ok = (found | medium_event) & ~blocked & (ds.pdf > 0) & (lpmf > 0)
        L = L + torch.where(ok[..., None], contrib, 0.0)
        n_shadow = (found | medium_event).sum()
    else:
        n_shadow = torch.zeros((), dtype=torch.int64, device=carry.o.device)

    # ---- continue the path: phase sample or BSDF sample ----
    s, u_p2 = s.next_2d()
    ps = phase_mod.sample_phase(ptype, pg, wo_world, u_p2)
    s, u_b2 = s.next_2d()
    s, u_b1 = s.next_1d()
    bs = bsdf_mod.sample_bsdf(mp, wo_local, u_b2, u_b1, active=config.bsdf_types)
    wi_surf = it.frame.to_world(bs.wi)
    new_d = torch.where(me3, ps.wi, wi_surf)
    new_o = torch.where(me3, p_scat, _offset_ray(it.p, it.n_geo, wi_surf, config.ray_eps))
    new_pdf = torch.where(medium_event, ps.pdf, bs.pdf)
    throughput = throughput * torch.where(me3, ps.weight[..., None], bs.weight)
    cont = (found | medium_event) & (new_pdf > 0) & (throughput.abs().amax(-1) > 0)

    s, u_rr = s.next_1d()
    p_cont = mc.russian_roulette_prob(throughput.amax(-1), depth, config.rr_start).detach()
    cont = cont & (u_rr < p_cont)
    throughput = throughput / torch.clamp(p_cont, min=1e-6)[..., None]

    delta_now = ~medium_event & (bsdf_mod.is_delta(mp) | ((bs.sampled_type & (16 | 32 | 64)) > 0))
    c3 = cont[..., None]
    return VolCarry(
        o=torch.where(c3, new_o, carry.o),
        d=torch.where(c3, new_d, carry.d),
        throughput=torch.where(c3, throughput, carry.throughput),
        L=L, active=cont, sampler=s,
        prev_pdf=torch.where(cont, new_pdf, carry.prev_pdf),
        prev_delta=torch.where(cont, delta_now, carry.prev_delta),
        n_rays=carry.n_rays + carry.active.sum() + n_shadow,
    )


def init_vol_carry(o, d, sampler: Sampler) -> VolCarry:
    B, dev = o.shape[0], o.device
    return VolCarry(
        o=o, d=d,
        throughput=torch.ones(B, 3, device=dev),
        L=torch.zeros(B, 3, device=dev),
        active=torch.ones(B, dtype=torch.bool, device=dev),
        sampler=sampler,
        prev_pdf=torch.zeros(B, device=dev),
        prev_delta=torch.ones(B, dtype=torch.bool, device=dev),
        n_rays=torch.zeros((), dtype=torch.int64, device=dev),
    )


def trace_radiance_vol(scene: Scene, media: media_mod.Media, o, d, sampler: Sampler,
                       config: PTConfig, with_stats: bool = False):
    """Radiance along a batch of rays through the media: (L (B, 3), sampler),
    plus the rays traced with `with_stats`. `config` specialized."""
    def bounce(carry, depth):
        return vol_bounce(scene, media, config, carry, depth)

    step = bounce
    if config.remat and torch.is_grad_enabled():
        def step(carry, depth):
            return checkpoint(bounce, carry, depth, use_reentrant=False)

    final = init_vol_carry(o, d, sampler)
    for depth in range(config.max_depth):
        with span("ctl.bounce"):
            final = step(final, depth)
    if with_stats:
        return final.L, final.sampler, final.n_rays
    return final.L, final.sampler


def _camera_lanes(width: int, height: int, spp: int, device):
    """One pass's lanes in row order: (pixel_id, sample_idx), pixel ids
    tile(arange(W H), spp) and sample indices repeat(arange(spp), W H)."""
    n_px = width * height
    pixel_id = torch.arange(n_px, device=device).repeat(spp)
    sample_idx = torch.arange(spp, device=device).repeat_interleave(n_px)
    return pixel_id, sample_idx


def _camera_rays(scene: Scene, pixel_id, sample_idx, width: int, height: int, seed):
    """The lanes' camera rays: (o, d, w_cam, sampler)."""
    sampler = Sampler.create(int(seed) & MASK, pixel_id, sample_idx)
    px = (pixel_id % width).to(torch.float32)
    py = (pixel_id // width).to(torch.float32)
    sampler, jitter = sampler.next_2d()
    film_uv = torch.stack([(px + jitter[:, 0]) / width, (py + jitter[:, 1]) / height], -1)
    sampler, u_ap = sampler.next_2d()
    o, d, w_cam = sensors.sample_ray(scene.camera, film_uv, u_ap)
    return o, d, w_cam, sampler


def _camera_batch(scene: Scene, width: int, height: int, spp: int, seed):
    """One pass's camera rays in row order: (pixel_id, o, d, w_cam, sampler)
    for pixel ids tile(arange(W H), spp)."""
    pixel_id, sample_idx = _camera_lanes(width, height, spp, scene.light_cdf.device)
    return (pixel_id, *_camera_rays(scene, pixel_id, sample_idx, width, height, seed))


def lane_radiance(scene: Scene, media: media_mod.Media, pixel_id, sample_idx, width: int,
                  height: int, seed, config: PTConfig, with_stats: bool = False):
    """The lanes' radiance weighted by the camera, (B, 3), traced as one
    batch (so delta tracking's trip count T is this batch's); plus the rays
    traced with `with_stats`. `config` specialized."""
    o, d, w_cam, sampler = _camera_rays(scene, pixel_id, sample_idx, width, height, seed)
    out = trace_radiance_vol(scene, media, o, d, sampler, config, with_stats=with_stats)
    return (out[0] * w_cam, out[2]) if with_stats else out[0] * w_cam


def sample_sum(L, n_samples: int, n_px: int):
    """(n_px, 3): each pixel's samples summed in sample order, lanes laid
    out sample-major (n_samples, n_px); non-finite samples count as 0
    (film.add_samples)."""
    L = torch.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0)
    return L.reshape(n_samples, n_px, 3).sum(0)


def _film(L, width: int, height: int, spp: int):
    """The pass's image: each pixel's spp samples summed in sample order and
    divided by spp (`sample_sum`)."""
    return (sample_sum(L, spp, width * height) / spp).reshape(height, width, 3)


@spanned("ctl.pass")
def _render_vol_body(scene, media, width, height, spp, seed, config, with_stats):
    pixel_id, sample_idx = _camera_lanes(width, height, spp, scene.light_cdf.device)
    out = lane_radiance(scene, media, pixel_id, sample_idx, width, height, seed, config,
                        with_stats=with_stats)
    if with_stats:
        return _film(out[0], width, height, spp), out[1]
    return _film(out, width, height, spp)


def specialize_media_config(media: media_mod.Media, config: PTConfig) -> PTConfig:
    """Fill config.media_modes from the media's host-side structure, unless set."""
    if config.media_modes is not None:
        return config
    return config._replace(media_modes=media_mod.static_modes(media))


def _specialize(scene: Scene, media: media_mod.Media, config: PTConfig) -> PTConfig:
    """The path tracer's specialization and checks, then the media modes."""
    modes = specialize_media_config(media, config).media_modes
    return specialize_config(scene, config._replace(media_modes=None))._replace(media_modes=modes)


def render_vol(scene: Scene, media: media_mod.Media, width: int, height: int, spp: int, seed,
               config: PTConfig = PTConfig()):
    """One volumetric pass on the scene's device: (H, W, 3) radiance.
    Differentiable in every float tensor of the scene and media that
    requires grad."""
    config = _specialize(scene, media, config)
    return _render_vol_body(scene, media, width, height, spp, seed, config, False)


@torch.no_grad()
def render_vol_counted(scene: Scene, media: media_mod.Media, width: int, height: int, spp: int,
                       seed, config: PTConfig = PTConfig()):
    """(image, rays traced): alive closest-hit lanes plus NEE shadow rays,
    summed over bounces, an int64 tensor."""
    config = _specialize(scene, media, config)
    return _render_vol_body(scene, media, width, height, spp, seed, config, True)


def _passes(scene, media, width, height, spp, n_passes, seed, config):
    """(mean image, rays) of `n_passes` passes with seeds seed, seed+1, ..."""
    acc = torch.zeros(height, width, 3, device=scene.light_cdf.device)
    n_rays = torch.zeros((), dtype=torch.int64, device=acc.device)
    for i in range(n_passes):
        img, n = _render_vol_body(scene, media, width, height, spp, (int(seed) + i) & MASK,
                                  config, True)
        acc = acc + img
        n_rays = n_rays + n
    return acc / n_passes, n_rays


@torch.no_grad()
def render_vol_progressive(scene: Scene, media: media_mod.Media, width: int, height: int,
                           spp: int, n_passes: int, seed, config: PTConfig = PTConfig()):
    """The mean of `n_passes` passes with seeds seed, seed+1, ... (uint32)."""
    config = _specialize(scene, media, config)
    return _passes(scene, media, width, height, spp, n_passes, seed, config)[0]


@torch.no_grad()
def render_vol_stepwise(scene: Scene, media: media_mod.Media, width: int, height: int, spp: int,
                        n_passes: int, seed, config: PTConfig = PTConfig(),
                        with_stats: bool = False):
    """The JAX package's host-stepped entry point: here the passes of
    `render_vol_progressive` (module docstring), and with `with_stats` also
    the rays of all passes (bench.py's count)."""
    config = _specialize(scene, media, config)
    img, n_rays = _passes(scene, media, width, height, spp, n_passes, seed, config)
    return (img, n_rays) if with_stats else img
