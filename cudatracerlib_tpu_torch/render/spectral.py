"""Spectral path tracer: hero-wavelength sampling and dispersive dielectrics
(port of cudatracerlib_tpu/render/spectral.py).

* Each path carries N_WAVES spectral radiance samples at hero-rotated
  wavelengths (math/spectral.py) through the bounce structure of the RGB
  tracer; every RGB quantity (albedo, Fresnel, emitted radiance) is
  uplifted to the path's wavelengths by the calibrated 3-band basis.
* A dielectric with a nonzero Cauchy coefficient (`Materials.cauchy_c`) or
  Sellmeier terms refracts with the hero wavelength's index. A delta
  refraction terminates the companions and weights the hero by N_WAVES
  (hero MIS in the delta limit, once a path); a rough one keeps them with
  the one-sample MIS weight f_lambda / mean_k pdf_k, evaluating the BSDF
  once a wavelength (statically gated on ROUGHDIELECTRIC in the scene).
* `trace_radiance_spectral_vol` adds a single homogeneous medium: collision
  distances sampled against the hero's extinction, each wavelength weighted
  by its own transmittance, and NEE shadow rays attenuated per wavelength
  through any media (`spectral_transmittance`).

The lanes are in row order, pixel ids tile(arange(W H), spp), and the
draws are the JAX package's: per lane the jitter, the aperture and u_lam;
per bounce u_sel, u_l2, u_b2, u_b1, u_rr (the volume path draws u_t first
and the phase sample before the BSDF's), drawn whether or not NEE runs.

Differences from the JAX module, on purpose:
  * the continue gate also requires the BSDF sample's own pdf,
    `found & (bs.pdf > 0) & (pdf_mean > 0) & (max tp > 0)`: JAX's omits
    `bs.pdf > 0`, so a rough-dispersive lane whose sample failed (pdf 0,
    direction undefined) goes on when the per-wavelength pdfs along that
    direction are positive (tests/test_torch_spectral.py counts those
    lanes);
  * the environment and emission terms are computed only when the scene
    has such lights (their lanes add 0 either way).

Gradients: the renders are differentiable through autograd in every float
tensor of the scene (and media) that requires grad. The JAX module's
`stop_gradient`s are `.detach()`s at the same sites: the light selection
pmf and the NEE light pdf, the rough-dispersive mean pdf, the
Russian-roulette probability, and in the volume path the hero extinction
and the hero's collision pdfs. Per-material lookups (`cauchy_c`, the
Sellmeier terms) go through `gather_rows`, so their cotangents are summed
by the gather backward's deterministic kernels on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..math import montecarlo as mc
from ..math import spectral as sp
from ..ops.shade_gather import gather_rows
from ..sampling.rng import MASK, Sampler
from ..scene import bsdf as bsdf_mod
from ..scene import lights as lights_mod
from ..scene import media as media_mod
from ..scene import phase as phase_mod
from ..scene import scene as scene_mod
from ..scene.scene import Scene, gather_mat_params, make_interaction
from .path_tracer import (PTConfig, _offset_ray, emission_term, env_term, has_env,
                          nee_light_sample, nee_weight, specialize_config)
from .volpath import _camera_batch, _film, _specialize

LAMBDA_D_UM = 0.5893  # the sodium d line, where Materials.eta is quoted
_TRANSMIT = (1 << 5) | (1 << 3)   # E_DELTA_TRANSMISSION | E_GLOSSY_TRANSMISSION


def dispersive_eta(eta_d, cauchy_c, lam_nm, sellmeier_b=None, sellmeier_c=None):
    """Wavelength-dependent index (SceneTypes/Dispersion.h). Cauchy:
    n = eta_d + C (1 / lam^2 - 1 / lam_d^2), lam in um. Where any Sellmeier
    B_i > 0 on a lane, the absolute n^2 = 1 + sum_i B_i l^2 / (l^2 - C_i)
    replaces it (eta_d is then ignored, as in the reference)."""
    lam_um = lam_nm * 1e-3
    n_cauchy = eta_d + cauchy_c * (1.0 / (lam_um * lam_um) - 1.0 / (LAMBDA_D_UM * LAMBDA_D_UM))
    if sellmeier_b is None:
        return n_cauchy
    lam2 = (lam_um * lam_um)[..., None]
    terms = sellmeier_b * lam2 / (lam2 - sellmeier_c)
    n_sell = torch.sqrt(torch.clamp(1.0 + (terms[..., 0] + terms[..., 1] + terms[..., 2]),
                                    min=1.0))
    use_sell = (sellmeier_b > 0.0).any(-1)
    return torch.where(use_sell, n_sell, n_cauchy)


class _SCarry(NamedTuple):
    o: torch.Tensor
    d: torch.Tensor
    throughput: torch.Tensor  # (B, N_WAVES) spectral path throughput
    L: torch.Tensor           # (B, N_WAVES) spectral radiance
    active: torch.Tensor
    state: torch.Tensor       # the sampler's state
    prev_pdf: torch.Tensor
    prev_delta: torch.Tensor
    mono: torch.Tensor        # (B,) companions already terminated
    n_gate: torch.Tensor | None  # lanes the guarded gate stopped that JAX's continues,
                                 # None when not counted


def _spectral_bounce(scene: Scene, config: PTConfig, lam, c: _SCarry, depth: int) -> _SCarry:
    nw = lam.shape[-1]
    s = Sampler(state=c.state)

    def uplift(rgb):
        return sp.rgb_to_spectrum(rgb, lam)

    hit = scene_mod.scene_intersect(scene, c.o, c.d)
    it = make_interaction(scene, c.o, c.d, hit, flat=config.flat_shading)
    found = hit.valid & c.active
    L = c.L
    no_mis = c.prev_delta if config.direct else torch.ones_like(c.prev_delta)

    # ---- environment on escape ----
    if has_env(config):
        env_L, w_env = env_term(scene, c.d, c.prev_pdf, no_mis)
        escaped = c.active & ~hit.valid & (scene.env_light_id >= 0)
        L = L + torch.where(escaped[:, None], c.throughput * uplift(env_L) * w_env[:, None], 0.0)

    # ---- area emission at the hit (MIS) ----
    if lights_mod.AREA_LIGHT in config.light_types:
        mat_light, Le, w_hit = emission_term(scene, it, c.o, c.d, c.prev_pdf, no_mis)
        emissive = found & (mat_light >= 0)
        L = L + torch.where(emissive[:, None], c.throughput * uplift(Le) * w_hit[:, None], 0.0)

    # ---- shading setup: the hero wavelength's dispersive eta ----
    mp = gather_mat_params(scene, it, config.tex_types)
    mid = it.mat_id.long()
    cc = gather_rows(scene.materials.cauchy_c, mid)
    sb = gather_rows(scene.materials.sellmeier_b, mid)
    sc2 = gather_rows(scene.materials.sellmeier_c, mid)
    eta_base = mp.eta
    mp = mp._replace(eta=dispersive_eta(eta_base, cc, lam[..., 0], sb, sc2))
    wo_local = it.frame.to_local(-c.d)

    # ---- NEE ----
    s, u_sel = s.next_1d()
    s, u_l2 = s.next_2d()
    if config.direct and scene.n_lights > 0:
        ds, Lrad, pdf_l, lpmf = nee_light_sample(scene, config, it.p, u_sel, u_l2)
        f_l, pdf_b_l = bsdf_mod.eval_bsdf(mp, wo_local, it.frame.to_local(ds.d),
                                          active=config.bsdf_types)
        sh_o = _offset_ray(it.p, it.n_geo, ds.d, config.ray_eps)
        blocked = scene_mod.scene_occluded(scene, sh_o, ds.d, config.ray_eps,
                                           ds.dist - 2.0 * config.ray_eps)
        contrib = (c.throughput * uplift(f_l * Lrad)
                   * nee_weight(config, ds, pdf_l, pdf_b_l)[:, None])
        ok = found & ~blocked & (ds.pdf > 0) & (lpmf > 0)
        L = L + torch.where(ok[:, None], contrib, 0.0)

    # ---- BSDF sample (hero-eta directions) ----
    s, u_b2 = s.next_2d()
    s, u_b1 = s.next_1d()
    bs = bsdf_mod.sample_bsdf(mp, wo_local, u_b2, u_b1, active=config.bsdf_types)
    wi_world = it.frame.to_world(bs.wi)
    new_o = _offset_ray(it.p, it.n_geo, wi_world, config.ray_eps)
    tp = c.throughput * uplift(bs.weight)

    t = mp.bsdf_type
    disp_mat = (cc > 0.0) | (sb > 0.0).any(-1)
    refracted = (bs.sampled_type & _TRANSMIT) > 0
    rough_disp = torch.zeros_like(found)
    pdf_mean = bs.pdf
    if bsdf_mod.ROUGHDIELECTRIC in config.bsdf_types:
        # hero MIS through rough dispersive refraction: the companions
        # survive with f_lambda(wi) / mean_k pdf_k(wi)
        etas = dispersive_eta(eta_base[..., None], cc[..., None], lam, sb[..., None, :],
                              sc2[..., None, :])
        f_lam, pdf_lam = [], []
        for j in range(nw):
            f_j, p_j = bsdf_mod.eval_bsdf(mp._replace(eta=etas[..., j]), wo_local, bs.wi,
                                          active=config.bsdf_types)
            f_lam.append(uplift(f_j)[..., j])
            pdf_lam.append(p_j)
        f_lam = torch.stack(f_lam, -1)
        pdf_mean_rd = torch.stack(pdf_lam, -1).mean(-1)
        rough_disp = found & refracted & disp_mat & (t == bsdf_mod.ROUGHDIELECTRIC)
        tp = torch.where(rough_disp[:, None],
                         c.throughput * f_lam
                         / torch.clamp(pdf_mean_rd.detach(), min=1e-12)[:, None], tp)
        pdf_mean = torch.where(rough_disp, pdf_mean_rd, bs.pdf)

    # delta dispersive refraction: the companions terminate, the hero takes
    # the MIS factor N_WAVES, once a path
    dispersive = (found & refracted & ~rough_disp & disp_mat
                  & ((t == bsdf_mod.DIELECTRIC) | (t == bsdf_mod.THINDIELECTRIC)
                     | (t == bsdf_mod.ROUGHDIELECTRIC)))
    first_disp = dispersive & ~c.mono
    lane = torch.arange(nw, device=tp.device)
    kill = first_disp[:, None] & (lane > 0)
    hero_w = torch.where(first_disp[:, None] & (lane == 0), float(nw), 1.0)
    tp = torch.where(kill, 0.0, tp * hero_w)

    alive = found & (pdf_mean > 0) & (tp.amax(-1) > 0)
    cont = alive & (bs.pdf > 0)                     # the guarded gate (module docstring)
    s, u_rr = s.next_1d()
    p_cont = mc.russian_roulette_prob(tp.amax(-1), depth, config.rr_start).detach()
    rr = u_rr < p_cont
    n_gate = c.n_gate
    if n_gate is not None:
        n_gate = n_gate + (alive & ~cont & rr).sum()
    cont = cont & rr
    tp = tp / torch.clamp(p_cont, min=1e-6)[:, None]

    delta_now = bsdf_mod.is_delta(mp) | ((bs.sampled_type & (16 | 32 | 64)) > 0)
    c3 = cont[:, None]
    return _SCarry(
        o=torch.where(c3, new_o, c.o), d=torch.where(c3, wi_world, c.d),
        throughput=torch.where(c3, tp, c.throughput), L=L, active=cont, state=s.state,
        prev_pdf=torch.where(cont, pdf_mean, c.prev_pdf),
        prev_delta=torch.where(cont, delta_now, c.prev_delta),
        mono=c.mono | first_disp, n_gate=n_gate)


def trace_radiance_spectral(scene: Scene, o, d, lam, sampler: Sampler, config: PTConfig,
                            with_gate: bool = False):
    """Spectral radiance samples (B, N_WAVES) along rays at wavelengths lam
    (B, N_WAVES), lam[:, 0] the hero: (L, sampler). `config` specialized;
    with `config.remat` and a graph being recorded each bounce is
    checkpointed. With `with_gate` also the lanes the guarded continue gate
    stopped where JAX's gate would have continued them (int64)."""
    B, dev = o.shape[0], o.device
    nw = lam.shape[-1]
    c = _SCarry(o=o, d=d, throughput=torch.ones(B, nw, device=dev),
                L=torch.zeros(B, nw, device=dev),
                active=torch.ones(B, dtype=torch.bool, device=dev), state=sampler.state,
                prev_pdf=torch.zeros(B, device=dev),
                prev_delta=torch.ones(B, dtype=torch.bool, device=dev),
                mono=torch.zeros(B, dtype=torch.bool, device=dev),
                n_gate=torch.zeros((), dtype=torch.int64, device=dev) if with_gate else None)

    def bounce(c, depth):
        return _spectral_bounce(scene, config, lam, c, depth)

    step = bounce
    if config.remat and torch.is_grad_enabled():
        def step(c, depth):
            return checkpoint(bounce, c, depth, use_reentrant=False)

    for depth in range(config.max_depth):
        c = step(c, depth)
    out = (c.L, Sampler(state=c.state))
    return out + (c.n_gate,) if with_gate else out


def uplift_sigma(sig_rgb, lam):
    """Sigma spectra from RGB coefficients: the surfaces' calibrated 3-band
    uplift, clamped at 0 (the residual basis can undershoot)."""
    return torch.clamp(sp.rgb_to_spectrum(sig_rgb, lam), min=0.0)


def spectral_transmittance(media: media_mod.Media, o, d, t0, t1, lam, modes=None):
    """Per-wavelength transmittance through any media: sigma is constant a
    band in the 3-band model, so the optical depth is the uplift of the RGB
    optical depth, tau_lambda = uplift(-ln T_rgb), exact for every volume
    type scene/media.py holds."""
    T_rgb = media_mod.transmittance(media, o, d, t0, t1, modes)
    tau_rgb = -torch.log(torch.clamp(T_rgb, 1e-30, 1.0))
    return torch.exp(-torch.clamp(sp.rgb_to_spectrum(tau_rgb, lam), min=0.0))


class _SV(NamedTuple):
    o: torch.Tensor
    d: torch.Tensor
    tp: torch.Tensor
    L: torch.Tensor
    active: torch.Tensor
    state: torch.Tensor
    prev_pdf: torch.Tensor
    prev_delta: torch.Tensor


def _spectral_vol_bounce(scene: Scene, media, config: PTConfig, lam, base, c: _SV,
                         depth: int) -> _SV:
    ss_l, st_l, st_hero, blo, bhi, ph_t, ph_g = base
    s = Sampler(state=c.state)

    def uplift(rgb):
        return sp.rgb_to_spectrum(rgb, lam)

    hit = scene_mod.scene_intersect(scene, c.o, c.d)
    it = make_interaction(scene, c.o, c.d, hit, flat=config.flat_shading)
    found = hit.valid & c.active
    t_surf = torch.where(hit.valid, hit.t, 1e8)

    # ---- homogeneous medium event on the in-box segment ----
    inv = 1.0 / torch.where(c.d.abs() < 1e-20, 1e-20, c.d)
    ta, tb = (blo - c.o) * inv, (bhi - c.o) * inv
    near = torch.minimum(ta, tb).amax(-1)
    far = torch.maximum(ta, tb).amin(-1)
    t0 = torch.minimum(torch.clamp(near, min=config.ray_eps), t_surf)
    t1 = torch.minimum(torch.clamp(far, min=config.ray_eps), t_surf)
    seg = torch.clamp(t1 - t0, min=0.0)
    s, u_t = s.next_1d()
    dt = -torch.log(torch.clamp(1.0 - u_t, min=1e-12)) / st_hero
    scat = c.active & (dt < seg)
    t_m = t0 + torch.minimum(dt, seg)
    p_scat = c.o + c.d * t_m[..., None]
    # hero-sampled (detached) pdfs, per-wavelength numerators
    w_scat = ss_l * torch.exp(-st_l * dt[..., None]) / (
        st_hero * torch.exp(-st_hero * dt)).detach()[..., None]
    w_pass = torch.exp(-st_l * seg[..., None]) / torch.clamp(
        torch.exp(-st_hero * seg).detach(), min=1e-30)[..., None]
    tp = c.tp * torch.where(c.active[..., None], torch.where(scat[..., None], w_scat, w_pass), 1.0)

    # ---- escaped to the environment ----
    L = c.L
    if has_env(config):
        env_L, w_env = env_term(scene, c.d, c.prev_pdf, c.prev_delta)
        escaped = c.active & ~hit.valid & ~scat & (scene.env_light_id >= 0)
        L = L + torch.where(escaped[:, None], tp * uplift(env_L) * w_env[:, None], 0.0)

    # ---- surface emission (MIS) ----
    if lights_mod.AREA_LIGHT in config.light_types:
        mat_light, Le, w_hit = emission_term(scene, it, c.o, c.d, c.prev_pdf, c.prev_delta)
        emissive = found & ~scat & (mat_light >= 0)
        L = L + torch.where(emissive[:, None], tp * uplift(Le) * w_hit[:, None], 0.0)

    # ---- NEE from the medium point or the surface ----
    mp = gather_mat_params(scene, it, config.tex_types)
    wo_world = -c.d
    wo_local = it.frame.to_local(wo_world)
    nee_p = torch.where(scat[..., None], p_scat, it.p)
    s, u_sel = s.next_1d()
    s, u_l2 = s.next_2d()
    if config.direct and scene.n_lights > 0:
        ds, Lrad, pdf_l, lpmf = nee_light_sample(scene, config, nee_p, u_sel, u_l2)
        f_surf, pdf_b = bsdf_mod.eval_bsdf(mp, wo_local, it.frame.to_local(ds.d),
                                           active=config.bsdf_types)
        ph_v = phase_mod.eval_phase(ph_t, ph_g, wo_world, ds.d)
        pdf_ph = phase_mod.pdf_phase(ph_t, ph_g, wo_world, ds.d)
        f_l = torch.where(scat[..., None], ph_v[..., None], uplift(f_surf))
        pdf_fwd = torch.where(scat, pdf_ph, pdf_b)
        sh_o = torch.where(scat[..., None], nee_p,
                           _offset_ray(it.p, it.n_geo, ds.d, config.ray_eps))
        blocked = scene_mod.scene_occluded(scene, sh_o, ds.d, config.ray_eps,
                                           ds.dist - 2.0 * config.ray_eps)
        tr_l = spectral_transmittance(media, sh_o, ds.d, config.ray_eps,
                                      ds.dist - 2.0 * config.ray_eps, lam,
                                      modes=config.media_modes)
        contrib = (tp * f_l * tr_l * uplift(Lrad)
                   * nee_weight(config, ds, pdf_l, pdf_fwd)[:, None])
        ok = (found | scat) & ~blocked & (ds.pdf > 0) & (lpmf > 0)
        L = L + torch.where(ok[:, None], contrib, 0.0)

    # ---- continue: phase or BSDF sample ----
    s, u_p2 = s.next_2d()
    ps = phase_mod.sample_phase(ph_t, ph_g, wo_world, u_p2)
    s, u_b2 = s.next_2d()
    s, u_b1 = s.next_1d()
    bs = bsdf_mod.sample_bsdf(mp, wo_local, u_b2, u_b1, active=config.bsdf_types)
    wi_surf = it.frame.to_world(bs.wi)
    new_d = torch.where(scat[..., None], ps.wi, wi_surf)
    new_o = torch.where(scat[..., None], p_scat,
                        _offset_ray(it.p, it.n_geo, wi_surf, config.ray_eps))
    step_w = torch.where(scat[..., None], ps.weight[..., None], uplift(bs.weight))
    new_pdf = torch.where(scat, ps.pdf, bs.pdf)
    tp2 = tp * step_w
    cont = (found | scat) & (new_pdf > 0) & (tp2.amax(-1) > 0)
    s, u_rr = s.next_1d()
    p_cont = mc.russian_roulette_prob(tp2.amax(-1), depth, config.rr_start).detach()
    cont = cont & (u_rr < p_cont)
    tp2 = tp2 / torch.clamp(p_cont, min=1e-6)[:, None]
    delta_now = ~scat & (bsdf_mod.is_delta(mp) | ((bs.sampled_type & (16 | 32 | 64)) > 0))
    c3 = cont[:, None]
    return _SV(o=torch.where(c3, new_o, c.o), d=torch.where(c3, new_d, c.d),
               tp=torch.where(c3, tp2, c.tp), L=L, active=cont, state=s.state,
               prev_pdf=torch.where(cont, new_pdf, c.prev_pdf),
               prev_delta=torch.where(cont, delta_now, c.prev_delta))


def trace_radiance_spectral_vol(scene: Scene, media: media_mod.Media, o, d, lam,
                                sampler: Sampler, config: PTConfig):
    """Spectral volumetric transport through the media's first volume,
    taken as HOMOGENEOUS (collisions inside grids are out of scope, as in
    the JAX package; the shadow rays' transmittance covers any media):
    (L (B, N_WAVES), sampler). `config` specialized, media modes set."""
    B, dev = o.shape[0], o.device
    nw = lam.shape[-1]
    sa_l = uplift_sigma(media.sigma_a[0], lam)
    ss_l = uplift_sigma(media.sigma_s[0], lam)
    st_l = sa_l + ss_l
    st_hero = torch.clamp(st_l[..., 0], min=1e-8).detach()
    ph_t = media.phase_type[0].expand(B)
    ph_g = media.phase_g[0].expand(B)
    base = (ss_l, st_l, st_hero, media.box_min[0], media.box_max[0], ph_t, ph_g)
    c = _SV(o=o, d=d, tp=torch.ones(B, nw, device=dev), L=torch.zeros(B, nw, device=dev),
            active=torch.ones(B, dtype=torch.bool, device=dev), state=sampler.state,
            prev_pdf=torch.zeros(B, device=dev),
            prev_delta=torch.ones(B, dtype=torch.bool, device=dev))
    for depth in range(config.max_depth):
        c = _spectral_vol_bounce(scene, media, config, lam, base, c, depth)
    return c.L, Sampler(state=c.state)


def _camera_lam(scene: Scene, width: int, height: int, spp: int, seed):
    """The pass prologue: row-ordered camera rays, then u_lam and the
    wavelengths. Returns (o, d, w_cam, sampler, lam, pdf_lam)."""
    _, o, d, w_cam, sampler = _camera_batch(scene, width, height, spp, seed)
    sampler, u_lam = sampler.next_1d()
    lam, pdf_lam = sp.sample_wavelengths(u_lam)
    return o, d, w_cam, sampler, lam, pdf_lam


def _render_spectral_body(scene, width, height, spp, seed, config):
    o, d, w_cam, sampler, lam, pdf_lam = _camera_lam(scene, width, height, spp, seed)
    L, _ = trace_radiance_spectral(scene, o, d, lam, sampler, config)
    return _film(sp.spectral_to_rgb(L, lam, pdf_lam) * w_cam, width, height, spp)


def render_spectral(scene: Scene, width: int, height: int, spp: int, seed,
                    config: PTConfig = PTConfig()):
    """One spectral pass on the scene's device: (H, W, 3) linear sRGB.
    Differentiable in every float tensor of the scene that requires grad."""
    config = specialize_config(scene, config)
    return _render_spectral_body(scene, width, height, spp, seed, config)


@torch.no_grad()
def render_spectral_progressive(scene: Scene, width: int, height: int, spp: int,
                                n_passes: int, seed, config: PTConfig = PTConfig()):
    """The mean of `n_passes` spectral passes with seeds seed, seed+1, ...
    (uint32)."""
    config = specialize_config(scene, config)
    acc = torch.zeros(height, width, 3, device=scene.light_cdf.device)
    for i in range(n_passes):
        acc = acc + _render_spectral_body(scene, width, height, spp, (int(seed) + i) & MASK,
                                          config)
    return acc / n_passes


def render_spectral_vol(scene: Scene, media: media_mod.Media, width: int, height: int,
                        spp: int, seed, config: PTConfig = PTConfig()):
    """One spectral volumetric pass: (H, W, 3) linear sRGB (homogeneous
    collisions; see trace_radiance_spectral_vol). Differentiable in the
    scene's and the media's float tensors that require grad."""
    config = _specialize(scene, media, config)
    o, d, w_cam, sampler, lam, pdf_lam = _camera_lam(scene, width, height, spp, seed)
    Ls, _ = trace_radiance_spectral_vol(scene, media, o, d, lam, sampler, config)
    return _film(sp.spectral_to_rgb(Ls, lam, pdf_lam) * w_cam, width, height, spp)
