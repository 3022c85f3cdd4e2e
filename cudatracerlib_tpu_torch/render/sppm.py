"""Stochastic progressive photon mapping with per-pixel adaptive radii and
volumetric photon estimators (port of cudatracerlib_tpu/render/sppm.py).

One pass (`render_sppm_pass`) traces a photon pass, walks one camera ray a
pixel through specular chains to its first smooth vertex (media attenuating
every segment), does NEE there, and folds the photons within the pixel's
radius into its adaptive state (`SPPMState`, the reference's
k_AdaptiveStruct): N' = N + alpha M, r'^2 = r^2 (N + alpha M) / (N + M),
tau' = (tau + phi) r'^2 / r^2. Options, as in the JAX package:
  * kNN first-pass radii (`knn_target`): the first pass sets a pixel's
    r^2 = r0^2 k / M0 from the photon count M0 within r0, clamped;
  * final gathering (`final_gather`): one BSDF sample from the gather vertex
    and the density estimate (and NEE) at its hit instead; the adaptive
    statistics stay frozen;
  * volumetric estimators along the primary camera segment, from the photon
    walk through the media (`trace_photons_vol`, delta tracking): VOL_POINT
    ray marching with a 3-D kernel over volume photons, VOL_BEAM a camera
    beam against photon points (2-D kernel), VOL_BEAMBEAM photon beams
    against the camera beam (1-D kernel). Each queries a hash grid with
    systematic subsampling (`hashgrid.query_sphere_sampled`).

Draw order and streams are the JAX package's: the pass seed is seed ^
n_passes * 0x9E3779B9 in uint32 (int64 words masked, sampling/rng.py),
photons on stream 0xF00D, the eye pass on seed ^ 0x5EED. The photon walk's
delta tracking moves every lane's sampler by the global trip count, as
scene/media.py reproduces it. The volume estimators run the JAX package's
arithmetic as written, in particular `_prefix_transmittance`'s sum over
MAX_VOLUMES volume slots, whose indices beyond the media's count clamp to
its last volume, as JAX's indexing does (ROADMAP queue 3). Forward only:
the entry points run under `torch.no_grad()`, on the scene's device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..accel import hashgrid
from ..accel.traversal import Hit
from ..math.vecmath import PI, dot
from ..sampling.rng import _GOLDEN, MASK, Sampler
from ..scene import bsdf as bsdf_mod
from ..scene import lights as lights_mod
from ..scene import media as media_mod
from ..scene import phase as phase_mod
from ..scene import scene as scene_mod
from ..scene import sensors
from ..scene.scene import Scene, gather_mat_params, make_interaction
from ..scene.shade_pack import build_shade_pack, hit_shading, pack_enabled
from .light_tracer import emit_particles
from .path_tracer import PTConfig, _offset_ray, nee_light_sample, specialize_config
from .ppm import EYE_DEPTH, PPM_ALPHA, PhotonMap, _grid_box, trace_photons

VOL_NONE = 0
VOL_POINT = 1     # ray marching + 3-D kernel (VolEstimators/PointStorage.h)
VOL_BEAM = 2      # camera beam x photon point, 2-D kernel (VolEstimators/BeamGrid.h)
VOL_BEAMBEAM = 3  # photon beam x camera beam, 1-D kernel (VolEstimators/BeamBeamGrid.h)

VOL_CHUNK = 16384  # camera rays a volume estimate takes at once (bounds its (B, S, K) tensors)


class VolPhotonMap(NamedTuple):
    p: torch.Tensor       # (P, 3) scatter positions
    power: torch.Tensor   # (P, 3) flux after the scatter's albedo, over the photons emitted
    wi: torch.Tensor      # (P, 3) direction toward the light path's origin
    valid: torch.Tensor   # (P,)


class PhotonBeams(NamedTuple):
    """Photon flight segments through media: each walk step that crosses a
    volume gives one beam carrying the power entering it."""
    o: torch.Tensor       # (P, 3) segment origin
    d: torch.Tensor       # (P, 3) unit direction
    t: torch.Tensor       # (P,) segment length
    power: torch.Tensor   # (P, 3) entering flux over the photons emitted
    valid: torch.Tensor   # (P,)


class SPPMConfig(NamedTuple):
    base: PTConfig = PTConfig(max_depth=6, rr_start=2)
    n_photons: int = 1 << 17
    radius0: float = 0.07
    max_gather: int = 128
    grid_res: int = 64
    knn_target: int = 0          # photons a first-pass disk aims at; 0: constant r0
    vol_estimator: int = VOL_NONE
    vol_radius0: float = 0.1
    vol_steps: int = 24          # camera-segment steps of the volume estimators
    vol_max_gather: int = 32
    beam_samples: int = 16       # grid sample points a photon beam
    final_gather: bool = False   # one-bounce final gathering at the gather vertex


class SPPMState(NamedTuple):
    """Per-pixel adaptive gather state (k_AdaptiveStruct)."""
    r2: torch.Tensor       # (B,) gather radius^2
    n_acc: torch.Tensor    # (B,) accumulated photon count
    tau: torch.Tensor      # (B, 3) accumulated unnormalized flux
    l_other: torch.Tensor  # (B, 3) accumulated direct, emitted and volumetric radiance
    n_passes: torch.Tensor  # () int64


def sppm_init(n_pixels: int, radius0: float, device="cuda") -> SPPMState:
    B = n_pixels
    return SPPMState(r2=torch.full((B,), radius0 * radius0, dtype=torch.float32, device=device),
                     n_acc=torch.zeros(B, device=device), tau=torch.zeros(B, 3, device=device),
                     l_other=torch.zeros(B, 3, device=device),
                     n_passes=torch.zeros((), dtype=torch.int64, device=device))


def trace_photons_vol(scene: Scene, media: media_mod.Media, n_photons: int, seed,
                      config: PTConfig, with_beams: bool = False):
    """The photon walk through surfaces and media (JAX sppm.py:111-225):
    every bounce samples a medium event before the surface; a surface
    photon is stored at smooth surfaces after the first bounce, a volume
    photon (post-albedo power) at every medium scatter, and a beam for each
    segment that crosses a volume. `config` specialized. Returns (PhotonMap,
    VolPhotonMap[, PhotonBeams]), each of max_depth * n_photons slots,
    depth-major."""
    B, dev = n_photons, scene.light_cdf.device
    smp = Sampler.create(seed, torch.arange(B, device=dev), 0xF00D)
    o, d, w, _, _, smp = emit_particles(scene, B, smp, config)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    pack = build_shade_pack(scene) if pack_enabled(scene) else None
    surf, vol, beams = [], [], []
    for depth in range(config.max_depth):
        hit = scene_mod.scene_intersect(scene, o, d)
        it, mp = hit_shading(scene, o, d, hit, pack, config.tex_types)
        t_surf = torch.where(hit.valid, hit.t, 1e8)
        s, t_m, scat, w_med, vid, p_scat, _ = media_mod.sample_distance(
            media, o, d, config.ray_eps, t_surf, smp)
        w_here = w * torch.where(alive[..., None], w_med, 1.0)
        medium_event = alive & scat
        found = hit.valid & alive & ~scat

        # a surface photon (direct photons left to the eye pass's NEE), a
        # volume photon, and this segment as a beam with its entering power
        store_s = found & bsdf_mod.is_smooth(mp) & (depth > 0)
        surf.append((it.p, torch.where(store_s[..., None], w_here, 0.0), -d, it.frame.n, store_s))
        vol.append((p_scat, torch.where(medium_event[..., None], w_here, 0.0), -d, medium_event))
        t_end = torch.where(scat, t_m, torch.clamp(t_surf, max=1e4))
        beam_valid = alive & media_mod.segment_in_media(media, o, d, config.ray_eps, t_end)
        beams.append((o, d, t_end, torch.where(beam_valid[..., None], w, 0.0), beam_valid))

        # continue: the phase function at medium events, the BSDF at surfaces
        s, u2 = s.next_2d()
        s, u1 = s.next_1d()
        bs = bsdf_mod.sample_bsdf(mp, it.frame.to_local(-d), u2, u1, active=config.bsdf_types)
        wi_surf = it.frame.to_world(bs.wi)
        ps = phase_mod.sample_phase(media.phase_type[vid], media.phase_g[vid], -d, u2)
        me3 = medium_event[..., None]
        new_d = torch.where(me3, ps.wi, wi_surf)
        new_o = torch.where(me3, p_scat, _offset_ray(it.p, it.n_geo, wi_surf, config.ray_eps))
        new_pdf = torch.where(medium_event, ps.pdf, bs.pdf)
        w_new = w_here * torch.where(me3, ps.weight[..., None], bs.weight)
        s, u_rr = s.next_1d()
        p_cont = torch.clamp(w_new.abs().amax(-1), max=0.9)
        cont = (found | medium_event) & (new_pdf > 0) & (u_rr < p_cont)
        w_new = w_new / torch.clamp(p_cont, min=1e-6)[..., None]
        c3 = cont[..., None]
        o = torch.where(c3, new_o, o)
        d = torch.where(c3, new_d, d)
        w = torch.where(c3, w_new, w)
        alive = cont
        smp = s

    sp, spow, swi, sn, sval = (torch.cat(x) for x in zip(*surf))
    vp, vpow, vwi, vval = (torch.cat(x) for x in zip(*vol))
    out = (PhotonMap(p=sp, power=spow / n_photons, wi=swi, n=sn, valid=sval,
                     caustic=torch.zeros_like(sval)),
           VolPhotonMap(p=vp, power=vpow / n_photons, wi=vwi, valid=vval))
    if not with_beams:
        return out
    bo, bd, bt, bpow, bval = (torch.cat(x) for x in zip(*beams))
    return out + (PhotonBeams(o=bo, d=bd, t=bt, power=bpow / n_photons, valid=bval),)


def _prefix_transmittance(media: media_mod.Media, o, d, t_mid):
    """Tr(0 -> t_mid[s]) for every step at once: the cumulative optical
    depth of per-step midpoint segments. As in the JAX package it sums
    MAX_VOLUMES volume slots, a slot past the media's count standing for its
    last volume (JAX's indexing clamps)."""
    B, S = t_mid.shape
    dt = torch.diff(t_mid, dim=1, prepend=torch.zeros(B, 1, device=t_mid.device))
    pts = o[:, None, :] + d[:, None, :] * t_mid[..., None]
    tau_tot = torch.zeros(B, S, 3, device=t_mid.device)
    for v in range(media_mod.MAX_VOLUMES):
        v = min(v, media.count - 1)
        vid = torch.full((B, S), v, dtype=torch.int64, device=t_mid.device)
        dens = media_mod.density_at(media, vid, pts)
        st = (media.sigma_a[v] + media.sigma_s[v])[None, None, :]
        tau_tot = tau_tot + st * dens[..., None] * dt[..., None]
    return torch.exp(-torch.cumsum(tau_tot, dim=1))


def _steps(t_max, n_steps):
    """(t_max clamped, dt, t_mid (B, S)) of a camera segment's steps."""
    t_max = torch.clamp(t_max, max=1e4)
    dt = t_max / n_steps
    t_mid = (torch.arange(n_steps, dtype=torch.float32, device=t_max.device)[None, :] + 0.5) \
        * dt[:, None]
    return t_max, dt, t_mid


def _query(grid, o, d, t_mid, max_gather):
    """The subsampled neighbourhood of every step midpoint: idx, valid (B,
    S, K) and the weights (B, S)."""
    B, S = t_mid.shape
    centers = o[:, None, :] + d[:, None, :] * t_mid[..., None]
    idx, vmask, qw = hashgrid.query_sphere_sampled(grid, centers.reshape(-1, 3), max_gather)
    return (centers, idx.reshape(B, S, max_gather), vmask.reshape(B, S, max_gather),
            qw.reshape(B, S))


def _phase0(media, B, wi, wo):
    """Volume 0's phase function (the estimators' single-medium
    approximation of the phase parameters)."""
    vid0 = torch.zeros(B, dtype=torch.int64, device=wi.device)
    pt = media.phase_type[vid0][:, None, None]
    pg = media.phase_g[vid0][:, None, None]
    return phase_mod.eval_phase(pt, pg, wi, wo)


def _finish_beam(media, o, d, t_mid, ph_wi, ph_pow, use, k2, qw):
    tr_steps = _prefix_transmittance(media, o, d, t_mid)            # (B, S, 3)
    wo = (-d[:, None, None, :]).expand(ph_wi.shape)
    ph = _phase0(media, o.shape[0], ph_wi, wo)
    contrib = torch.where(use[..., None], ph_pow * (ph * k2)[..., None], 0.0)
    per_step = contrib.sum(2) * qw[..., None]                       # (B, S, 3)
    return (per_step * tr_steps).sum(1)


def _beam_estimate(media, grid, vpm: VolPhotonMap, o, d, t_end, radius, max_gather, n_steps):
    """Camera beam x photon points with a 2-D kernel on the distance to the
    camera line (BeamGrid; JAX `_finish_beam_wrapper`)."""
    t_max, dt, t_mid = _steps(t_end, n_steps)
    _, idx, vmask, qw = _query(grid, o, d, t_mid, max_gather)
    ph_p, ph_pow, ph_wi = vpm.p[idx], vpm.power[idx], vpm.wi[idx]
    ok = vmask & vpm.valid[idx]
    rel = ph_p - o[:, None, None, :]
    t_proj = (rel * d[:, None, None, :]).sum(-1)
    d2 = torch.clamp((rel * rel).sum(-1) - t_proj * t_proj, min=0.0)
    cell_lo = t_mid[..., None] - 0.5 * dt[:, None, None]
    cell_hi = t_mid[..., None] + 0.5 * dt[:, None, None]
    in_cell = (t_proj >= cell_lo) & (t_proj < cell_hi)
    in_r = (d2 < radius * radius) & (t_proj > 0) & (t_proj < t_max[:, None, None])
    use = ok & in_cell & in_r
    r = np.float32(radius)
    t2 = torch.clamp(d2 / max(r * r, np.float32(1e-12)), 0.0, 1.0)
    k2 = 2.0 * (1.0 - t2) / float(np.float32(PI) * r * r)
    return _finish_beam(media, o, d, t_mid, ph_wi, ph_pow, use, k2, qw)


def _beambeam_estimate(media, grid, beams: PhotonBeams, samples_per_beam: int, o, d, t_end,
                       radius, max_gather, n_steps):
    """Photon beams x the camera beam with a 1-D kernel on the line-line
    distance (BeamBeamGrid; JAX sppm.py:262-336):
      L = sum K1(dist) p(theta) Phi Tr_cam(t_c) Tr_beam(t_b) sigma_s(x) / sin(theta).
    Each beam is stored at `samples_per_beam` grid points; a candidate
    counts once, where its closest approach falls in both its sample's
    sub-segment and the camera step's cell. Tr_beam takes sigma_t at x as
    constant along the beam."""
    SB = samples_per_beam
    t_cam, dt, t_mid = _steps(t_end, n_steps)
    _, idx, vmask, qw = _query(grid, o, d, t_mid, max_gather)
    bid = idx // SB
    k_smp = idx % SB
    b_o, b_d, b_t, b_pow = beams.o[bid], beams.d[bid], beams.t[bid], beams.power[bid]
    ok = vmask & beams.valid[bid]

    # closest approach between the camera line (o, d) and the beam line
    w0 = o[:, None, None, :] - b_o
    b_dot = (d[:, None, None, :] * b_d).sum(-1)
    denom = 1.0 - b_dot * b_dot
    d_w0 = (d[:, None, None, :] * w0).sum(-1)
    e_w0 = (b_d * w0).sum(-1)
    safe = denom > 1e-6
    inv = 1.0 / torch.clamp(denom, min=1e-6)
    t_c = (b_dot * e_w0 - d_w0) * inv
    t_b = (e_w0 - b_dot * d_w0) * inv
    diff = w0 + d[:, None, None, :] * t_c[..., None] - b_d * t_b[..., None]
    dist = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=0.0))

    cell_lo = t_mid[..., None] - 0.5 * dt[:, None, None]
    cell_hi = t_mid[..., None] + 0.5 * dt[:, None, None]
    in_cam_cell = (t_c >= cell_lo) & (t_c < cell_hi)
    seg = torch.clamp(b_t / SB, min=1e-9)
    in_k = (t_b >= k_smp * seg) & (t_b < (k_smp + 1) * seg)
    use = (ok & safe & in_cam_cell & in_k & (dist < radius) & (t_c > 0)
           & (t_c < t_cam[:, None, None]) & (t_b > 0) & (t_b < b_t))

    x = b_o + b_d * t_b[..., None]
    sig_s, sig_t = media_mod.sigma_at(media, x)
    r = np.float32(radius)
    t2 = torch.clamp((dist / max(r, np.float32(1e-9))) ** 2, 0.0, 1.0)
    k1 = 0.75 * (1.0 - t2) / float(max(r, np.float32(1e-9)))
    sin_th = torch.sqrt(torch.clamp(denom, min=1e-6))
    ph = _phase0(media, o.shape[0], -b_d, (-d[:, None, None, :]).expand(b_d.shape))
    tr_beam = torch.exp(-sig_t * t_b[..., None])
    scal = (k1 * ph / sin_th)[..., None]
    contrib = torch.where(use[..., None], b_pow * sig_s * tr_beam * scal, 0.0)
    per_step = contrib.sum(2) * qw[..., None]                       # (B, S, 3)
    return (per_step * _prefix_transmittance(media, o, d, t_mid)).sum(1)


def _point_estimate(media, grid, vpm: VolPhotonMap, o, d, t_end, radius, max_gather, n_steps):
    """Ray marching with a 3-D kernel over volume photons (PointStorage):
    L = sum_s dt Tr(t_s) sum_k K3(|x_k - x_s|) p(w_k, -d) Phi_k."""
    _, dt, t_mid = _steps(t_end, n_steps)
    centers, idx, vmask, qw = _query(grid, o, d, t_mid, max_gather)
    ph_p, ph_pow, ph_wi = vpm.p[idx], vpm.power[idx], vpm.wi[idx]
    ok = vmask & vpm.valid[idx]
    d2 = ((ph_p - centers[:, :, None, :]) ** 2).sum(-1)
    use = ok & (d2 < radius * radius)
    r = np.float32(radius)
    t2 = torch.clamp(d2 / max(r * r, np.float32(1e-12)), 0.0, 1.0)
    k3 = float(np.float32(15.0) / (np.float32(8.0 * PI) * (r * r * r))) * (1.0 - t2)
    k2w = torch.where(use, k3, 0.0)
    ph = _phase0(media, o.shape[0], ph_wi, (-d[:, None, None, :]).expand(ph_wi.shape))
    per_step = (ph_pow * (ph * k2w)[..., None]).sum(2) * qw[..., None]
    tr_steps = _prefix_transmittance(media, o, d, t_mid)
    return (per_step * tr_steps * dt[:, None, None]).sum(1)


def _gather_parts(grid, pm: PhotonMap, frame, gp, gn, gwo, gathered, mp, q_radius,
                  max_gather: int, cfg: PTConfig):
    """Per candidate photon of each query (at most max_gather from the
    capped `query_sphere`): (d2, validity, normal agreement, the raw BSDF
    value toward the photon, the photon's power)."""
    idx, valid_n = hashgrid.query_sphere(grid, gp, q_radius, max_gather)
    ph_p, ph_pow, ph_wi, ph_n = pm.p[idx], pm.power[idx], pm.wi[idx], pm.n[idx]
    ph_ok = valid_n & pm.valid[idx] & gathered[:, None]
    d2 = ((ph_p - gp[:, None, :]) ** 2).sum(-1)
    n_ok = (ph_n * gn[:, None, :]).sum(-1) > 0.7
    wo_l = frame.to_local(gwo)[:, None, :]
    fs, ft, fn = (x[:, None, :] for x in frame)
    wi_l = torch.stack([dot(ph_wi, fs), dot(ph_wi, ft), dot(ph_wi, fn)], dim=-1)
    mp_b = bsdf_mod.MatParams(*(a[:, None] for a in mp))
    f_ph, _ = bsdf_mod.eval_bsdf(mp_b, wo_l.expand(wi_l.shape), wi_l, active=cfg.bsdf_types)
    f_raw = f_ph / torch.clamp(wi_l[..., 2].abs(), min=1e-6)[..., None]
    return d2, ph_ok, n_ok, f_raw, ph_pow


def _direct_light(scene, media, has_media, cfg, mp, frame, p, n_geo, wo_world, gathered, s):
    """One-sample NEE at a gather or final-gather vertex: (L, sampler)."""
    s, u_sel = s.next_1d()
    s, u_l2 = s.next_2d()
    if scene.n_lights == 0:
        return torch.zeros(p.shape[:-1] + (3,), device=p.device), s
    ds, Lrad, pdf_l, lpmf = nee_light_sample(scene, cfg, p, u_sel, u_l2)
    f_l, _ = bsdf_mod.eval_bsdf(mp, frame.to_local(wo_world), frame.to_local(ds.d),
                                active=cfg.bsdf_types)
    sh_o = _offset_ray(p, n_geo, ds.d, cfg.ray_eps)
    blocked = scene_mod.scene_occluded(scene, sh_o, ds.d, cfg.ray_eps,
                                       ds.dist - 2 * cfg.ray_eps)
    tr_sh = 1.0
    if has_media:
        tr_sh = media_mod.transmittance(media, sh_o, ds.d, cfg.ray_eps,
                                        ds.dist - 2.0 * cfg.ray_eps)
    ok = gathered & ~blocked & (ds.pdf > 0) & (lpmf > 0)
    return torch.where(ok[..., None],
                       f_l * Lrad * tr_sh / torch.clamp(pdf_l, min=1e-12)[..., None], 0.0), s


def _vol_estimate(config: SPPMConfig, media, vgrid, vpm, beams, o, d, t_end):
    """The chosen volume estimator along each primary camera segment, in
    chunks of VOL_CHUNK rays."""
    r = float(np.float32(config.vol_radius0))
    out = []
    for a in range(0, o.shape[0], VOL_CHUNK):
        oc, dc, tc = o[a:a + VOL_CHUNK], d[a:a + VOL_CHUNK], t_end[a:a + VOL_CHUNK]
        if config.vol_estimator == VOL_BEAMBEAM:
            out.append(_beambeam_estimate(media, vgrid, beams, config.beam_samples, oc, dc, tc,
                                          r, config.vol_max_gather, config.vol_steps))
        elif config.vol_estimator == VOL_BEAM:
            out.append(_beam_estimate(media, vgrid, vpm, oc, dc, tc, r, config.vol_max_gather,
                                      config.vol_steps))
        else:
            out.append(_point_estimate(media, vgrid, vpm, oc, dc, tc, r, config.vol_max_gather,
                                       config.vol_steps))
    return torch.cat(out)


def _photon_pass(scene, media, seed, config: SPPMConfig, vol_grid_res: int):
    """(surface PhotonMap, its grid, VolPhotonMap | None, the volume grid |
    None, PhotonBeams | None) of one pass."""
    cfg = config.base
    lo, hi = _grid_box(scene)
    vpm = vgrid = beams = None
    if config.vol_estimator == VOL_BEAMBEAM:
        pm, vpm, beams = trace_photons_vol(scene, media, config.n_photons, seed, cfg,
                                           with_beams=True)
        SB = config.beam_samples
        ks = (torch.arange(SB, dtype=torch.float32, device=pm.p.device) + 0.5) / SB
        pts = (beams.o[:, None, :] + beams.d[:, None, :]
               * (ks[None, :, None] * beams.t[:, None, None])).reshape(-1, 3)
        lo_t = torch.as_tensor(lo, device=pts.device)
        hi_t = torch.as_tensor(hi, device=pts.device)
        pval = (torch.repeat_interleave(beams.valid, SB) & (pts >= lo_t).all(-1)
                & (pts <= hi_t).all(-1))
        vgrid = hashgrid.build_grid(pts, lo, hi, vol_grid_res, valid=pval)
    elif config.vol_estimator != VOL_NONE:
        pm, vpm = trace_photons_vol(scene, media, config.n_photons, seed, cfg)
        vgrid = hashgrid.build_grid(vpm.p, lo, hi, vol_grid_res, valid=vpm.valid)
    else:
        pm = trace_photons(scene, config.n_photons, seed, cfg)
    grid = hashgrid.build_grid(pm.p, lo, hi, config.grid_res, valid=pm.valid)
    return pm, grid, vpm, vgrid, beams


def _sppm_pass(scene: Scene, media, width: int, height: int, seed, state: SPPMState,
               config: SPPMConfig, vol_grid_res: int):
    """One pass (JAX `_sppm_impl`, sppm.py:416-690); `config.base` and
    `grid_res` resolved by `render_sppm_pass`."""
    cfg = config.base
    dev = scene.light_cdf.device
    seed = (int(seed) & MASK) ^ ((state.n_passes * _GOLDEN) & MASK)
    has_media = config.vol_estimator != VOL_NONE
    pm, grid, vpm, vgrid, beams = _photon_pass(scene, media, seed, config, vol_grid_res)

    # ---- eye pass: one sample a pixel a pass ----
    B = width * height
    pixel_id = torch.arange(B, device=dev)
    smp = Sampler.create(seed ^ 0x5EED, pixel_id, 0)
    smp, jitter = smp.next_2d()
    px = (pixel_id % width).to(torch.float32)
    py = (pixel_id // width).to(torch.float32)
    uv = torch.stack([(px + jitter[:, 0]) / width, (py + jitter[:, 1]) / height], -1)
    smp, u_ap = smp.next_2d()
    o_cam, d_cam, w_cam = sensors.sample_ray(scene.camera, uv, u_ap)

    o, d = o_cam, d_cam
    w = torch.ones(B, 3, device=dev)
    L = torch.zeros(B, 3, device=dev)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    gathered = torch.zeros(B, dtype=torch.bool, device=dev)
    gp, gn, gwo, gw = (torch.zeros(B, 3, device=dev) for _ in range(4))
    gprim = torch.zeros(B, dtype=torch.int32, device=dev)
    pack = build_shade_pack(scene) if pack_enabled(scene) else None
    for _ in range(EYE_DEPTH):
        hit = scene_mod.scene_intersect(scene, o, d)
        it, mp = hit_shading(scene, o, d, hit, pack, cfg.tex_types)
        found = hit.valid & alive
        # the media attenuate every segment of the camera walk
        w_seg = w
        if has_media:
            tr_seg = media_mod.transmittance(media, o, d, cfg.ray_eps,
                                             torch.where(hit.valid, hit.t, 1e4))
            w_seg = torch.where(alive[..., None], w * tr_seg, w)
        mat_light = scene.materials.light_id[it.mat_id.long()]
        lid = torch.clamp(mat_light, min=0).long()
        Le = lights_mod.eval_area_emission(scene.lights, lid, it.n_geo, -d)
        L = L + torch.where((found & (mat_light >= 0))[..., None], w_seg * Le, 0.0)

        smooth = bsdf_mod.is_smooth(mp)
        new_gather = found & smooth & ~gathered
        s = smp
        s, u2 = s.next_2d()
        s, u1 = s.next_1d()
        bs = bsdf_mod.sample_bsdf(mp, it.frame.to_local(-d), u2, u1, active=cfg.bsdf_types)
        wi_world = it.frame.to_world(bs.wi)
        cont = found & ~smooth & (bs.pdf > 0)
        c3, g3 = cont[..., None], new_gather[..., None]
        gp = torch.where(g3, it.p, gp)
        gn = torch.where(g3, it.frame.n, gn)
        gwo = torch.where(g3, -d, gwo)
        gw = torch.where(g3, w_seg, gw)
        gprim = torch.where(new_gather, it.prim.to(torch.int32), gprim)
        gathered = gathered | new_gather
        o = torch.where(c3, _offset_ray(it.p, it.n_geo, wi_world, cfg.ray_eps), o)
        d = torch.where(c3, wi_world, d)
        w = torch.where(c3, w_seg * bs.weight, w)
        alive = cont
        smp = s

    # ---- volumetric in-scatter along the primary camera segment ----
    L_pass = L
    if has_media:
        prim_hit = scene_mod.scene_intersect(scene, o_cam, d_cam)
        t_end = torch.where(prim_hit.valid, prim_hit.t, 1e4)
        L_pass = L_pass + _vol_estimate(config, media, vgrid, vpm, beams, o_cam, d_cam, t_end)

    # ---- direct lighting at the gather vertex ----
    g_hit = Hit(t=torch.zeros(B, device=dev), prim=gprim,
                bary=torch.full((B, 2), 1.0 / 3.0, device=dev), valid=gathered)
    it_g = make_interaction(scene, gp, -gwo, g_hit)._replace(p=gp)
    mp_g = gather_mat_params(scene, it_g, cfg.tex_types)
    L_nee, s = _direct_light(scene, media, has_media, cfg, mp_g, it_g.frame, gp, gn, gwo,
                             gathered, smp)
    L_pass = L_pass + gw * L_nee

    # the query radius covers the largest radius a pixel may hold (kNN radii
    # grow to 2 r0; render_sppm_pass sizes the cells for it)
    q_radius = 2.0 * config.radius0 if config.knn_target > 0 else config.radius0

    if config.final_gather:
        # one BSDF sample from the gather vertex, the density estimate and
        # NEE at its hit; the adaptive statistics stay frozen
        s, u_fg2 = s.next_2d()
        s, u_fg1 = s.next_1d()
        bs_fg = bsdf_mod.sample_bsdf(mp_g, it_g.frame.to_local(gwo), u_fg2, u_fg1,
                                     active=cfg.bsdf_types)
        wi_fg = it_g.frame.to_world(bs_fg.wi)
        fg_o = _offset_ray(gp, gn, wi_fg, cfg.ray_eps)
        hit2 = scene_mod.scene_intersect(scene, fg_o, wi_fg)
        it2 = make_interaction(scene, fg_o, wi_fg, hit2)
        mp2 = gather_mat_params(scene, it2, cfg.tex_types)
        ok2 = gathered & hit2.valid & (bs_fg.pdf > 0) & bsdf_mod.is_smooth(mp2)
        r0 = np.float32(config.radius0)
        d2f, okf, nokf, frawf, powf = _gather_parts(grid, pm, it2.frame, it2.p, it2.frame.n,
                                                    -wi_fg, ok2, mp2, q_radius,
                                                    config.max_gather, cfg)
        use_f = okf & (d2f < r0 * r0) & nokf
        L_ind2 = (torch.where(use_f[..., None], frawf * powf, 0.0).sum(1)
                  / float(np.float32(PI) * r0 * r0))
        L_dir2, s = _direct_light(scene, media, has_media, cfg, mp2, it2.frame, it2.p,
                                  it2.n_geo, -wi_fg, ok2, s)
        L_pass = L_pass + torch.where(ok2[..., None], gw * bs_fg.weight * (L_ind2 + L_dir2),
                                      0.0)
        new_state = state._replace(l_other=state.l_other + L_pass * w_cam,
                                   n_passes=state.n_passes + 1)
        return sppm_develop(new_state, width, height), new_state

    # ---- the adaptive surface gather (k_AdaptiveStruct update) ----
    d2, ph_ok, n_ok, f_raw, ph_pow = _gather_parts(grid, pm, it_g.frame, gp, gn, gwo, gathered,
                                                   mp_g, q_radius, config.max_gather, cfg)

    def flux(r2):
        use = ph_ok & (d2 < r2[:, None]) & n_ok
        return (torch.where(use[..., None], f_raw * ph_pow, 0.0).sum(1),
                use.sum(1).to(torch.float32))

    if config.knn_target > 0:
        # the first pass's count M0 within r0 estimates the local density:
        # r^2 = r0^2 k / M0, clamped to [r0 / 8, 2 r0]
        M0 = (ph_ok & (d2 < config.radius0 ** 2) & n_ok).sum(1).to(torch.float32)
        ratio = torch.clamp(config.knn_target / torch.clamp(M0, min=1.0), 1.0 / 64.0, 4.0)
        r2_knn = torch.clamp(state.r2 * ratio, (config.radius0 / 8.0) ** 2,
                             (2.0 * config.radius0) ** 2)
        r2_cur = torch.where((state.n_passes == 0) & gathered, r2_knn, state.r2)
    else:
        r2_cur = state.r2
    phi, M = flux(r2_cur)

    # the SPPM update (Hachisuka & Jensen 2009)
    has = M > 0
    n_new = state.n_acc + PPM_ALPHA * M
    denom = torch.clamp(state.n_acc + M, min=1e-6)
    r2_new = torch.where(has, r2_cur * n_new / denom, r2_cur)
    tau_new = torch.where(has[..., None], (state.tau + gw * phi)
                          * (r2_new / torch.clamp(r2_cur, min=1e-12))[..., None], state.tau)
    new_state = SPPMState(r2=r2_new, n_acc=torch.where(has, n_new, state.n_acc), tau=tau_new,
                          l_other=state.l_other + L_pass * w_cam,
                          n_passes=state.n_passes + 1)
    return sppm_develop(new_state, width, height), new_state


def sppm_develop(state: SPPMState, width: int, height: int):
    """The image of the accumulated state:
    L = tau / (n_passes pi r^2) + l_other / n_passes."""
    n = torch.clamp(state.n_passes.to(torch.float32), min=1.0)
    ind = state.tau / (n * PI * torch.clamp(state.r2, min=1e-12))[..., None]
    return (ind + state.l_other / n).reshape(height, width, 3)


def grid_resolutions(scene: Scene, config: SPPMConfig):
    """(surface grid res, volume grid res) from the scene's extent (JAX
    sppm.py:383-404): cells no smaller than the largest query radius; for
    photon beams no smaller than 2 r + the longest beam sub-segment, so a
    beam's owning sample lies in the 3^3 cells of the camera step that owns
    the closest approach."""
    lo, hi = np.asarray(scene.bvh.world_min), np.asarray(scene.bvh.world_max)
    extent = float(np.min(hi - lo)) + 2e-3
    q_r = 2.0 * config.radius0 if config.knn_target > 0 else config.radius0
    res = max(4, min(config.grid_res, int(extent / max(q_r, 1e-6))))
    if config.vol_estimator == VOL_BEAMBEAM:
        seg_max = float(np.linalg.norm(hi - lo)) / config.beam_samples
        c_bb = 2.0 * config.vol_radius0 + seg_max
        vres = max(4, min(config.grid_res, int(extent / max(c_bb, 1e-6))))
    else:
        vres = max(4, min(config.grid_res, int(extent / max(config.vol_radius0, 1e-6))))
    return res, vres


@torch.no_grad()
def render_sppm_pass(scene: Scene, width: int, height: int, seed, state: SPPMState | None,
                     config: SPPMConfig = SPPMConfig(), media: media_mod.Media | None = None):
    """One SPPM pass on the scene's device: (image (H, W, 3), new state).
    `state=None` starts a new image; without `media` the volume estimator
    is off."""
    res, vres = grid_resolutions(scene, config)
    config = config._replace(base=specialize_config(scene, config.base), grid_res=res)
    dev = scene.light_cdf.device
    if media is None:
        media = media_mod.Media.empty(device=dev)
        config = config._replace(vol_estimator=VOL_NONE)
    if state is None:
        state = sppm_init(width * height, config.radius0, device=dev)
    return _sppm_pass(scene, media, width, height, seed, state, config, vres)
