"""Path guiding: per-cell histograms of incident-radiance directions,
learned from photons and mixed into BSDF sampling with one-sample MIS
(port of cudatracerlib_tpu/render/guided.py).

The guiding distribution of a spatial cell (models/grid.py) is a histogram
over N_DIR_BINS^2 bins of the cylindrical equal-area direction map, which
gives exact pdfs and CDF-inversion sampling. Training (`train_guiding`)
runs the photon pass of render/ppm.py and deposits each stored photon's
luminance at (its cell, the bin of its direction toward the light); the
deposit, JAX's `segment_sum`, is the deterministic row sum of
ops/shade_gather.py (`packed_gather_bwd`, one column: the kernels on the
card), so a trained histogram is the same on every run, as XLA's sum is.
The guided walk (`trace_radiance_guided`) mirrors the path tracer's bounce,
its BSDF step a one-sample mixture of the BSDF and the cell's histogram
with pdf a * pdf_guide + (1 - a) * pdf_bsdf at the chosen direction:
unbiased for any histogram content. Hits are shaded through the shade pack
where it applies (`shade_pack.hit_shading`), as in JAX.

Lanes are in row order (tile(arange(W H), spp)); the draws a bounce are
u_sel, u_l2, u_b2, u_b1, u_pick, u_g1, u_rr, and the guided sample reuses
u_b2 for its position inside the bin, as in JAX. `_dir_to_uv`'s atan2 and
the per-cell CDF (torch's CPU cumsum accumulates float32 in float64, XLA's
in float32) can put a lane one bin over from JAX's at a bin edge
(tests/test_torch_guided.py counts such lanes).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..math import montecarlo as mc
from ..math.spectrum import luminance
from ..math.vecmath import PI
from ..models.discretized import segment_sum
from ..models.grid import ModelGrid, cell_of_position, make_model_grid
from ..sampling.rng import Sampler
from ..scene import bsdf as bsdf_mod
from ..scene import lights as lights_mod
from ..scene import scene as scene_mod
from ..scene import shade_pack as sp_mod
from ..scene.scene import Scene
from .path_tracer import (PTConfig, _offset_ray, emission_term, env_term, has_env,
                          nee_light_sample, nee_weight, specialize_config)
from .ppm import trace_photons
from .volpath import _camera_batch, _film

N_DIR_BINS = 8  # a side: 8 x 8 = 64 direction bins a cell


class Guiding(NamedTuple):
    grid: ModelGrid
    hist: torch.Tensor   # (C, N_DIR_BINS^2) accumulated luminance a direction bin


def make_guiding(scene: Scene, res: int = 8) -> Guiding:
    """An empty guiding state over the scene's box (padded by 1e-3), res^3
    cells, on the scene's device."""
    dev = scene.light_cdf.device
    grid = make_model_grid(scene.bvh.world_min - 1e-3, scene.bvh.world_max + 1e-3, res,
                           device=dev)
    return Guiding(grid=grid, hist=torch.zeros(res ** 3, N_DIR_BINS * N_DIR_BINS, device=dev))


def _dir_to_uv(d):
    """Cylindrical equal-area map u = phi / 2 pi, v = (1 + z) / 2 (area
    preserving, so pdf_dir = pdf_uv / 4 pi)."""
    u = torch.atan2(d[..., 1], d[..., 0]) / (2.0 * PI) + 0.5
    v = (d[..., 2] + 1.0) * 0.5
    return torch.stack([torch.clamp(u, 0.0, 1.0 - 1e-6), torch.clamp(v, 0.0, 1.0 - 1e-6)], -1)


def _uv_to_dir(uv):
    phi = (uv[..., 0] - 0.5) * (2.0 * PI)
    z = uv[..., 1] * 2.0 - 1.0
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def _bin_of(uv):
    b = torch.clamp((uv * N_DIR_BINS).to(torch.int32), 0, N_DIR_BINS - 1)
    return b[..., 1] * N_DIR_BINS + b[..., 0]


def deposit_rows(guiding: Guiding, pm):
    """(flat histogram row (P,) int32, luminance (P,), 0 where invalid) of
    a photon map's deposits."""
    lum = luminance(pm.power)
    flat = cell_of_position(guiding.grid, pm.p) * (N_DIR_BINS * N_DIR_BINS) + _bin_of(
        _dir_to_uv(pm.wi))
    return flat, torch.where(pm.valid, lum, 0.0)


@torch.no_grad()
def train_guiding(scene: Scene, guiding: Guiding, n_photons: int, seed,
                  config: PTConfig) -> Guiding:
    """One training batch: a photon pass (render/ppm.trace_photons), its
    deposits summed into the histogram."""
    config = specialize_config(scene, config)
    pm = trace_photons(scene, n_photons, seed, config)
    flat, lum = deposit_rows(guiding, pm)
    upd = segment_sum(lum, flat, guiding.hist.numel())
    return guiding._replace(hist=guiding.hist + upd.reshape(guiding.hist.shape))


def _guided_sample(guiding: Guiding, p, u_sel, u2):
    """A direction from the cell's histogram: (dir, pdf_sa, usable), usable
    False where the cell holds no data."""
    h = guiding.hist[cell_of_position(guiding.grid, p).long()]    # (B, NB^2)
    tot = h.sum(-1, keepdim=True)
    usable = tot[..., 0] > 0
    cdf = torch.cumsum(h / torch.clamp(tot, min=1e-12), -1)
    b = torch.clamp((cdf < u_sel[..., None]).sum(-1), max=h.shape[-1] - 1)
    p_bin = h.gather(-1, b[..., None])[..., 0] / torch.clamp(tot[..., 0], min=1e-12)
    bu = (b % N_DIR_BINS).to(torch.float32)
    bv = (b // N_DIR_BINS).to(torch.float32)
    uv = torch.stack([(bu + u2[..., 0]) / N_DIR_BINS, (bv + u2[..., 1]) / N_DIR_BINS], -1)
    pdf_sa = p_bin * (N_DIR_BINS * N_DIR_BINS) / (4.0 * PI)
    return _uv_to_dir(uv), pdf_sa, usable


def _guided_pdf(guiding: Guiding, p, d):
    h = guiding.hist[cell_of_position(guiding.grid, p).long()]
    tot = torch.clamp(h.sum(-1), min=1e-12)
    b = _bin_of(_dir_to_uv(d)).long()
    return h.gather(-1, b[..., None])[..., 0] / tot * (N_DIR_BINS * N_DIR_BINS) / (4.0 * PI)


class _GCarry(NamedTuple):
    o: torch.Tensor
    d: torch.Tensor
    throughput: torch.Tensor
    L: torch.Tensor
    active: torch.Tensor
    state: torch.Tensor
    prev_pdf: torch.Tensor
    prev_delta: torch.Tensor


def _guided_bounce(scene: Scene, guiding: Guiding, config: PTConfig, guide_prob: float, pack,
                   c: _GCarry, depth: int) -> _GCarry:
    s = Sampler(state=c.state)
    hit = scene_mod.scene_intersect(scene, c.o, c.d)
    it, mp = sp_mod.hit_shading(scene, c.o, c.d, hit, pack, config.tex_types,
                                flat=config.flat_shading)
    found = hit.valid & c.active
    L = c.L

    # environment and emission with MIS, as the path tracer
    if has_env(config):
        env_L, w_env = env_term(scene, c.d, c.prev_pdf, c.prev_delta)
        escaped = c.active & ~hit.valid & (scene.env_light_id >= 0)
        L = L + torch.where(escaped[..., None], c.throughput * env_L * w_env[..., None], 0.0)
    if lights_mod.AREA_LIGHT in config.light_types:
        mat_light, Le, w_hit = emission_term(scene, it, c.o, c.d, c.prev_pdf, c.prev_delta)
        emissive = found & (mat_light >= 0)
        L = L + torch.where(emissive[..., None], c.throughput * Le * w_hit[..., None], 0.0)

    wo_world = -c.d
    wo_local = it.frame.to_local(wo_world)
    smooth = bsdf_mod.is_smooth(mp)

    # NEE, MIS-weighted against the mixture pdf the walk would use
    s, u_sel = s.next_1d()
    s, u_l2 = s.next_2d()
    if config.direct and scene.n_lights > 0:
        ds, Lrad, pdf_l, lpmf = nee_light_sample(scene, config, it.p, u_sel, u_l2)
        f_l, pdf_b_l = bsdf_mod.eval_bsdf(mp, wo_local, it.frame.to_local(ds.d),
                                          active=config.bsdf_types)
        a = torch.where(smooth, guide_prob, 0.0)
        pdf_fwd = a * _guided_pdf(guiding, it.p, ds.d) + (1.0 - a) * pdf_b_l
        sh_o = _offset_ray(it.p, it.n_geo, ds.d, config.ray_eps)
        blocked = scene_mod.scene_occluded(scene, sh_o, ds.d, config.ray_eps,
                                           ds.dist - 2.0 * config.ray_eps)
        ok = found & ~blocked & (ds.pdf > 0) & (lpmf > 0)
        L = L + torch.where(ok[..., None], c.throughput * f_l * Lrad
                            * nee_weight(config, ds, pdf_l, pdf_fwd)[..., None], 0.0)

    # ---- the BSDF / guide mixture ----
    s, u_b2 = s.next_2d()
    s, u_b1 = s.next_1d()
    s, u_pick = s.next_1d()
    s, u_g1 = s.next_1d()
    bs = bsdf_mod.sample_bsdf(mp, wo_local, u_b2, u_b1, active=config.bsdf_types)
    wi_bsdf = it.frame.to_world(bs.wi)
    d_guided, _, usable = _guided_sample(guiding, it.p, u_g1, u_b2)
    a = torch.where(smooth & usable, guide_prob, 0.0)
    take_guided = u_pick < a
    wi_world = torch.where(take_guided[..., None], d_guided, wi_bsdf)
    f_chosen, pdf_b_chosen = bsdf_mod.eval_bsdf(mp, wo_local, it.frame.to_local(wi_world),
                                                active=config.bsdf_types)
    pdf_mix = a * _guided_pdf(guiding, it.p, wi_world) + (1.0 - a) * pdf_b_chosen
    # delta lobes can be neither guided nor evaluated: their lanes keep the
    # BSDF sample's weight (a = 0 there)
    step_w = torch.where(smooth[..., None], f_chosen / torch.clamp(pdf_mix, min=1e-12)[..., None],
                         bs.weight)
    step_pdf = torch.where(smooth, pdf_mix, bs.pdf)

    new_o = _offset_ray(it.p, it.n_geo, wi_world, config.ray_eps)
    throughput = c.throughput * step_w
    cont = found & (step_pdf > 0) & (throughput.abs().amax(-1) > 0)
    s, u_rr = s.next_1d()
    p_cont = mc.russian_roulette_prob(throughput.amax(-1), depth, config.rr_start).detach()
    cont = cont & (u_rr < p_cont)
    throughput = throughput / torch.clamp(p_cont, min=1e-6)[..., None]
    delta_now = ~smooth & (bsdf_mod.is_delta(mp) | ((bs.sampled_type & (16 | 32 | 64)) > 0))
    c3 = cont[..., None]
    return _GCarry(o=torch.where(c3, new_o, c.o), d=torch.where(c3, wi_world, c.d),
                   throughput=torch.where(c3, throughput, c.throughput), L=L, active=cont,
                   state=s.state, prev_pdf=torch.where(cont, step_pdf, c.prev_pdf),
                   prev_delta=torch.where(cont, delta_now, c.prev_delta))


def trace_radiance_guided(scene: Scene, guiding: Guiding, o, d, sampler: Sampler,
                          config: PTConfig, guide_prob: float = 0.5):
    """Guided unidirectional path tracing (NEE + MIS): (L (B, 3), sampler).
    `config` specialized. The shade pack is built once here, outside the
    bounce loop, where it applies."""
    B, dev = o.shape[0], o.device
    pack = sp_mod.build_shade_pack(scene) if sp_mod.pack_enabled(scene) else None
    c = _GCarry(o=o, d=d, throughput=torch.ones(B, 3, device=dev), L=torch.zeros(B, 3, device=dev),
                active=torch.ones(B, dtype=torch.bool, device=dev), state=sampler.state,
                prev_pdf=torch.zeros(B, device=dev),
                prev_delta=torch.ones(B, dtype=torch.bool, device=dev))
    for depth in range(config.max_depth):
        c = _guided_bounce(scene, guiding, config, guide_prob, pack, c, depth)
    return c.L, Sampler(state=c.state)


def render_guided(scene: Scene, guiding: Guiding, width: int, height: int, spp: int, seed,
                  config: PTConfig = PTConfig(), guide_prob: float = 0.5):
    """One guided pass on the scene's device: (H, W, 3) radiance.
    Differentiable in the scene's float tensors that require grad."""
    config = specialize_config(scene, config)
    _, o, d, w_cam, sampler = _camera_batch(scene, width, height, spp, seed)
    L, _ = trace_radiance_guided(scene, guiding, o, d, sampler, config, guide_prob)
    return _film(L * w_cam, width, height, spp)
