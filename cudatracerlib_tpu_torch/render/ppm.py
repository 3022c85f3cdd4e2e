"""Progressive photon mapping (port of cudatracerlib_tpu/render/ppm.py:42-443).

One pass = a photon pass (emit from the lights, walk, deposit a photon at
every smooth surface after the first bounce) and an eye pass (walk the
camera rays through specular chains to the first smooth vertex, NEE there,
then a kernel density estimate over the photons). Caustic photons (every
bounce before the deposit specular) form their own map, gathered at a
smaller radius. The radius shrinks with the pass index as
r_n^2 = r_0^2 prod (i + alpha) / (i + 1).

The density estimate dispatches on the scene's device and its BSDFs: on the
card, when every smooth gather surface is DIFFUSE, the photon-major kernel
(ops/photon_gather.py, the CUDA kernel) sums each query over cell-sorted
photon tiles exhaustively; otherwise the query-major hash-grid lookup
(accel/hashgrid.py) gathers at most `max_gather` photons per query, as the
JAX package's CPU path does.

Draw order and streams are the JAX package's (0xF00D for photons,
seed ^ 0x5EED for the eye pass), and the interaction frames are built with
flat=False, as the JAX module does on every scene, so the CPU port traces the
JAX package's photons lane for lane. Forward only: entry points run under
`torch.no_grad()`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..accel import hashgrid
from ..accel.traversal import Hit
from ..image import film as film_mod
from ..math.vecmath import INV_PI, PI, dot
from ..ops import photon_gather as pg
from ..sampling.rng import MASK, Sampler
from ..scene import bsdf as bsdf_mod
from ..scene import lights as lights_mod
from ..scene import scene as scene_mod
from ..scene import sensors
from ..scene.scene import Scene, gather_mat_params, make_interaction
from ..scene.shade_pack import build_shade_pack, hit_shading, pack_enabled
from .light_tracer import emit_particles
from .path_tracer import PTConfig, _offset_ray, nee_light_sample, specialize_config

PPM_ALPHA = 0.75  # reference PhotonMapHelper.h ALPHA
EYE_DEPTH = 5     # specular bounces the camera walk may take to its gather vertex


class PhotonMap(NamedTuple):
    p: torch.Tensor        # (P, 3) positions
    power: torch.Tensor    # (P, 3) flux, already divided by the photons emitted
    wi: torch.Tensor       # (P, 3) incoming direction (toward the light path)
    n: torch.Tensor        # (P, 3) shading normal at the deposit
    valid: torch.Tensor    # (P,) bool
    caustic: torch.Tensor  # (P,) bool: every bounce before the deposit was specular


class PPMConfig(NamedTuple):
    base: PTConfig = PTConfig(max_depth=6, rr_start=2)
    n_photons: int = 1 << 17
    radius0: float = 0.07
    max_gather: int = 128
    grid_res: int = 64
    caustic_map: bool = True
    caustic_radius_scale: float = 0.4


def _device(scene: Scene):
    return scene.light_cdf.device


def trace_photons(scene: Scene, n_photons: int, seed, config: PTConfig,
                  with_stats: bool = False):
    """Photon pass: emit, walk, deposit. `config` must be specialized.
    Returns a PhotonMap of (max_depth * n_photons) slots, depth-major; with
    `with_stats` also the rays traced (alive walk lanes summed over bounces),
    an int64 tensor."""
    B, dev = n_photons, _device(scene)
    smp = Sampler.create(int(seed) & MASK, torch.arange(B, device=dev), 0xF00D)
    o, d, w, _, _, smp = emit_particles(scene, B, smp, config)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    spec_chain = torch.ones(B, dtype=torch.bool, device=dev)
    pack = build_shade_pack(scene) if pack_enabled(scene) else None
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)
    deposits = []

    for depth in range(config.max_depth):
        n_rays = n_rays + alive.sum()
        hit = scene_mod.scene_intersect(scene, o, d)
        it, mp = hit_shading(scene, o, d, hit, pack, config.tex_types)
        found = hit.valid & alive

        # deposit at smooth surfaces; the first hit is left to the eye pass's
        # NEE (no double counting of direct light)
        store = found & bsdf_mod.is_smooth(mp) & (depth > 0)
        deposits.append((it.p, torch.where(store[..., None], w, 0.0), -d, it.frame.n,
                         store, store & spec_chain))

        # continue: sample the BSDF in importance (adjoint) mode
        s = smp
        s, u2 = s.next_2d()
        s, u1 = s.next_1d()
        bs = bsdf_mod.sample_bsdf(mp, it.frame.to_local(-d), u2, u1, active=config.bsdf_types)
        wi_world = it.frame.to_world(bs.wi)
        w_new = w * bs.weight
        s, u_rr = s.next_1d()
        p_cont = torch.clamp(bs.weight.abs().amax(-1), max=0.9)
        cont = found & (bs.pdf > 0) & (u_rr < p_cont)
        w_new = w_new / torch.clamp(p_cont, min=1e-6)[..., None]
        delta_now = bsdf_mod.is_delta(mp) | ((bs.sampled_type & (16 | 32 | 64)) > 0)
        c3 = cont[..., None]
        o = torch.where(c3, _offset_ray(it.p, it.n_geo, wi_world, config.ray_eps), o)
        d = torch.where(c3, wi_world, d)
        w = torch.where(c3, w_new, w)
        alive = cont
        spec_chain = spec_chain & delta_now
        smp = s

    p, power, wi, n, valid, caustic = (torch.cat(x) for x in zip(*deposits))
    pm = PhotonMap(p=p, power=power / n_photons, wi=wi, n=n, valid=valid, caustic=caustic)
    return (pm, n_rays) if with_stats else pm


def progressive_radius(r0, pass_idx) -> np.float32:
    """r_n = r_0 sqrt(prod_{i=1..n} (i + alpha) / (i + 1)), in float32, the
    factors multiplied in order (PhotonMapHelper.h:18-21)."""
    prod = np.float32(1.0)
    for i in range(1, 256):
        fi = np.float32(i)
        if fi <= np.float32(pass_idx):
            prod = prod * ((fi + np.float32(PPM_ALPHA)) / (fi + np.float32(1.0)))
    return np.float32(r0) * np.sqrt(prod)


def ppm_uses_kernel(cfg: PTConfig, device) -> bool:
    """The photon-major kernel estimate applies on the card when every
    smooth gather surface is DIFFUSE (f = albedo / pi then factors out of
    the photon sum)."""
    delta_types = {bsdf_mod.DIELECTRIC, bsdf_mod.THINDIELECTRIC, bsdf_mod.CONDUCTOR}
    if cfg.bsdf_types is None:
        return False
    smooth_types = set(cfg.bsdf_types) - delta_types
    return smooth_types <= {bsdf_mod.DIFFUSE} and torch.device(device).type == "cuda"


def _grid_box(scene: Scene):
    return scene.bvh.world_min - 1e-3, scene.bvh.world_max + 1e-3


def build_photon_grids(scene: Scene, pm: PhotonMap, config: PPMConfig):
    """(global grid, caustic grid | None) for the query-major estimate;
    (None, None) where the photon-major kernel runs (it never reads them)."""
    if ppm_uses_kernel(config.base, _device(scene)):
        return (None, None)
    lo, hi = _grid_box(scene)
    if not config.caustic_map:
        return (hashgrid.build_grid(pm.p, lo, hi, config.grid_res, valid=pm.valid), None)
    return (hashgrid.build_grid(pm.p, lo, hi, config.grid_res, valid=pm.valid & ~pm.caustic),
            hashgrid.build_grid(pm.p, lo, hi, config.grid_res, valid=pm.valid & pm.caustic))


def ppm_eye_pass(scene: Scene, pm: PhotonMap, grids, pixel_id, sample_idx, seed, radius,
                 width: int, height: int, config: PPMConfig) -> film_mod.Film:
    """Eye pass over a pixel / sample batch -> Film (unnormalized). `grids`
    from build_photon_grids; `radius` a float32 host scalar (the caustic map
    gathers at radius * caustic_radius_scale)."""
    grid, grid_caustic = grids
    cfg = config.base
    dev = pixel_id.device
    B = pixel_id.shape[0]
    smp = Sampler.create((int(seed) & MASK) ^ 0x5EED, pixel_id, sample_idx)
    smp, jitter = smp.next_2d()
    px = (pixel_id % width).to(torch.float32)
    py = (pixel_id // width).to(torch.float32)
    uv = torch.stack([(px + jitter[:, 0]) / width, (py + jitter[:, 1]) / height], -1)
    smp, u_ap = smp.next_2d()
    o, d, w_cam = sensors.sample_ray(scene.camera, uv, u_ap)

    w = torch.ones(B, 3, device=dev)
    L = torch.zeros(B, 3, device=dev)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    gathered = torch.zeros(B, dtype=torch.bool, device=dev)
    gp, gn, gwo = (torch.zeros(B, 3, device=dev) for _ in range(3))
    gprim = torch.zeros(B, dtype=torch.int32, device=dev)
    pack = build_shade_pack(scene) if pack_enabled(scene) else None

    # walk through delta surfaces to the first smooth vertex
    for _ in range(EYE_DEPTH):
        hit = scene_mod.scene_intersect(scene, o, d)
        it, mp = hit_shading(scene, o, d, hit, pack, cfg.tex_types)
        found = hit.valid & alive

        # emission picked up along the specular chain
        mat_light = scene.materials.light_id[it.mat_id.long()]
        lid = torch.clamp(mat_light, min=0).long()
        Le = lights_mod.eval_area_emission(scene.lights, lid, it.n_geo, -d)
        L = L + torch.where((found & (mat_light >= 0))[..., None], w * Le, 0.0)

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
        gprim = torch.where(new_gather, it.prim.to(torch.int32), gprim)
        gathered = gathered | new_gather
        o = torch.where(c3, _offset_ray(it.p, it.n_geo, wi_world, cfg.ray_eps), o)
        w = torch.where(c3, w * bs.weight, w)
        d = torch.where(c3, wi_world, d)
        alive = cont
        smp = s

    # direct lighting at the gather vertex (NEE, one sample)
    g_hit = Hit(t=torch.zeros(B, device=dev), prim=gprim,
                bary=torch.full((B, 2), 1.0 / 3.0, device=dev), valid=gathered)
    it_g = make_interaction(scene, gp, -gwo, g_hit)._replace(p=gp)
    mp_g = gather_mat_params(scene, it_g, cfg.tex_types)
    s = smp
    s, u_sel = s.next_1d()
    s, u_l2 = s.next_2d()
    if scene.n_lights > 0:
        ds, Lrad, pdf_l, lpmf = nee_light_sample(scene, cfg, gp, u_sel, u_l2)
        f_l, _ = bsdf_mod.eval_bsdf(mp_g, it_g.frame.to_local(gwo), it_g.frame.to_local(ds.d),
                                    active=cfg.bsdf_types)
        sh_o = _offset_ray(gp, gn, ds.d, cfg.ray_eps)
        blocked = scene_mod.scene_occluded(scene, sh_o, ds.d, cfg.ray_eps,
                                           ds.dist - 2 * cfg.ray_eps)
        ok = gathered & ~blocked & (ds.pdf > 0) & (lpmf > 0)
        L = L + torch.where(ok[..., None],
                            w * f_l * Lrad / torch.clamp(pdf_l, min=1e-12)[..., None], 0.0)

    # ---- photon density estimate (EntryEstimator.h:25-59) ----
    lo, hi = _grid_box(scene)
    res = config.grid_res

    def density_packed(sel_valid, r):
        """Photon-major: every photon of the map within r of each query."""
        tiles, aabbs = pg.build_photon_tiles(pm.p, pm.power, pm.n, pm.valid & sel_valid,
                                             lo, hi, res, wi=pm.wi)
        # cell-sort the queries: the kernel culls tiles per block of queries,
        # which needs spatially compact blocks
        box_min = torch.as_tensor(lo, dtype=torch.float32, device=dev)
        inv_cell = res / torch.clamp(torch.as_tensor(hi - lo, dtype=torch.float32, device=dev),
                                     min=1e-9)
        cid = hashgrid.cell_index(box_min, inv_cell, res, gp)
        order = torch.sort(torch.where(gathered, cid, res ** 3), stable=True)[1]
        flux, _ = pg.photon_density(tiles, aabbs, gp[order], gn[order], gathered[order], r)
        flux = torch.empty_like(flux).index_copy_(0, order, flux)
        # f = albedo / pi (diffuse); kernel normalization 2 / (pi r^2)
        return mp_g.albedo * INV_PI * flux * float(np.float32(2.0) / (np.float32(PI) * r * r))

    def density_grid(g, sel_valid, r):
        """Query-major: at most max_gather photons of the 27 cells around
        each query, weighted by the BSDF."""
        idx, valid_n = hashgrid.query_sphere(g, gp, r, config.max_gather)
        ph_p, ph_pow, ph_wi, ph_n = pm.p[idx], pm.power[idx], pm.wi[idx], pm.n[idx]
        ph_ok = valid_n & sel_valid[idx] & gathered[:, None]
        diff = ph_p - gp[:, None, :]
        d2 = dot(diff, diff)
        r2 = float(r * r)
        in_r = d2 < r2
        n_ok = dot(ph_n, gn[:, None, :]) > 0.7   # normal agreement (EntryEstimator)
        use = ph_ok & in_r & n_ok
        wo_l = it_g.frame.to_local(gwo)[:, None, :]
        fs, ft, fn = (x[:, None, :] for x in it_g.frame)
        wi_l = torch.stack([dot(ph_wi, fs), dot(ph_wi, ft), dot(ph_wi, fn)], dim=-1)
        mp_b = bsdf_mod.MatParams(*(a[:, None] for a in mp_g))
        f_ph, _ = bsdf_mod.eval_bsdf(mp_b, wo_l.expand(wi_l.shape), wi_l, active=cfg.bsdf_types)
        # remove the cosine folded into eval: the estimate needs the raw f
        f_raw = f_ph / torch.clamp(wi_l[..., 2].abs(), min=1e-6)[..., None]
        # Epanechnikov kernel weight (Math/Kernel.h), integrating to 1 on the disk
        t2 = torch.clamp(d2 / max(np.float32(r2), np.float32(1e-12)), 0.0, 1.0)
        kw = 2.0 * (1.0 - t2) / float(np.float32(PI) * r * r)
        return torch.where(use[..., None], f_raw * ph_pow * kw[..., None], 0.0).sum(1)

    r = np.float32(radius)
    r_c = r * np.float32(config.caustic_radius_scale)
    if ppm_uses_kernel(cfg, dev):
        if not config.caustic_map:
            L = L + w * density_packed(pm.valid, r)
        else:
            L = L + w * density_packed(~pm.caustic, r)
            L = L + w * density_packed(pm.caustic, r_c)
    elif grid_caustic is None:
        L = L + w * density_grid(grid, pm.valid, r)
    else:
        L = L + w * density_grid(grid, pm.valid & ~pm.caustic, r)
        L = L + w * density_grid(grid_caustic, pm.valid & pm.caustic, r_c)

    film = film_mod.Film.create(height, width, device=dev)
    return film_mod.add_samples(film, pixel_id, L * w_cam)


@torch.no_grad()
def render_ppm_pass(scene: Scene, width: int, height: int, spp: int, seed, pass_idx,
                    config: PPMConfig = PPMConfig()):
    """One PPM pass on the scene's device: photon pass + eye pass. Returns an
    (H, W, 3) image whose average over passes converges (the radius follows
    pass_idx)."""
    base = specialize_config(scene, config.base)
    # cells no smaller than the initial radius: the 3^3-cell neighbourhood
    # then covers the gather sphere
    extent = float(np.min(np.asarray(scene.bvh.world_max) - np.asarray(scene.bvh.world_min))) + 2e-3
    res = max(4, min(config.grid_res, int(extent / max(config.radius0, 1e-6))))
    config = config._replace(base=base, grid_res=res)
    radius = progressive_radius(config.radius0, pass_idx)
    dev = _device(scene)
    pm = trace_photons(scene, config.n_photons, seed, base)
    grids = build_photon_grids(scene, pm, config)
    n_px = width * height
    pixel_id = torch.arange(n_px, device=dev).repeat(spp)
    sample_idx = torch.arange(spp, device=dev).repeat_interleave(n_px)
    film = ppm_eye_pass(scene, pm, grids, pixel_id, sample_idx, seed, radius,
                        width, height, config)
    return film_mod.develop(film)
