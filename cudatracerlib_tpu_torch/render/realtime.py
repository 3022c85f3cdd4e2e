"""Pseudo-realtime tracers: FastTracer, GameTracer and path-space filtering
(port of cudatracerlib_tpu/render/realtime.py; reference
Integrators/PseudoRealtime/ and Kernel/PathSpaceFilteringBuffer).

* `render_fast`: primary visibility only, depth and headlight shading; the
  rays/s of this pass is the traversal's speed of light.
* `render_game`: the primary hit's direct light plus a one-bounce indirect
  estimate (render/path_tracer.trace_radiance) blended over frames into a
  per-pixel cache of hit points (`PSFBuffer`) and filtered over the cache's
  neighbours within `radius` (accel/hashgrid.py: the sort-based grid and
  its capped sphere query).

Pixels go in the path tracer's 32x32 block order
(`path_tracer.block_order`, built on the device), a permutation, so writing the image
back is plain index assignment. The sampler streams are JAX's: (seed,
pixel, 0) for the fast pass, (seed, pixel, 0x6A3E) for a game frame.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..accel import hashgrid
from ..sampling.rng import MASK, Sampler
from ..scene import bsdf as bsdf_mod
from ..scene import scene as scene_mod
from ..scene import sensors
from ..scene.scene import Scene, gather_mat_params, make_interaction
from .path_tracer import (PTConfig, _offset_ray, block_order, nee_light_sample,
                          specialize_config, trace_radiance)


def _block_pixels(width: int, height: int, device):
    pid = block_order(width, height, device)[0]
    return pid, (pid % width).to(torch.float32), (pid // width).to(torch.float32)


@torch.no_grad()
def render_fast(scene: Scene, width: int, height: int, seed=0):
    """FastTracer: primary visibility at the pixel centres, one closest-hit
    trace of W H rays. Returns ((H, W, 3) albedo * |n . -d|, (H, W) hit
    distance), 0 where a ray missed."""
    cfg = specialize_config(scene, PTConfig())
    dev = scene.light_cdf.device
    n_px = width * height
    pid, px, py = _block_pixels(width, height, dev)
    uv = torch.stack([(px + 0.5) / width, (py + 0.5) / height], -1)
    _, u_ap = Sampler.create(int(seed) & MASK, pid, 0).next_2d()
    o, d, _ = sensors.sample_ray(scene.camera, uv, u_ap)
    hit = scene_mod.scene_intersect(scene, o, d)
    it = make_interaction(scene, o, d, hit)
    mp = gather_mat_params(scene, it, cfg.tex_types)
    shade = mp.albedo * (it.frame.n * -d).sum(-1, keepdim=True).abs()
    img = torch.zeros(n_px, 3, device=dev)
    depth = torch.zeros(n_px, device=dev)
    img[pid] = torch.where(hit.valid[..., None], shade, 0.0)
    depth[pid] = torch.where(hit.valid, hit.t, 0.0)
    return img.reshape(height, width, 3), depth.reshape(height, width)


class PSFBuffer(NamedTuple):
    """Path-space filtering state: a cached hit point a pixel slot
    (PathSpaceFilteringBuffer.h:17-24 path_entry{p, Li, nor, wi})."""

    p: torch.Tensor       # (N, 3) cache positions
    li: torch.Tensor      # (N, 3) cached indirect irradiance
    n: torch.Tensor       # (N, 3) normals
    valid: torch.Tensor   # (N,) bool
    frame: torch.Tensor   # () frame counter

    @staticmethod
    def create(capacity: int, device="cuda") -> "PSFBuffer":
        z = torch.zeros(capacity, 3, device=device)
        return PSFBuffer(p=z, li=z.clone(), n=z.clone(),
                         valid=torch.zeros(capacity, dtype=torch.bool, device=device),
                         frame=torch.zeros((), device=device))


class GTConfig(NamedTuple):
    base: PTConfig = PTConfig(max_depth=3, rr_start=99)
    radius: float = 0.05
    max_gather: int = 16
    grid_res: int = 64
    alpha: float = 0.15   # temporal blend (PathSpaceFilteringBuffer.cu alpha)


@torch.no_grad()
def render_game(scene: Scene, psf: PSFBuffer | None, width: int, height: int, seed=0,
                config: GTConfig = GTConfig()):
    """One GameTracer frame: (image (H, W, 3), the updated PSFBuffer). `psf`
    None starts an empty cache of W H slots on the scene's device."""
    cfg = specialize_config(scene, config.base)
    dev = scene.light_cdf.device
    n_px = width * height
    if psf is None:
        psf = PSFBuffer.create(n_px, device=dev)
    pid, px, py = _block_pixels(width, height, dev)
    smp = Sampler.create(int(seed) & MASK, pid, 0x6A3E)
    smp, jit2 = smp.next_2d()
    uv = torch.stack([(px + jit2[:, 0]) / width, (py + jit2[:, 1]) / height], -1)
    smp, u_ap = smp.next_2d()
    o, d, _ = sensors.sample_ray(scene.camera, uv, u_ap)
    hit = scene_mod.scene_intersect(scene, o, d)
    it = make_interaction(scene, o, d, hit)
    mp = gather_mat_params(scene, it, cfg.tex_types)
    wo_local = it.frame.to_local(-d)
    valid = hit.valid

    # direct light at the primary hit
    smp, u_sel = smp.next_1d()
    smp, u_l2 = smp.next_2d()
    direct = torch.zeros(o.shape[0], 3, device=dev)
    if scene.n_lights > 0:
        ds, Lrad, pdf_l, lpmf = nee_light_sample(scene, cfg, it.p, u_sel, u_l2)
        f_l, _ = bsdf_mod.eval_bsdf(mp, wo_local, it.frame.to_local(ds.d), active=cfg.bsdf_types)
        sh_o = _offset_ray(it.p, it.n_geo, ds.d, cfg.ray_eps)
        blocked = scene_mod.scene_occluded(scene, sh_o, ds.d, cfg.ray_eps,
                                           ds.dist - 2 * cfg.ray_eps)
        ok = valid & ~blocked & (ds.pdf > 0) & (lpmf > 0)
        direct = torch.where(ok[..., None], f_l * Lrad / torch.clamp(pdf_l, min=1e-12)[..., None],
                             0.0)

    # a fresh one-bounce indirect estimate at the hit points
    smp, u_b2 = smp.next_2d()
    smp, u_b1 = smp.next_1d()
    bs = bsdf_mod.sample_bsdf(mp, wo_local, u_b2, u_b1, active=cfg.bsdf_types)
    wi_world = it.frame.to_world(bs.wi)
    o2 = _offset_ray(it.p, it.n_geo, wi_world, cfg.ray_eps)
    L_ind, _ = trace_radiance(scene, o2, wi_world, smp, cfg)
    fresh_li = bs.weight * L_ind

    # temporal blend into the cache (hit points keyed by pixel slot)
    v3 = valid[..., None]
    blend = torch.where(psf.valid & valid, 1.0 - config.alpha, 0.0)[..., None]
    new_psf = PSFBuffer(p=torch.where(v3, it.p, psf.p),
                        li=torch.where(v3, psf.li * blend + fresh_li * (1.0 - blend), psf.li),
                        n=torch.where(v3, it.frame.n, psf.n), valid=psf.valid | valid,
                        frame=psf.frame + 1)

    # spatial filtering: the cached irradiance around each hit point
    grid = hashgrid.build_grid(new_psf.p, scene.bvh.world_min - 1e-3,
                               scene.bvh.world_max + 1e-3, res=config.grid_res,
                               valid=new_psf.valid)
    idx, valid_n = hashgrid.query_sphere(grid, it.p, config.radius, config.max_gather)
    nb_p, nb_n = new_psf.p[idx], new_psf.n[idx]
    d2 = ((nb_p - it.p[:, None, :]) ** 2).sum(-1)
    w = (valid_n & (d2 < config.radius ** 2)
         & ((nb_n * it.frame.n[:, None, :]).sum(-1) > 0.8)).to(torch.float32)
    filt = (new_psf.li[idx] * w[..., None]).sum(1) / torch.clamp(w.sum(1, keepdim=True), min=1.0)

    img = torch.zeros(n_px, 3, device=dev)
    img[pid] = torch.where(v3, direct + filt, 0.0)
    return img.reshape(height, width, 3), new_psf
