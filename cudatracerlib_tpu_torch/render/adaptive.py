"""Adaptive progressive rendering: variance-driven sample allocation
(port of cudatracerlib_tpu/render/adaptive.py).

Each pass keeps a fixed ray budget (W H spp) and spends more of it on noisy
blocks: the variance buffer's block weights (image/variance.py) are
expanded to a pixel pmf, and the pass's rays are assigned to pixels by
deterministic systematic sampling of its CDF. The film normalizes by the
realized per-pixel sample counts, so the estimator stays unbiased for any
weight map. `render_adaptive` drives the megakernel path tracer pass by
pass; `render_wavefront_adaptive` feeds the map to the wavefront engine's
camera-ray generator (its `pixel_map`), one wave at a time.

The CDF is summed in float32 and searched as in JAX; XLA's CPU may sum it
in another order, so a ray on a CDF boundary can land in the neighbouring
pixel (tests/test_torch_adaptive.py bounds the share).
"""
from __future__ import annotations

import torch

from ..image import variance as var_mod
from ..sampling.rng import MASK, Sampler
from ..scene import sensors
from ..scene.scene import Scene
from .path_tracer import PTConfig, specialize_config, texture_cone, trace_radiance


def assign_rays_to_pixels(weights_px, n_rays: int):
    """Systematic assignment of `n_rays` ray slots to pixels in proportion
    to `weights_px` ((P,), any positive scale): (pixel id (n_rays,) int32,
    sample index (n_rays,) int32), the sample index counting a pixel's rays
    0..k-1 within the pass (a pixel's rays are consecutive)."""
    dev = weights_px.device
    w = torch.clamp(weights_px, min=0.0)
    cdf = torch.cumsum(w, 0)
    cdf = cdf / torch.clamp(cdf[-1], min=1e-12)
    r = (torch.arange(n_rays, dtype=torch.float32, device=dev) + 0.5) / n_rays
    pix = torch.clamp(torch.searchsorted(cdf, r), max=weights_px.shape[0] - 1)
    # the pixel's first ray slot is ceil(cdf[pix - 1] * n_rays - 0.5)
    prev = torch.where(pix > 0, cdf[torch.clamp(pix - 1, min=0)], 0.0)
    first = torch.ceil(prev * n_rays - 0.5).to(torch.int32)
    sample_idx = torch.arange(n_rays, dtype=torch.int32, device=dev) - first
    return pix.to(torch.int32), torch.clamp(sample_idx, min=0)


def _pixel_weights(vb, mode: int):
    return var_mod.expand_blocks(var_mod.block_weights(vb, mode)).reshape(-1)


@torch.no_grad()
def render_adaptive(scene: Scene, width: int, height: int, spp: int, n_passes: int, seed,
                    config: PTConfig, mode: int = var_mod.VARIANCE, warmup: int = 1):
    """Progressive render with variance-adaptive per-pixel sample
    allocation, `config` already specialized: the ray budget of
    `render_progressive(spp, n_passes)`; the first `warmup` passes are
    uniform (they seed the variance buffer), each later pass's rays follow
    the block weights. Pass k draws with seed + k (uint32) and keys each
    sample by (pixel, sample index). Returns (H, W, 3)."""
    dev = scene.light_cdf.device
    n_px = width * height
    B = n_px * spp
    uniform_pix = torch.arange(n_px, dtype=torch.int32, device=dev).repeat(spp)
    uniform_sid = torch.arange(spp, dtype=torch.int32, device=dev).repeat_interleave(n_px)
    cone = texture_cone(scene, width, height, config)
    film_rgb = torch.zeros(n_px, 3, device=dev)
    film_w = torch.zeros(n_px, device=dev)
    vb = var_mod.VarianceBuffer.create(height, width, device=dev)
    for k in range(n_passes):
        if k < warmup:
            pix, sid = uniform_pix, uniform_sid
        else:
            pix, sid = assign_rays_to_pixels(_pixel_weights(vb, mode), B)
        pix64 = pix.long()
        sampler = Sampler.create((int(seed) + k) & MASK, pix64, sid.long())
        px = (pix64 % width).to(torch.float32)
        py = (pix64 // width).to(torch.float32)
        sampler, jitter = sampler.next_2d()
        uv = torch.stack([(px + jitter[:, 0]) / width, (py + jitter[:, 1]) / height], -1)
        sampler, u_ap = sampler.next_2d()
        o, d, w_cam = sensors.sample_ray(scene.camera, uv, u_ap)
        L, _ = trace_radiance(scene, o, d, sampler, config, cone=cone)
        L = torch.nan_to_num(L * w_cam, nan=0.0, posinf=0.0, neginf=0.0)
        pass_rgb = torch.zeros(n_px, 3, device=dev).index_add_(0, pix64, L)
        pass_cnt = torch.zeros(n_px, device=dev).index_add_(
            0, pix64, torch.ones(B, device=dev))
        film_rgb = film_rgb + pass_rgb
        film_w = film_w + pass_cnt
        pass_img = (pass_rgb / torch.clamp(pass_cnt, min=1.0)[:, None]).reshape(height, width, 3)
        vb = var_mod.add_pass(vb, pass_img, k, mask=(pass_cnt > 0).reshape(height, width))
    img = film_rgb / torch.clamp(film_w, min=1e-8)[:, None]
    return img.reshape(height, width, 3)


def render_adaptive_host(scene: Scene, width: int, height: int, spp: int, n_passes: int, seed,
                         config: PTConfig = PTConfig(), mode: int = var_mod.VARIANCE,
                         warmup: int = 1):
    """specialize_config + render_adaptive (the usual entry point)."""
    return render_adaptive(scene, width, height, spp, n_passes, seed,
                           specialize_config(scene, config), mode, warmup)


@torch.no_grad()
def render_wavefront_adaptive(scene: Scene, width: int, height: int, spp: int, n_waves: int,
                              seed, config: PTConfig = PTConfig(),
                              mode: int = var_mod.VARIANCE, capacity: int | None = None):
    """Adaptive wavefront render: wave 0 is uniform, each later wave feeds
    the variance block weights to the wavefront camera-ray generator as its
    `pixel_map`. Wave k draws with seed + 7919 k (uint32). Returns (H, W, 3)."""
    from .wavefront import _capacity, _wavefront

    config = specialize_config(scene, config)
    dev = scene.light_cdf.device
    n_px = width * height
    B = n_px * spp
    capacity = _capacity(width, height, spp, capacity)
    film_rgb = torch.zeros(n_px, 3, device=dev)
    film_w = torch.zeros(n_px, device=dev)
    vb = var_mod.VarianceBuffer.create(height, width, device=dev)
    uniform_pix = torch.arange(n_px, dtype=torch.int32, device=dev).repeat(spp)
    for k in range(n_waves):
        pix_map = (uniform_pix if k == 0
                   else assign_rays_to_pixels(_pixel_weights(vb, mode), B)[0])
        img = _wavefront(scene, width, height, spp, (int(seed) + k * 7919) & MASK, config,
                         capacity, pixel_map=pix_map)[0]
        # the wave's image is a per-pixel mean over its own samples: back to
        # (sum, count) with the planned per-pixel ray counts
        cnt = torch.zeros(n_px, device=dev).index_add_(0, pix_map.long(),
                                                        torch.ones(B, device=dev))
        film_rgb = film_rgb + img.reshape(n_px, 3) * cnt[:, None]
        film_w = film_w + cnt
        vb = var_mod.add_pass(vb, img, k, mask=(cnt > 0).reshape(height, width))
    img = film_rgb / torch.clamp(film_w, min=1e-8)[:, None]
    return img.reshape(height, width, 3)
