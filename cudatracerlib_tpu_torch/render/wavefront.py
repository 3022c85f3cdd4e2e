"""Wavefront path tracer: a persistent ray pool with refill-on-death
(port of cudatracerlib_tpu/render/wavefront.py:36-267).

Every iteration, lanes whose path ended are re-seeded with the next unused
camera rays (prefix-sum assignment, the deterministic counterpart of the
reference's atomic ray queue), finished paths are flushed to the film, and
all lanes take one shared `surface_bounce` (with the ray cone and each
lane's path length, reset on refill, for MIP-filtered image textures). Once
the camera-ray supply is out and fewer than an eighth of the lanes still
live, extra Russian roulette (p = 1/4, compensated) drains the tail.

The refill is fixed-shape, as in JAX: camera rays are made for all C lanes
and selected by `take`, the next ray id, the film flush (onto a dropped
row) and the drain test stay on the device, and the JAX `lax.while_loop`
becomes a Python loop whose only host read an iteration is its condition.
`pixel_map` (the adaptive sampler's ray -> pixel table, render/adaptive.py)
sends ray id k to pixel pixel_map[k] with sample index k.

Each lane's random stream and draw order are the JAX package's (jitter,
aperture, the bounce's draws, then the drain draw), so the CPU render is the
JAX render lane for lane. The ray count is an int64 (JAX counts in float32,
exact below 2^24).
"""
from __future__ import annotations

import torch

from ..sampling.rng import MASK, Sampler
from ..scene import sensors
from ..scene.scene import Scene
from ..scene.shade_pack import build_shade_pack, pack_enabled
from .path_tracer import PTConfig, specialize_config, surface_bounce, texture_cone


def _camera_ray(scene: Scene, ray_id, seed: int, width: int, height: int, pixel_map=None):
    """Ray ids (K,) int64 in [0, total) -> (pixel (K,), o, d, sampler
    state): pixel = id mod (W H) and sample index = id div (W H), or with
    `pixel_map` pixel = pixel_map[id] and sample index = id."""
    n_px = width * height
    if pixel_map is not None:
        pixel, sample = pixel_map[ray_id].long(), ray_id
    else:
        pixel, sample = ray_id % n_px, ray_id // n_px
    smp = Sampler.create(seed, pixel, sample)
    smp, jitter = smp.next_2d()
    px = (pixel % width).to(torch.float32)
    py = (pixel // width).to(torch.float32)
    uv = torch.stack([(px + jitter[:, 0]) / width, (py + jitter[:, 1]) / height], -1)
    smp, u_ap = smp.next_2d()
    o, d, _ = sensors.sample_ray(scene.camera, uv, u_ap)
    return pixel, o, d, smp.state


def _flush(film, film_w, pixel, L, sel, n_px):
    """Add the radiance of the lanes in `sel` to their pixels; the others
    add zeros to the dropped row n_px."""
    px = torch.where(sel, pixel, n_px)
    film.index_add_(0, px, torch.where(sel[:, None], torch.nan_to_num(
        L, nan=0.0, posinf=0.0, neginf=0.0), 0.0))
    film_w.index_add_(0, px, sel.to(film_w.dtype))


def _wavefront(scene: Scene, width: int, height: int, spp: int, seed, config: PTConfig,
               capacity: int, pixel_map=None):
    """(image (H, W, 3), rays traced (int64), non-finite lanes (int64),
    iterations (int))."""
    C = capacity
    total = width * height * spp
    n_px = width * height
    seed = int(seed) & MASK
    dev = scene.light_cdf.device
    pack = build_shade_pack(scene) if pack_enabled(scene) else None
    cone = texture_cone(scene, width, height, config)
    if pixel_map is not None:
        pixel_map = pixel_map.to(dev)
        if tuple(pixel_map.shape) != (total,):
            raise ValueError(f"pixel_map must be ({total},), got {tuple(pixel_map.shape)}")

    o = torch.zeros(C, 3, device=dev)
    d = torch.tensor([0.0, 0.0, 1.0], device=dev).repeat(C, 1)
    throughput = torch.zeros(C, 3, device=dev)
    L = torch.zeros(C, 3, device=dev)
    pixel = torch.full((C,), -1, dtype=torch.int64, device=dev)
    depth = torch.zeros(C, dtype=torch.int64, device=dev)
    state = torch.zeros(C, dtype=torch.int64, device=dev)
    prev_pdf = torch.zeros(C, device=dev)
    prev_delta = torch.ones(C, dtype=torch.bool, device=dev)
    eta_scale = torch.ones(C, device=dev)
    path_len = None if cone is None else torch.zeros(C, device=dev)
    alive = torch.zeros(C, dtype=torch.bool, device=dev)
    film = torch.zeros(n_px + 1, 3, device=dev)      # row n_px: the dropped row
    film_w = torch.zeros(n_px + 1, device=dev)
    next_ray = torch.zeros((), dtype=torch.int64, device=dev)
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)
    n_bad = torch.zeros((), dtype=torch.int64, device=dev)
    max_iters = config.max_depth + total // C + 64

    iters = 0
    while iters < max_iters and bool((next_ray < total) | alive.any()):
        iters += 1
        # ---- refill dead lanes with fresh camera rays (prefix-sum assign),
        # computed for every lane and selected by `take` ----
        dead = ~alive
        new_id = next_ray + torch.cumsum(dead, 0) - 1
        take = dead & (new_id < total)
        _flush(film, film_w, pixel, L, dead & (pixel >= 0), n_px)
        n_taken = take.sum()
        pix_n, o_n, d_n, state_n = _camera_ray(scene, torch.clamp(new_id, 0, total - 1), seed,
                                               width, height, pixel_map)
        t3 = take[:, None]
        o, d = torch.where(t3, o_n, o), torch.where(t3, d_n, d)
        throughput = torch.where(t3, 1.0, throughput)
        L = torch.where(t3, 0.0, L)
        pixel = torch.where(take, pix_n, torch.where(dead, -1, pixel))
        depth = torch.where(take, 0, depth)
        state = torch.where(take, state_n, state)
        prev_pdf = torch.where(take, 0.0, prev_pdf)
        prev_delta = prev_delta | take
        eta_scale = torch.where(take, 1.0, eta_scale)
        if path_len is not None:
            path_len = torch.where(take, 0.0, path_len)
        alive = alive | take

        # ---- one shared shading bounce ----
        out = surface_bounce(scene, config, o=o, d=d, active=alive, throughput=throughput,
                             prev_pdf=prev_pdf, prev_delta=prev_delta, eta_scale=eta_scale,
                             path_len=path_len, sampler=Sampler(state=state), depth=depth,
                             cone=cone, pack=pack)
        cont = out.cont & (depth + 1 < config.max_depth)
        L = L + out.L_add

        # ---- tail drain: extra compensated Russian roulette once the supply
        # is out and the pool is mostly empty (decided on the device) ----
        next_ray = next_ray + n_taken
        drain = (next_ray >= total) & (cont.sum() < C // 8)
        smp, u_drain = out.sampler.next_1d()
        p_keep = torch.where(drain, 0.25, 1.0)
        tp_out = out.throughput / p_keep
        cont = cont & (u_drain < p_keep)

        c3 = cont[:, None]
        o = torch.where(c3, out.o, o)
        d = torch.where(c3, out.d, d)
        throughput = torch.where(c3, tp_out, throughput)
        depth = depth + 1
        state = smp.state
        prev_pdf = torch.where(cont, out.bs_pdf, prev_pdf)
        prev_delta = torch.where(cont, out.delta_now, prev_delta)
        eta_scale = torch.where(cont, out.eta_scale, eta_scale)
        if path_len is not None:
            path_len = torch.where(cont, out.path_len, path_len)
        alive = cont
        n_rays = n_rays + out.n_rays
        n_bad = n_bad + out.n_nonfinite

    # flush the lanes still carrying radiance (all dead by now)
    _flush(film, film_w, pixel, L, pixel >= 0, n_px)
    img = film[:n_px] / torch.clamp(film_w[:n_px], min=1e-8)[:, None]
    return img.reshape(height, width, 3), n_rays, n_bad, iters


def _capacity(width, height, spp, capacity):
    return min(width * height * spp, 1 << 20) if capacity is None else capacity


@torch.no_grad()
def render_wavefront(scene: Scene, width: int, height: int, spp: int, seed,
                     config: PTConfig = PTConfig(), capacity: int | None = None):
    """Wavefront render on the scene's device: (H, W, 3) radiance. The pool
    holds `capacity` lanes, by default one full spp wave up to 2^20."""
    config = specialize_config(scene, config)
    return _wavefront(scene, width, height, spp, seed, config,
                      _capacity(width, height, spp, capacity))[0]


@torch.no_grad()
def render_wavefront_counted(scene: Scene, width: int, height: int, spp: int, seed,
                             config: PTConfig = PTConfig(), capacity: int | None = None):
    """(image, rays traced): alive pool lanes plus NEE shadow rays per
    iteration (the reference's enqueued-ray counter), an int64 tensor."""
    config = specialize_config(scene, config)
    return _wavefront(scene, width, height, spp, seed, config,
                      _capacity(width, height, spp, capacity))[:2]


@torch.no_grad()
def render_wavefront_with_counters(scene: Scene, width: int, height: int, spp: int, seed,
                                   config: PTConfig = PTConfig(),
                                   capacity: int | None = None):
    """(image, {"n_rays", "n_nonfinite", "n_iters"}): the wavefront render
    with the debug counters of `path_tracer.render_with_counters` and the
    pool's iteration count (n_rays and n_nonfinite int64 tensors, n_iters
    an int)."""
    config = specialize_config(scene, config)
    img, n_rays, n_bad, iters = _wavefront(scene, width, height, spp, seed, config,
                                           _capacity(width, height, spp, capacity))
    return img, {"n_rays": n_rays, "n_nonfinite": n_bad, "n_iters": iters}
