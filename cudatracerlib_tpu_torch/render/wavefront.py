"""Wavefront path tracer: a persistent ray pool with refill-on-death
(port of cudatracerlib_tpu/render/wavefront.py:36-252).

Every iteration, lanes whose path ended are re-seeded with the next unused
camera rays (prefix-sum assignment, the deterministic counterpart of the
reference's atomic ray queue), finished paths are flushed to the film, and
all lanes take one shared `surface_bounce`. Once the camera-ray supply is
out and fewer than an eighth of the lanes still live, extra Russian roulette
(p = 1/4, compensated) drains the tail. The JAX `lax.while_loop` becomes a
Python loop whose condition reads one value from the device per iteration.

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
from .path_tracer import PTConfig, specialize_config, surface_bounce


def _camera_ray(scene: Scene, ray_id, seed: int, width: int, height: int):
    """Ray ids (K,) int64 -> (pixel (K,), o, d, sampler state): pixel =
    id mod (W H), sample index = id div (W H)."""
    n_px = width * height
    pixel = ray_id % n_px
    smp = Sampler.create(seed, pixel, ray_id // n_px)
    smp, jitter = smp.next_2d()
    px = (pixel % width).to(torch.float32)
    py = (pixel // width).to(torch.float32)
    uv = torch.stack([(px + jitter[:, 0]) / width, (py + jitter[:, 1]) / height], -1)
    smp, u_ap = smp.next_2d()
    o, d, _ = sensors.sample_ray(scene.camera, uv, u_ap)
    return pixel, o, d, smp.state


def _flush(film, film_w, pixel, L, sel):
    """Add the radiance of the lanes in `sel` to their pixels."""
    px = pixel[sel]
    film.index_add_(0, px, torch.nan_to_num(L[sel], nan=0.0, posinf=0.0, neginf=0.0))
    film_w.index_add_(0, px, torch.ones_like(px, dtype=film_w.dtype))


def _wavefront(scene: Scene, width: int, height: int, spp: int, seed, config: PTConfig,
               capacity: int):
    C = capacity
    total = width * height * spp
    n_px = width * height
    seed = int(seed) & MASK
    dev = scene.light_cdf.device
    pack = build_shade_pack(scene) if pack_enabled(scene) else None

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
    alive = torch.zeros(C, dtype=torch.bool, device=dev)
    film = torch.zeros(n_px, 3, device=dev)
    film_w = torch.zeros(n_px, device=dev)
    next_ray = 0
    n_rays = torch.zeros((), dtype=torch.int64, device=dev)
    max_iters = config.max_depth + total // C + 64

    for _ in range(max_iters):
        if next_ray >= total and not bool(alive.any()):
            break
        # ---- refill dead lanes with fresh camera rays (prefix-sum assign) ----
        dead = ~alive
        new_id = next_ray + torch.cumsum(dead, 0) - 1
        take = dead & (new_id < total)
        _flush(film, film_w, pixel, L, dead & (pixel >= 0))
        n_taken = int(take.sum())
        pixel = torch.where(dead, -1, pixel)
        if n_taken:
            lanes = take.nonzero()[:, 0]
            pix_n, o_n, d_n, state_n = _camera_ray(scene, new_id[lanes], seed, width, height)
            pixel[lanes], o[lanes], d[lanes], state[lanes] = pix_n, o_n, d_n, state_n
            throughput[lanes], L[lanes], depth[lanes] = 1.0, 0.0, 0
            prev_pdf[lanes], prev_delta[lanes] = 0.0, True
            eta_scale[lanes] = 1.0
            alive = alive | take

        # ---- one shared shading bounce ----
        out = surface_bounce(scene, config, o=o, d=d, active=alive, throughput=throughput,
                             prev_pdf=prev_pdf, prev_delta=prev_delta, eta_scale=eta_scale,
                             sampler=Sampler(state=state), depth=depth, pack=pack)
        cont = out.cont & (depth + 1 < config.max_depth)
        L = L + out.L_add

        # ---- tail drain: extra compensated Russian roulette once the supply
        # is out and the pool is mostly empty ----
        next_ray += n_taken
        drain = next_ray >= total and int(cont.sum()) < C // 8
        smp, u_drain = out.sampler.next_1d()
        p_keep = 0.25 if drain else 1.0
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
        alive = cont
        n_rays = n_rays + out.n_rays

    # flush the lanes still carrying radiance (all dead by now)
    _flush(film, film_w, pixel, L, pixel >= 0)
    img = film / torch.clamp(film_w, min=1e-8)[:, None]
    return img.reshape(height, width, 3), n_rays


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
                      _capacity(width, height, spp, capacity))
