"""Light tracer: emitter paths connected to the camera at every bounce
(port of cudatracerlib_tpu/render/light_tracer.py:30-123).

Particles leave the lights (`sample_emitter_ray`), walk the scene with
adjoint BSDF sampling and Russian roulette, and at every vertex connect to
the pinhole camera (`sensors.sample_direct`) through a shadow ray; the
unoccluded connections are splatted to the film (`film.splat_sum`, the
deterministic segment-sum kernel on the card) and the film is scaled by
pixels over paths. The image estimates the same radiance as the path
tracer, from camera splats only.

The draw order and the stream (0x117) are the JAX package's, and the
interaction frames are built with flat=False, as the JAX module does on
every scene, so the CPU port walks the JAX package's particles lane for
lane. Forward only: the entry point runs under `torch.no_grad()`.
"""
from __future__ import annotations

import torch

from ..image import film as film_mod
from ..sampling.rng import MASK, Sampler
from ..scene import bsdf as bsdf_mod
from ..scene import lights as lights_mod
from ..scene import scene as scene_mod
from ..scene import sensors
from ..scene.scene import Scene
from ..scene.shade_pack import build_shade_pack, hit_shading, pack_enabled
from .path_tracer import PTConfig, _offset_ray, _select_light, specialize_config


def splat_pixel(uv, width: int, height: int):
    """Flat pixel ids (B,) int64 of film positions (B, 2), clipped to the
    film (truncation toward zero, as the JAX package's int32 cast)."""
    px = torch.clamp((uv[..., 0] * width).to(torch.int32), 0, width - 1)
    py = torch.clamp((uv[..., 1] * height).to(torch.int32), 0, height - 1)
    return (py * width + px).long()


def emit_particles(scene: Scene, B: int, sampler: Sampler, config: PTConfig):
    """Emitted rays of B particles: light selection, a point and a direction
    on the light, the power weight divided by the selection pmf. Returns
    (o, d, w, lsel, lpmf, sampler)."""
    smp, u_sel = sampler.next_1d()
    lsel, lpmf, _ = _select_light(scene, u_sel)
    smp, u_pos = smp.next_2d()
    smp, u_dir = smp.next_2d()
    o, d, w = lights_mod.sample_emitter_ray(scene.lights, lsel, u_pos, u_dir,
                                            active=config.light_types)
    return o, d, w / torch.clamp(lpmf, min=1e-9)[..., None], lsel, lpmf, smp


@torch.no_grad()
def render_light_trace(scene: Scene, width: int, height: int, n_paths: int, seed,
                       config: PTConfig = PTConfig()):
    """Render by pure light tracing on the scene's device: (H, W, 3)."""
    config = specialize_config(scene, config)
    B, n_px = n_paths, width * height
    dev = scene.light_cdf.device
    smp = Sampler.create(int(seed) & MASK, torch.arange(B, device=dev), 0x117)
    o, d, w, _, _, smp = emit_particles(scene, B, smp, config)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    pack = build_shade_pack(scene) if pack_enabled(scene) else None
    pix, splats = [], []

    for depth in range(config.max_depth):
        hit = scene_mod.scene_intersect(scene, o, d)
        it, mp = hit_shading(scene, o, d, hit, pack, config.tex_types)
        found = hit.valid & alive

        # ---- connect to the camera (splat) ----
        uv, d_cam, dist_cam, importance, in_frustum = sensors.sample_direct(scene.camera, it.p)
        wo_local = it.frame.to_local(-d)
        # adjoint BSDF evaluation: f |cos| toward the camera
        f_cam, _ = bsdf_mod.eval_bsdf(mp, wo_local, it.frame.to_local(d_cam),
                                      active=config.bsdf_types)
        sh_o = _offset_ray(it.p, it.n_geo, d_cam, config.ray_eps)
        blocked = scene_mod.scene_occluded(scene, sh_o, d_cam, config.ray_eps,
                                           dist_cam - 2.0 * config.ray_eps)
        # importance is per unit film area; the distance squared converts
        # the surface measure (pinhole W_e)
        splat = w * f_cam * (importance / torch.clamp(dist_cam * dist_cam, min=1e-9))[..., None]
        ok = found & in_frustum & ~blocked
        pix.append(splat_pixel(uv, width, height))
        splats.append(torch.where(ok[..., None], splat, 0.0))

        # ---- continue the walk ----
        s, u2 = smp.next_2d()
        s, u1 = s.next_1d()
        bs = bsdf_mod.sample_bsdf(mp, wo_local, u2, u1, active=config.bsdf_types)
        wi_world = it.frame.to_world(bs.wi)
        s, u_rr = s.next_1d()
        if depth >= config.rr_start:
            p_cont = torch.clamp(bs.weight.abs().amax(-1), max=0.95)
        else:
            p_cont = torch.ones_like(u_rr)
        cont = found & (bs.pdf > 0) & (u_rr < p_cont)
        w_new = w * bs.weight / torch.clamp(p_cont, min=1e-6)[..., None]
        c3 = cont[..., None]
        o = torch.where(c3, _offset_ray(it.p, it.n_geo, wi_world, config.ray_eps), o)
        d = torch.where(c3, wi_world, d)
        w = torch.where(c3, w_new, w)
        alive = cont
        smp = s

    value = torch.nan_to_num(torch.cat(splats), nan=0.0, posinf=0.0, neginf=0.0)
    film = film_mod.splat_sum(torch.cat(pix), value, n_px)
    # each path splats over the whole film: divide by the paths, times the pixels
    return (film * (n_px / n_paths)).reshape(height, width, 3)
