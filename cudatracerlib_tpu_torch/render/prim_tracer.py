"""PrimTracer: the single-bounce AOV / debug renderer (port of
cudatracerlib_tpu/render/prim_tracer.py; reference Integrators/PrimTracer
and its 15 draw modes, PrimTracer.h:7-9).

One pass at 1 spp through the pixel centres computes every mode at once:
the geometry modes at the first hit, the first hit's emission, albedo and
one-sample direct light, and the same three at the first non-delta vertex
after walking through specular chains (`max_path_length` steps, each a
closest-hit trace of every lane). Pixel ids are in row order, the sampler
stream (seed, pixel, 0) and its draws the JAX package's.
"""
from __future__ import annotations

import torch

from ..math import montecarlo as mc
from ..math.frame import Frame
from ..sampling.rng import MASK, Sampler
from ..scene import bsdf as bsdf_mod
from ..scene import lights as lights_mod
from ..scene import scene as scene_mod
from ..scene import sensors
from ..scene.scene import Interaction, Scene, gather_mat_params, make_interaction
from .path_tracer import PTConfig, _offset_ray, specialize_config

# the reference's D3D depth transform (PrimTracer.cu:32-38): hyperbolic
# depth between these near and far planes
D3D_NEAR = 1.0
D3D_FAR = 100.0


def _one_sample_direct(scene: Scene, cfg: PTConfig, it: Interaction, d, smp: Sampler):
    """One-sample NEE at the interaction (the *_f_direct modes)."""
    smp, u_sel = smp.next_1d()
    smp, u_l2 = smp.next_2d()
    if scene.n_lights == 0:
        return torch.zeros_like(it.p), smp
    lsel, lpmf, _ = mc.sample_discrete(scene.light_cdf, u_sel)
    ds, Lrad = lights_mod.sample_direct(scene.lights, lsel, it.p, u_l2, active=cfg.light_types)
    mp = gather_mat_params(scene, it, cfg.tex_types)
    f_l, _ = bsdf_mod.eval_bsdf(mp, it.frame.to_local(-d), it.frame.to_local(ds.d),
                                active=cfg.bsdf_types)
    sh_o = _offset_ray(it.p, it.n_geo, ds.d, 1e-3)
    blocked = scene_mod.scene_occluded(scene, sh_o, ds.d, 1e-3, ds.dist - 2e-3)
    pdf = torch.where(ds.measure == 2, 1.0, ds.pdf) * lpmf
    direct = f_l * Lrad / torch.clamp(pdf, min=1e-12)[..., None]
    ok = (it.valid & ~blocked & (pdf > 0))[..., None]
    return torch.where(ok, direct, 0.0), smp


def _first_hit_channels(scene: Scene, cfg: PTConfig, d, it: Interaction, smp: Sampler):
    """(emission, albedo (the f proxy), one-sample direct light, sampler) at
    an interaction."""
    v = it.valid[..., None]
    mp = gather_mat_params(scene, it, cfg.tex_types)
    albedo = torch.where(v, mp.albedo, 0.0)
    mat_light = scene.materials.light_id[it.mat_id.long()]
    lid = torch.clamp(mat_light, min=0).long()
    Le = lights_mod.eval_area_emission(scene.lights, lid, it.n_geo, -d)
    Le = torch.where((mat_light >= 0)[..., None] & v, Le, 0.0)
    direct, smp = _one_sample_direct(scene, cfg, it, d, smp)
    return Le, albedo, direct, smp


def _select_it(go, a: Interaction, b: Interaction) -> Interaction:
    """Lane-wise a where `go`, else b, field by field."""
    def sel(x, y):
        return torch.where(go.reshape(go.shape + (1,) * (x.dim() - go.dim())), x, y)
    frame = Frame(*(sel(x, y) for x, y in zip(a.frame, b.frame)))
    return Interaction(*(frame if f == "frame" else sel(getattr(a, f), getattr(b, f))
                         for f in Interaction._fields))


@torch.no_grad()
def render_aovs(scene: Scene, width: int, height: int, seed=0, max_path_length: int = 7):
    """First-hit AOVs at 1 spp (pixel centres) on the scene's device: a dict
    of every reference draw mode, (H, W) or (H, W, 3), plus the mat_id and
    prim_id extras (-1 where no hit)."""
    cfg = specialize_config(scene, PTConfig())
    dev = scene.light_cdf.device
    n_px = width * height
    pid = torch.arange(n_px, device=dev)
    px = (pid % width).to(torch.float32)
    py = (pid // width).to(torch.float32)
    uv = torch.stack([(px + 0.5) / width, (py + 0.5) / height], -1)
    smp = Sampler.create(int(seed) & MASK, pid, 0)
    smp, u_ap = smp.next_2d()
    o, d, _ = sensors.sample_ray(scene.camera, uv, u_ap)
    hit = scene_mod.scene_intersect(scene, o, d)
    it = make_interaction(scene, o, d, hit)
    valid = it.valid
    v = valid[..., None]

    # ---- geometry modes ----
    depth = torch.where(valid, hit.t, 0.0)
    z = torch.clamp(depth, min=1e-6)
    d3d = torch.clamp((D3D_FAR / (D3D_FAR - D3D_NEAR)) * (1.0 - D3D_NEAR / z), 0.0, 1.0)
    d3d = torch.where(valid, d3d, 1.0)
    vdng = (-d * it.n_geo).sum(-1)
    vdns = (-d * it.frame.n).sum(-1)
    zero1 = torch.zeros_like(it.uv[..., :1])
    out = {
        "depth": depth,                                          # linear_depth
        "d3d_depth": d3d,                                        # D3D_depth
        "v_absdot_n_geo": torch.where(valid, vdng.abs(), 0.0),
        "v_dot_n_geo": torch.where(valid, vdng * 0.5 + 0.5, 0.0),
        "v_dot_n_shade": torch.where(valid, vdns * 0.5 + 0.5, 0.0),
        "normal_geo": torch.where(v, it.n_geo * 0.5 + 0.5, 0.0),  # n_geo_colored
        "normal_sh": torch.where(v, it.frame.n * 0.5 + 0.5, 0.0),  # n_shade_colored
        "uv": torch.where(v, torch.cat([it.uv, zero1], -1), 0.0),
        "bary": torch.where(v, torch.cat([hit.bary, zero1], -1), 0.0),
    }

    # ---- first-hit shading modes ----
    Le, albedo, direct, smp = _first_hit_channels(scene, cfg, d, it, smp)

    # ---- first_non_delta_*: walk through delta chains (PrimTracer.cu:85) ----
    o_c, d_c, it_c, active = o, d, it, valid
    for _ in range(max_path_length):
        mp_c = gather_mat_params(scene, it_c, cfg.tex_types)
        go = active & bsdf_mod.is_delta(mp_c) & it_c.valid
        smp, u2 = smp.next_2d()
        smp, u1 = smp.next_1d()
        bs = bsdf_mod.sample_bsdf(mp_c, it_c.frame.to_local(-d_c), u2, u1, active=cfg.bsdf_types)
        wi_w = it_c.frame.to_world(bs.wi)
        new_o = _offset_ray(it_c.p, it_c.n_geo, wi_w, 1e-3)
        new_hit = scene_mod.scene_intersect(scene, new_o, wi_w)
        new_it = make_interaction(scene, new_o, wi_w, new_hit)
        sel = go[..., None]
        o_c = torch.where(sel, new_o, o_c)
        d_c = torch.where(sel, wi_w, d_c)
        it_c = _select_it(go, new_it, it_c)
        active = go & new_hit.valid
    Le_nd, albedo_nd, direct_nd, smp = _first_hit_channels(scene, cfg, d_c, it_c, smp)

    out.update({
        "emission": Le,                                          # first_Le
        "albedo": albedo,                                        # first_f
        "direct": direct,                                        # first_f_direct
        "emission_non_delta": Le_nd,                             # first_non_delta_Le
        "albedo_non_delta": albedo_nd,                           # first_non_delta_f
        "direct_non_delta": direct_nd,                           # first_non_delta_f_direct
        "mat_id": torch.where(valid, it.mat_id.to(torch.float32), -1.0),
        "prim_id": torch.where(valid, it.prim.to(torch.float32), -1.0),
    })
    return {k: x.reshape((height, width) + tuple(x.shape[1:])) for k, x in out.items()}
