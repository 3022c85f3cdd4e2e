"""The engines' debug counters and the wavefront engine's fixed-shape refill,
against the JAX package on the CPU.

Tolerances, stated once:
  * `n_rays` and `n_iters` equal to JAX's (JAX counts rays in float32,
    exact at these sizes); `n_nonfinite` 0, as JAX's cross-checks assert
    (tests/test_engines.py TestNaNAccounting);
  * images: at least 99% of pixels within 1e-3 relative (a path grazing an
    edge may go the other way after a float32 rounding difference), means
    within 0.5%;
  * the fixed-shape refill against the loop it replaced: image bit-equal,
    rays and iterations equal.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.render import path_tracer as jpt
from cudatracerlib_tpu.render import wavefront as jwf
from cudatracerlib_tpu.scene.shapes import cornell_box as jcornell
from cudatracerlib_tpu.scene.shapes import glossy_scene as jglossy
from cudatracerlib_tpu_torch.convert import flatten, scene_from_numpy
from cudatracerlib_tpu_torch.render import path_tracer as tpt
from cudatracerlib_tpu_torch.render import wavefront as twf
from cudatracerlib_tpu_torch.sampling.rng import MASK, Sampler
from cudatracerlib_tpu_torch.scene.shade_pack import build_shade_pack, pack_enabled


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, make in (("cornell", jcornell), ("glossy", jglossy)):
        js = make()
        out[name] = js, scene_from_numpy(flatten(js), device="cpu")
    return out


def _assert_images_close(port, ref, frac=0.99, rel=1e-3):
    port, ref = port.numpy(), np.asarray(ref)
    assert port.shape == ref.shape and np.isfinite(port).all()
    ok = (np.abs(port - ref) <= rel * np.abs(ref) + 1e-6).all(-1)
    assert ok.mean() >= frac, f"only {ok.mean():.4f} of pixels within {rel}"
    assert abs(port.mean() - ref.mean()) <= 5e-3 * abs(ref.mean())


@pytest.mark.parametrize("name", ["cornell", "glossy"])
def test_render_with_counters(scenes, name):
    js, ts = scenes[name]
    ref, jc = jpt.render_with_counters(js, 24, 24, 4, 0, jpt.PTConfig(max_depth=4))
    img, c = tpt.render_with_counters(ts, 24, 24, 4, 0, tpt.PTConfig(max_depth=4))
    assert set(c) == {"n_rays", "n_nonfinite"}
    assert int(c["n_rays"]) == int(jc["n_rays"]) > 0
    assert int(c["n_nonfinite"]) == 0 == int(jc["n_nonfinite"])
    _assert_images_close(img, ref)
    counted, rays = tpt.render_counted(ts, 24, 24, 4, 0, tpt.PTConfig(max_depth=4))
    assert torch.equal(counted, img) and int(rays) == int(c["n_rays"])


def test_wavefront_with_counters(scenes):
    js, ts = scenes["cornell"]
    ref, jc = jwf.render_wavefront_with_counters(js, 24, 24, 2, 0, jpt.PTConfig(max_depth=3))
    img, c = twf.render_wavefront_with_counters(ts, 24, 24, 2, 0, tpt.PTConfig(max_depth=3))
    assert set(c) == {"n_rays", "n_nonfinite", "n_iters"}
    assert int(c["n_rays"]) == int(jc["n_rays"]) > 0
    assert int(c["n_iters"]) == int(jc["n_iters"])
    assert int(c["n_nonfinite"]) == 0 == int(jc["n_nonfinite"])
    _assert_images_close(img, ref)


def _old_wavefront(scene, width, height, spp, seed, config, capacity):
    """The refill loop the fixed-shape refill replaced (render/wavefront.py
    before it): camera rays for the refilled lanes only, the film flushed by
    gathered lanes, the drain decided on the host. (image, rays, iters)."""
    C, total, n_px = capacity, width * height * spp, width * height
    seed = int(seed) & MASK
    pack = build_shade_pack(scene) if pack_enabled(scene) else None
    cone = tpt.texture_cone(scene, width, height, config)
    o = torch.zeros(C, 3)
    d = torch.tensor([0.0, 0.0, 1.0]).repeat(C, 1)
    throughput, L = torch.zeros(C, 3), torch.zeros(C, 3)
    pixel = torch.full((C,), -1, dtype=torch.int64)
    depth = torch.zeros(C, dtype=torch.int64)
    state = torch.zeros(C, dtype=torch.int64)
    prev_pdf, prev_delta = torch.zeros(C), torch.ones(C, dtype=torch.bool)
    eta_scale = torch.ones(C)
    path_len = None if cone is None else torch.zeros(C)
    alive = torch.zeros(C, dtype=torch.bool)
    film, film_w = torch.zeros(n_px, 3), torch.zeros(n_px)
    next_ray, iters = 0, 0
    n_rays = torch.zeros((), dtype=torch.int64)

    def flush(sel):
        px = pixel[sel]
        film.index_add_(0, px, torch.nan_to_num(L[sel], nan=0.0, posinf=0.0, neginf=0.0))
        film_w.index_add_(0, px, torch.ones_like(px, dtype=film_w.dtype))

    for _ in range(config.max_depth + total // C + 64):
        if next_ray >= total and not bool(alive.any()):
            break
        iters += 1
        dead = ~alive
        new_id = next_ray + torch.cumsum(dead, 0) - 1
        take = dead & (new_id < total)
        flush(dead & (pixel >= 0))
        n_taken = int(take.sum())
        pixel = torch.where(dead, -1, pixel)
        if n_taken:
            lanes = take.nonzero()[:, 0]
            pix_n, o_n, d_n, state_n = twf._camera_ray(scene, new_id[lanes], seed, width, height)
            pixel[lanes], o[lanes], d[lanes], state[lanes] = pix_n, o_n, d_n, state_n
            throughput[lanes], L[lanes], depth[lanes] = 1.0, 0.0, 0
            prev_pdf[lanes], prev_delta[lanes] = 0.0, True
            eta_scale[lanes] = 1.0
            if path_len is not None:
                path_len[lanes] = 0.0
            alive = alive | take
        out = tpt.surface_bounce(scene, config, o=o, d=d, active=alive, throughput=throughput,
                                 prev_pdf=prev_pdf, prev_delta=prev_delta, eta_scale=eta_scale,
                                 path_len=path_len, sampler=Sampler(state=state), depth=depth,
                                 cone=cone, pack=pack)
        cont = out.cont & (depth + 1 < config.max_depth)
        L = L + out.L_add
        next_ray += n_taken
        drain = next_ray >= total and int(cont.sum()) < C // 8
        smp, u_drain = out.sampler.next_1d()
        p_keep = 0.25 if drain else 1.0
        tp_out = out.throughput / p_keep
        cont = cont & (u_drain < p_keep)
        c3 = cont[:, None]
        o, d = torch.where(c3, out.o, o), torch.where(c3, out.d, d)
        throughput = torch.where(c3, tp_out, throughput)
        depth, state = depth + 1, smp.state
        prev_pdf = torch.where(cont, out.bs_pdf, prev_pdf)
        prev_delta = torch.where(cont, out.delta_now, prev_delta)
        eta_scale = torch.where(cont, out.eta_scale, eta_scale)
        if path_len is not None:
            path_len = torch.where(cont, out.path_len, path_len)
        alive = cont
        n_rays = n_rays + out.n_rays
    flush(pixel >= 0)
    img = film / torch.clamp(film_w, min=1e-8)[:, None]
    return img.reshape(height, width, 3), n_rays, iters


@pytest.mark.parametrize("name,capacity", [("cornell", 256), ("glossy", None)])
def test_fixed_shape_refill_equals_previous_loop(scenes, name, capacity):
    """A pool smaller than the supply (refills over many iterations, the
    tail drain) and one full wave: the same lanes and the same draws."""
    _, ts = scenes[name]
    cfg = tpt.specialize_config(ts, tpt.PTConfig(max_depth=5))
    W, H, spp = 24, 16, 4
    cap = twf._capacity(W, H, spp, capacity)
    old_img, old_rays, old_iters = _old_wavefront(ts, W, H, spp, 9, cfg, cap)
    img, c = twf.render_wavefront_with_counters(ts, W, H, spp, 9, cfg, capacity=cap)
    assert torch.equal(img, old_img)
    assert int(c["n_rays"]) == int(old_rays) and c["n_iters"] == old_iters
    # the small pool refills beyond one wave; the full wave ends at the depth
    assert old_iters > cfg.max_depth if capacity else old_iters == cfg.max_depth
