"""Adaptive sampling: image/variance.py and render/adaptive.py against the
JAX package on the CPU (the Cornell box, its arrays carried across).

Tolerances, stated once:
  * the variance buffer, block weights (all four modes) and the per-pixel
    spp map within 1e-6 (relative to each array's largest entry);
  * `assign_rays_to_pixels` on seeded weights: at most 1e-3 of the rays in
    another pixel than JAX's, each by one pixel, and at most 5e-3 with
    another sample index, each by one where the pixel agrees (torch's CPU
    cumsum accumulates the float32 CDF in float64, XLA's in float32, so a
    ray or a pixel's first slot on a CDF boundary can move);
  * renders, every pixel within 1e-4 of JAX's: `render_adaptive_host`
    (32x32, 4 spp, 3 passes), `render_wavefront_adaptive` (32x32, 4 spp, 3
    waves, capacity 2048), and one wave given JAX's own pixel map.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.image import variance as jvar
from cudatracerlib_tpu.render import adaptive as jada
from cudatracerlib_tpu.render import path_tracer as jpt
from cudatracerlib_tpu.render import wavefront as jwf
from cudatracerlib_tpu.scene.shapes import cornell_box as jcornell
from cudatracerlib_tpu_torch.convert import flatten, scene_from_numpy
from cudatracerlib_tpu_torch.image import variance as tvar
from cudatracerlib_tpu_torch.render import adaptive as tada
from cudatracerlib_tpu_torch.render import path_tracer as tpt
from cudatracerlib_tpu_torch.render import wavefront as twf

H, W = 48, 64
MODES = [tvar.UNIFORM, tvar.VARIANCE, tvar.DIFFERENCE, tvar.SELECT]


def _close(got, ref, tol=1e-6):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def buffers():
    """Four passes of seeded noisy images into both packages' buffers, the
    last two masked."""
    rng = np.random.default_rng(11)
    jb, tb = jvar.VarianceBuffer.create(H, W), tvar.VarianceBuffer.create(H, W, device="cpu")
    for k in range(4):
        img = (rng.gamma(2.0, 0.2, (H, W, 3)) * (1 + 3 * (np.arange(W) > 40))[None, :, None])
        img = img.astype(np.float32)
        mask = None if k < 2 else rng.random((H, W)) < 0.7
        jb = jvar.add_pass(jb, jnp.asarray(img), jnp.uint32(k),
                           None if mask is None else jnp.asarray(mask))
        tb = tvar.add_pass(tb, torch.from_numpy(img), k,
                           None if mask is None else torch.from_numpy(mask))
    return jb, tb


def test_add_pass_matches_jax(buffers):
    jb, tb = buffers
    for f in tvar.VarianceBuffer._fields:
        _close(getattr(tb, f), getattr(jb, f))
    _close(tvar.pixel_variance(tb), jvar.pixel_variance(jb))
    _close(tvar.half_buffer_error(tb), jvar.half_buffer_error(jb))


@pytest.mark.parametrize("mode", MODES)
def test_block_weights_match_jax(buffers, mode):
    jb, tb = buffers
    rect = (10, 5, 40, 30) if mode == tvar.SELECT else None
    ref = jvar.block_weights(jb, mode, rect=rect)
    got = tvar.block_weights(tb, mode, rect=rect)
    _close(got, ref)
    assert abs(float(got.mean()) - 1.0) < 1e-5


@pytest.mark.parametrize("mode", [tvar.VARIANCE, tvar.DIFFERENCE])
def test_per_pixel_spp_matches_jax(buffers, mode):
    jb, tb = buffers
    ref = np.asarray(jvar.per_pixel_spp(jb, 8, mode))
    got = tvar.per_pixel_spp(tb, 8, mode)
    assert got.dtype == torch.int32 and got.shape == (H // 16 * 16, W // 16 * 16)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(np.unique(ref)) > 1


def test_assign_rays_to_pixels_matches_jax():
    rng = np.random.default_rng(5)
    w = (rng.gamma(0.7, 1.0, 4096) + 1e-3).astype(np.float32)
    n = 4096 * 6
    jp, js = (np.asarray(x) for x in jada.assign_rays_to_pixels(jnp.asarray(w), n))
    tp, ts = (x.numpy() for x in tada.assign_rays_to_pixels(torch.from_numpy(w), n))
    moved = tp != jp
    assert moved.mean() <= 1e-3 and (np.abs(tp - jp)[moved] <= 1).all()
    off = ts != js          # a pixel's first slot, ceil(cdf[pix - 1] n - 0.5), moves alike
    assert off.mean() <= 5e-3 and (np.abs(ts - js)[off & ~moved] <= 1).all()
    assert np.all(np.diff(tp) >= 0) and tp.dtype == np.int32
    # each pixel's share follows its weight
    counts = np.bincount(tp, minlength=4096)
    assert np.abs(counts - n * w / w.sum()).max() <= 1.0 + 1e-3


@pytest.fixture(scope="module")
def cornell():
    js = jcornell()
    return js, scene_from_numpy(flatten(js), device="cpu")


def test_render_adaptive_host_matches_jax(cornell):
    js, ts = cornell
    cfg = dict(max_depth=4)
    ref = np.asarray(jada.render_adaptive_host(js, 32, 32, 4, 3, 5, jpt.PTConfig(**cfg)))
    img = tada.render_adaptive_host(ts, 32, 32, 4, 3, 5, tpt.PTConfig(**cfg)).numpy()
    assert np.isfinite(img).all() and img.mean() > 0.05
    np.testing.assert_allclose(img, ref, rtol=0, atol=1e-4)


def test_render_wavefront_adaptive_matches_jax(cornell):
    js, ts = cornell
    cfg = dict(max_depth=4)
    ref = np.asarray(jada.render_wavefront_adaptive(js, 32, 32, 4, 3, 9, jpt.PTConfig(**cfg),
                                                    capacity=2048))
    img = tada.render_wavefront_adaptive(ts, 32, 32, 4, 3, 9, tpt.PTConfig(**cfg),
                                         capacity=2048).numpy()
    assert np.isfinite(img).all() and img.mean() > 0.05
    np.testing.assert_allclose(img, ref, rtol=0, atol=1e-4)


def test_wave_with_jax_pixel_map_matches_jax(cornell):
    """One wave through each engine's `pixel_map` path, both given JAX's
    map: the same lanes, pixels and sample keys."""
    js, ts = cornell
    rng = np.random.default_rng(8)
    w = rng.gamma(0.5, 1.0, 32 * 32).astype(np.float32)
    pmap, _ = jada.assign_rays_to_pixels(jnp.asarray(w), 32 * 32 * 4)
    jcfg = jpt.specialize_config(js, jpt.PTConfig(max_depth=4))
    ref = np.asarray(jwf._wavefront_impl(js, 32, 32, 4, jnp.uint32(2 ** 32 - 3), jcfg, 2048,
                                         pixel_map=pmap))
    tcfg = tpt.specialize_config(ts, tpt.PTConfig(max_depth=4))
    img = twf._wavefront(ts, 32, 32, 4, 2 ** 32 - 3, tcfg, 2048,
                         pixel_map=torch.from_numpy(np.asarray(pmap)))[0].numpy()
    np.testing.assert_allclose(img, ref, rtol=0, atol=1e-4)
    # pixels the map leaves out stay black
    empty = np.bincount(np.asarray(pmap), minlength=32 * 32) == 0
    assert empty.any() and (img.reshape(-1, 3)[empty] == 0).all()
