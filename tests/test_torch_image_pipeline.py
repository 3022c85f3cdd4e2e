"""The film's and the image pipeline's functions against the JAX package
on the CPU: `film.add_splats`, `finish_pass`, `develop` with a splat scale
and `luminance_stats`; `pipeline.reinhard_tonemap`, `gamma_correct`,
`nlm_denoise` and `apply_pipeline` over every stage order it runs.

Tolerances, stated once: splat buffers and developed images within 1e-6
of their largest entry (the port's splat sum adds in float64, XLA's
scatter in float32, so a pixel's sum may round apart); the pipeline's
stages within 1e-6 of the largest entry; the luminance statistics within
1e-6 relative.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.image import film as jf
from cudatracerlib_tpu.image import pipeline as jpl
from cudatracerlib_tpu_torch.image import film as tf
from cudatracerlib_tpu_torch.image import pipeline as tpl

H, W = 20, 24


def _close(got, ref, tol=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(0)
    img = rng.gamma(2.0, 0.3, (H, W, 3)).astype(np.float32)
    img[3:6, 10:14] *= 20.0                              # a highlight for the tone map
    var = rng.uniform(1e-3, 5e-2, (H, W)).astype(np.float32)
    return img, var


@pytest.mark.parametrize("masked", [False, True])
def test_splats_and_develop_match_jax(masked):
    rng = np.random.default_rng(1)
    n = 6000
    pid = rng.integers(0, H * W, n).astype(np.int32)
    val = rng.normal(size=(n, 3)).astype(np.float32)
    val[7, 1], val[9, 0] = np.nan, np.inf               # counted as 0
    mask = rng.random(n) < 0.7 if masked else None
    fj, ft = jf.Film.create(H, W), tf.Film.create(H, W, device="cpu")
    for k in range(2):
        sl = slice(k * n // 2, (k + 1) * n // 2)
        m = None if mask is None else mask[sl]
        fj = jf.finish_pass(jf.add_splats(fj, jnp.asarray(pid[sl]), jnp.asarray(val[sl]),
                                          None if m is None else jnp.asarray(m)))
        ft = tf.finish_pass(tf.add_splats(ft, torch.from_numpy(pid[sl]), torch.from_numpy(val[sl]),
                                          None if m is None else torch.from_numpy(m)))
    _close(ft.splat, fj.splat)
    assert float(ft.n_passes) == float(fj.n_passes) == 2.0
    fj = jf.add_samples(fj, jnp.asarray(pid[:500]), jnp.asarray(np.abs(val[:500])))
    ft = tf.add_samples(ft, torch.from_numpy(pid[:500]), torch.from_numpy(np.abs(val[:500])))
    for scale in (1.0, 0.25):
        _close(tf.develop(ft, scale), jf.develop(fj, scale))


def test_luminance_stats_match_jax(image):
    img, _ = image
    got, ref = tf.luminance_stats(torch.from_numpy(img)), jf.luminance_stats(jnp.asarray(img))
    assert set(got) == set(ref)
    for k in ref:
        assert float(got[k]) == pytest.approx(float(ref[k]), rel=1e-6)


def test_pipeline_stages_match_jax(image):
    img, var = image
    t, j = torch.from_numpy(img), jnp.asarray(img)
    _close(tpl.reinhard_tonemap(t), jpl.reinhard_tonemap(j))
    _close(tpl.reinhard_tonemap(t, key=0.3, burn=0.5), jpl.reinhard_tonemap(j, key=0.3, burn=0.5))
    _close(tpl.gamma_correct(t - 0.2), jpl.gamma_correct(j - 0.2))
    _close(tpl.gamma_correct(t, 1.8), jpl.gamma_correct(j, 1.8))
    _close(tpl.nlm_denoise(t, torch.from_numpy(var)), jpl.nlm_denoise(j, jnp.asarray(var)))
    _close(tpl.nlm_denoise(t, torch.from_numpy(var), 0.8, 5, 5),
           jpl.nlm_denoise(j, jnp.asarray(var), 0.8, 5, 5))


@pytest.mark.parametrize("ftype,tonemap,denoise,gamma", [
    (tpl.BOX, False, False, None), (tpl.GAUSSIAN, True, True, 2.2),
    (tpl.MITCHELL, False, True, None), (tpl.BOX, True, False, 2.2)])
def test_apply_pipeline_matches_jax(image, ftype, tonemap, denoise, gamma):
    img, var = image
    _close(tpl.apply_pipeline(torch.from_numpy(img), torch.from_numpy(var), ftype, tonemap,
                              denoise, gamma),
           jpl.apply_pipeline(jnp.asarray(img), jnp.asarray(var), ftype, tonemap, denoise, gamma))
