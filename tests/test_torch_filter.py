"""Filter-importance splatting and path-space regularization against the
JAX package on the CPU: the five reconstruction filters, the post-process
blur, the filtered film (`add_samples_filtered`) and its gradient,
filtered and regularized renders per pixel, and the port's own versions of
`test_regularization_unbiased_on_diffuse` and `TestFilterSplatting`
(tests/test_render.py:252-310) at those tests' sizes.

Tolerances:
  * filter weights, taps and the blur: within 1e-6 relative plus 1e-7 (the
    same float32 operations; the blur's taps summed in tap order);
  * the filtered film: within 1e-5 relative plus 1e-6 of the largest
    pixel (the port sums each pixel's taps in float64 once, JAX adds them in
    float32 tap by tap); its gradient within 1e-6 (a gather);
  * renders at 16x16, 2 spp, depth 4, seed 3: 99% of pixels within 1e-3
    relative on every channel and the means within 1e-4 relative.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.image import film as jfilm
from cudatracerlib_tpu.image import pipeline as jpipe
from cudatracerlib_tpu.render import path_tracer as jpt
from cudatracerlib_tpu.scene.shapes import caustic_scene as jcaustic
from cudatracerlib_tpu.scene.shapes import cornell_box as jcornell
from cudatracerlib_tpu_torch.convert import flatten, scene_from_numpy
from cudatracerlib_tpu_torch.image import film as tfilm
from cudatracerlib_tpu_torch.image import pipeline as tpipe
from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops
from cudatracerlib_tpu_torch.render import path_tracer as tpt
from cudatracerlib_tpu_torch.render import wavefront as twf
from cudatracerlib_tpu_torch.scene import bsdf as tbsdf
from cudatracerlib_tpu_torch.scene.shapes import cornell_box as tcornell

W = H = 16
SPP, SEED, DEPTH = 2, 3, 4
FILTERS = [tpipe.BOX, tpipe.GAUSSIAN, tpipe.MITCHELL, tpipe.LANCZOS, tpipe.TRIANGLE]
FILTER_IDS = ["box", "gaussian", "mitchell", "lanczos", "triangle"]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("ftype", FILTERS, ids=FILTER_IDS)
def test_filter_eval_and_kernel(ftype):
    x = np.linspace(-3.2, 3.2, 641).astype(np.float32)
    for radius in (0.5, 1.5, 2.0):
        np.testing.assert_allclose(tpipe.filter_eval_1d(ftype, _t(x), radius).numpy(),
                                   np.asarray(jpipe.filter_eval_1d(ftype, jnp.asarray(x), radius)),
                                   rtol=1e-6, atol=1e-7)
        for taps in (3, 4, 5):
            np.testing.assert_allclose(tpipe.filter_kernel_1d(ftype, radius, taps).numpy(),
                                       np.asarray(jpipe.filter_kernel_1d(ftype, radius, taps)),
                                       rtol=1e-6, atol=1e-7)
    img = np.random.default_rng(ftype).uniform(0, 2, (9, 12, 3)).astype(np.float32)
    for taps in (1, 3, 4, 5):
        np.testing.assert_allclose(tpipe.apply_filter(_t(img), ftype, 1.5, taps).numpy(),
                                   np.asarray(jpipe.apply_filter(jnp.asarray(img), ftype, 1.5,
                                                                 taps)),
                                   rtol=1e-6, atol=1e-6)


def _samples(n, h, w, seed):
    rng = np.random.default_rng(seed)
    sx = rng.uniform(0, w, n).astype(np.float32)
    sy = rng.uniform(0, h, n).astype(np.float32)
    val = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    val[::97] = np.nan   # non-finite samples count as 0
    return sx, sy, val


@pytest.mark.parametrize("ftype,support", [(f, s) for f in FILTERS[1:] for s in (1, 2)],
                         ids=[f"{n}-{s}" for n in FILTER_IDS[1:] for s in (1, 2)])
def test_add_samples_filtered_matches_jax(ftype, support):
    h, w = 9, 12
    sx, sy, val = _samples(3000, h, w, 10 + ftype)
    want = jfilm.add_samples_filtered(jfilm.Film.create(h, w), jnp.asarray(sx), jnp.asarray(sy),
                                      jnp.asarray(val), ftype, 1.5, support)
    got = tfilm.add_samples_filtered(tfilm.Film.create(h, w, device="cpu"), _t(sx), _t(sy),
                                     _t(val), ftype, 1.5, support)
    for f in ("rgb", "weight"):
        j = np.asarray(getattr(want, f))
        np.testing.assert_allclose(getattr(got, f).numpy(), j, rtol=1e-5,
                                   atol=1e-6 * np.abs(j).max(), err_msg=f)
    assert float(got.weight.min()) > 0


def test_add_samples_filtered_gradient_matches_jax():
    """The film's backward is a gather of the cotangent at each tap's pixel,
    0 for the dropped out-of-image taps: jax.grad of the same film."""
    h, w = 7, 10
    sx, sy, val = _samples(800, h, w, 20)
    val = np.nan_to_num(val)
    g = np.random.default_rng(21).uniform(-1, 1, (h, w, 3)).astype(np.float32)
    gw = np.random.default_rng(22).uniform(-1, 1, (h, w)).astype(np.float32)

    def jloss(v):
        f = jfilm.add_samples_filtered(jfilm.Film.create(h, w), jnp.asarray(sx), jnp.asarray(sy),
                                       v, tpipe.MITCHELL, 2.0, 2)
        return jnp.sum(f.rgb * g) + jnp.sum(f.weight * gw)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(val)))
    v = _t(val).requires_grad_()
    f = tfilm.add_samples_filtered(tfilm.Film.create(h, w, device="cpu"), _t(sx), _t(sy), v,
                                   tpipe.MITCHELL, 2.0, 2)
    ((f.rgb * _t(g)).sum() + (f.weight * _t(gw)).sum()).backward()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(v.grad.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("support", [1, 2])
def test_add_samples_filtered_in_runs_matches_jax(support, monkeypatch):
    """With the scratch budget cut to a fifth of what one call takes, the
    samples (the path tracer's order: 32x32 screen tiles, repeated per
    sample) go in four or more runs, each call within the budget and given
    only the image rows its taps reach, and the film and its gradient still
    match JAX's (tolerances as above)."""
    h, w, spp = 72, 40, 2
    order = tpt.block_order_pixels_np(w, h)
    pix = np.tile(order, spp)
    rng = np.random.default_rng(30 + support)
    sx = (pix % w + rng.uniform(0, 1, pix.size)).astype(np.float32)
    sy = (pix // w + rng.uniform(0, 1, pix.size)).astype(np.float32)
    val = rng.uniform(0, 2, (pix.size, 3)).astype(np.float32)
    g = rng.uniform(-1, 1, (h, w, 3)).astype(np.float32)
    k = (2 * support + 1) ** 2
    budget = sg_ops.bwd_scratch_floats(4, k * pix.size, h * w + 1) // 5
    monkeypatch.setattr(tfilm, "SPLAT_SCRATCH_FLOATS", budget)
    calls, real = [], tfilm.splat_sum

    def counted(pid, taps, n_rows):
        calls.append(n_rows)
        assert sg_ops.bwd_scratch_floats(4, taps.shape[0], n_rows) <= budget
        return real(pid, taps, n_rows)

    monkeypatch.setattr(tfilm, "splat_sum", counted)

    def jloss(v):
        f = jfilm.add_samples_filtered(jfilm.Film.create(h, w), jnp.asarray(sx), jnp.asarray(sy),
                                       v, tpipe.GAUSSIAN, 1.5, support)
        return jnp.sum(f.rgb * g), f

    (_, want), want_grad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(val))
    v = _t(val).requires_grad_()
    got = tfilm.add_samples_filtered(tfilm.Film.create(h, w, device="cpu"), _t(sx), _t(sy), v,
                                     tpipe.GAUSSIAN, 1.5, support)
    (got.rgb * _t(g)).sum().backward()
    assert len(calls) >= 4 and max(calls) < h * w + 1, calls
    for f in ("rgb", "weight"):
        j = np.asarray(getattr(want, f))
        np.testing.assert_allclose(getattr(got, f).detach().numpy(), j, rtol=1e-5,
                                   atol=1e-6 * np.abs(j).max(), err_msg=f)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-6)


def _assert_images_close(got, want, frac=0.99, rel=1e-3):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    ok = (np.abs(got - want) <= rel * np.abs(want) + 1e-6).all(-1)
    assert ok.mean() >= frac, f"only {ok.mean():.4f} of pixels within {rel}"
    assert abs(got.mean() - want.mean()) <= 1e-4 * abs(want.mean())


@pytest.fixture(scope="module")
def cornell():
    js = jcornell()
    return js, scene_from_numpy(flatten(js), device="cpu")


@pytest.mark.parametrize("ftype", [tpipe.GAUSSIAN, tpipe.MITCHELL], ids=["gaussian", "mitchell"])
def test_filtered_render_matches_jax(cornell, ftype):
    js, ts = cornell
    cfg = dict(max_depth=DEPTH, rec_filter=ftype, rec_radius=1.5)
    want = jpt.render(js, W, H, SPP, SEED, jpt.PTConfig(**cfg))
    got = tpt.render(ts, W, H, SPP, SEED, tpt.PTConfig(**cfg))
    _assert_images_close(got, want)
    box = tpt.render(ts, W, H, SPP, SEED, tpt.PTConfig(max_depth=DEPTH))
    assert float((got - box).abs().max()) > 1e-3   # the filter moves the image


def test_regularized_caustic_render_matches_jax():
    """Regularization 0.1 on the caustic scene (a smooth DIELECTRIC sphere):
    the delta lobes turn ROUGHDIELECTRIC after the first bounce, as in
    JAX; the type set gains ROUGHDIELECTRIC."""
    js = jcaustic()
    ts = scene_from_numpy(flatten(js), device="cpu")
    cfg = dict(max_depth=DEPTH, regularization=0.1)
    spec = tpt.specialize_config(ts, tpt.PTConfig(**cfg))
    assert spec.bsdf_types == jpt.specialize_config(js, jpt.PTConfig(**cfg)).bsdf_types
    assert tbsdf.ROUGHDIELECTRIC in spec.bsdf_types
    want = jpt.render(js, W, H, SPP, SEED, jpt.PTConfig(**cfg))
    got = tpt.render(ts, W, H, SPP, SEED, tpt.PTConfig(**cfg))
    _assert_images_close(got, want)
    plain = tpt.render(ts, W, H, SPP, SEED, tpt.PTConfig(max_depth=DEPTH))
    assert float((got - plain).abs().max()) > 1e-3


def test_regularize_mollifies_only_delta_lobes():
    """`_regularize` at depth 0 leaves every lane; later it turns CONDUCTOR
    ROUGHCONDUCTOR and (THIN)DIELECTRIC ROUGHDIELECTRIC with the given
    alpha, per lane when depth is a tensor (the wavefront pool)."""
    tags = torch.arange(16, dtype=torch.int32)
    mp = tbsdf.MatParams(bsdf_type=tags, dist_type=torch.ones(16, dtype=torch.int32),
                         albedo=torch.ones(16, 3), specular=torch.ones(16, 3),
                         transmittance=torch.ones(16, 3), eta=torch.full((16,), 1.5),
                         cond_eta=torch.ones(16, 3), cond_k=torch.ones(16, 3),
                         alpha_u=torch.full((16,), 0.4), alpha_v=torch.full((16,), 0.5),
                         exponent=torch.ones(16), nonlinear=torch.zeros(16),
                         blend_weight=torch.ones(16))
    assert torch.equal(tpt._regularize(mp, 0, 0.1).bsdf_type, tags)
    out = tpt._regularize(mp, torch.tensor([0, 1] * 8), 0.1)
    moved = {int(t): int(out.bsdf_type[t]) for t in range(16) if out.bsdf_type[t] != t}
    assert moved == {3: tbsdf.ROUGHDIELECTRIC, 5: tbsdf.ROUGHCONDUCTOR}   # odd lanes only
    assert float(out.alpha_u[5]) == pytest.approx(0.1) and float(out.alpha_v[3]) == pytest.approx(0.1)
    assert float(out.alpha_u[2]) == pytest.approx(0.4)


def test_wavefront_ignores_rec_filter():
    """The JAX wavefront engine has no filtered film; neither has the
    port's: rec_filter leaves its image as it is."""
    ts = tcornell(device="cpu")
    a = twf.render_wavefront(ts, 8, 8, 2, 3, tpt.PTConfig(max_depth=3))
    b = twf.render_wavefront(ts, 8, 8, 2, 3, tpt.PTConfig(max_depth=3, rec_filter=1))
    assert torch.equal(a, b)


# ---- the port's versions of JAX's tests (tests/test_render.py:252-310) ----

def test_port_regularization_unbiased_on_diffuse():
    """Mollification only affects delta lobes; a diffuse scene is
    unchanged."""
    scene = tcornell(device="cpu")
    a = tpt.render(scene, 16, 16, 2, 0, tpt.PTConfig(max_depth=3, rr_start=99))
    b = tpt.render(scene, 16, 16, 2, 0, tpt.PTConfig(max_depth=3, rr_start=99,
                                                     regularization=0.1))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_port_gaussian_accumulation_beats_post_blur():
    """Filter-importance splatting beats the post-process blur on MSE
    against a converged splat-filtered image at equal rays."""
    scene = tcornell(device="cpu")
    w = h = 48
    cfg_splat = tpt.PTConfig(max_depth=3, rec_filter=tpipe.GAUSSIAN, rec_radius=1.5)
    ref = sum(tpt.render(scene, w, h, 32, 100 + s, cfg_splat) for s in range(4)) / 4
    box = tpt.render(scene, w, h, 4, 7, tpt.PTConfig(max_depth=3))
    blurred = tpipe.apply_filter(box, tpipe.GAUSSIAN, radius=1.5, taps=3)
    splat = tpt.render(scene, w, h, 4, 7, cfg_splat)
    mse_blur = float(((blurred - ref) ** 2).mean())
    mse_splat = float(((splat - ref) ** 2).mean())
    assert mse_splat < mse_blur, (mse_splat, mse_blur)


def test_port_box_filter_path_unchanged():
    """rec_filter=0 takes the reshape-sum film bit for bit."""
    scene = tcornell(device="cpu")
    a = tpt.render(scene, 24, 24, 2, 3, tpt.PTConfig(max_depth=2))
    b = tpt.render(scene, 24, 24, 2, 3, tpt.PTConfig(max_depth=2, rec_filter=0))
    assert torch.equal(a, b)
