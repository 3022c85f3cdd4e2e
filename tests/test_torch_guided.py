"""Path guiding and the parametric models: models/*.py and
render/guided.py against the JAX package on the CPU (scenes built by JAX
and carried across by `convert`, with the JAX package's trained histogram
where a test renders from the same state).

Tolerances, stated once:
  * models: the grid's cells equal; the discretized model's histogram,
    pdf and samples and `histogram_density` within 1e-6 of the largest
    entry; the GMM's EM step (D = 2 and 3, 5 components) within 1e-5 of
    each field's largest entry, the covariances within 3e-4 (the port's
    row sums add in float64, XLA's in float32, and s2 / s0 - mean^2
    cancels about 14x here), its pdf within 1e-5 relative, its samples
    within 1e-5 (the closed-form Cholesky against JAX's LAPACK call);
  * the trained histogram (Cornell, res 6, two batches of 2^12 photons):
    the deposits' rows equal except bin-edge flips, at most 1e-3 of the
    deposits (`_dir_to_uv`'s atan2 puts a photon one bin over), and every
    cell within 1e-5 of the histogram's sum, plus the flipped deposits'
    luminance (each moves its luminance from one bin to another);
  * `_guided_sample` / `_guided_pdf` on 4,096 seeded lanes with JAX's
    histogram: the chosen bin equal except CDF-edge flips, at most 1e-3 of
    the lanes (torch's CPU cumsum accumulates float32 in float64, XLA's in
    float32); where it agrees, directions within 1e-5 and pdfs within 1e-5
    relative;
  * `render_guided` from JAX's histogram, Cornell and the caustic scene,
    16x16 at 4 spp, depth 5: every pixel within 1e-4 of the image's
    largest entry;
  * JAX's two unbiasedness gates on the port (tests/test_guided.py): the
    guided render's block means within 0.1 (relative L1) of the path
    tracer's after training, and within 0.08 with an empty histogram.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.models import discretized as jdm
from cudatracerlib_tpu.models import gmm as jgmm
from cudatracerlib_tpu.models import grid as jgrid
from cudatracerlib_tpu.render import guided as jg
from cudatracerlib_tpu.render import path_tracer as jpt
from cudatracerlib_tpu.render import ppm as jppm
from cudatracerlib_tpu.scene.shapes import caustic_scene as jcaustic
from cudatracerlib_tpu.scene.shapes import cornell_box as jcornell
from cudatracerlib_tpu_torch import convert
from cudatracerlib_tpu_torch.models import discretized as tdm
from cudatracerlib_tpu_torch.models import gmm as tgmm
from cudatracerlib_tpu_torch.models import grid as tgrid
from cudatracerlib_tpu_torch.render import guided as tg
from cudatracerlib_tpu_torch.render import path_tracer as tpt
from cudatracerlib_tpu_torch.render import ppm as tppm

TRAIN = dict(max_depth=5, rr_start=2)


def _close(got, ref, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def scenes():
    return {k: (js, convert.scene_from_numpy(convert.flatten(js), device="cpu"))
            for k, js in (("cornell", jcornell()), ("caustic", jcaustic()))}


@pytest.fixture(scope="module")
def trained(scenes):
    """Both packages' guiding after two batches of 2^12 photons on Cornell
    (res 6)."""
    js, ts = scenes["cornell"]
    jgd, tgd = jg.make_guiding(js, res=6), tg.make_guiding(ts, res=6)
    for i in range(2):
        jgd = jg.train_guiding(js, jgd, 1 << 12, i, jpt.PTConfig(**TRAIN))
        tgd = tg.train_guiding(ts, tgd, 1 << 12, i, tpt.PTConfig(**TRAIN))
    return jgd, tgd


# ---- models ----

def test_model_grid_and_discretized_match_jax():
    rng = np.random.default_rng(0)
    p = rng.uniform(-1.2, 1.2, (3000, 3)).astype(np.float32)
    jgr = jgrid.make_model_grid([-1, -1, -1], [1, 1, 1], 5)
    tgr = tgrid.make_model_grid([-1, -1, -1], [1, 1, 1], 5, device="cpu")
    cj = np.asarray(jgrid.cell_of_position(jgr, jnp.asarray(p)))
    ct = tgrid.cell_of_position(tgr, _t(p))
    np.testing.assert_array_equal(ct.numpy(), cj)
    assert tgrid.n_cells(tgr) == jgrid.n_cells(jgr) == 125

    x = rng.uniform(-0.5, 2.5, 3000).astype(np.float32)
    w = rng.gamma(2.0, 1.0, 3000).astype(np.float32)
    jm = jdm.discretized_update(jdm.discretized_init(125, 16, 0.0, 2.0), jnp.asarray(cj),
                                jnp.asarray(x), jnp.asarray(w))
    tm = tdm.discretized_update(tdm.discretized_init(125, 16, 0.0, 2.0, device="cpu"), ct,
                                _t(x), _t(w))
    _close(tm.hist, jm.hist, 1e-6)
    tm = convert.discretized_from_numpy(convert.flatten(jm), device="cpu")
    cells = rng.integers(0, 125, 2048)
    u = rng.random(2048, dtype=np.float32)
    _close(tdm.discretized_pdf(tm, _t(cells), _t(x[:2048])),
           jdm.discretized_pdf(jm, jnp.asarray(cells), jnp.asarray(x[:2048])), 1e-6)
    xs_t, pdf_t = tdm.discretized_sample(tm, _t(cells), _t(u))
    xs_j, pdf_j = jdm.discretized_sample(jm, jnp.asarray(cells), jnp.asarray(u))
    _close(xs_t, xs_j, 1e-6)
    _close(pdf_t, pdf_j, 1e-6)
    s = rng.random((4000, 2), dtype=np.float32) ** 2
    for got, ref in zip(tdm.histogram_density(_t(s), 8), jdm.histogram_density(jnp.asarray(s), 8)):
        _close(got, ref, 1e-6)


@pytest.mark.parametrize("dim", [2, 3])
def test_gmm_matches_jax(dim):
    rng = np.random.default_rng(dim)
    C, K, N = 4, 5, 4096
    jm, tm = jgmm.gmm_init(C, K, dim), tgmm.gmm_init(C, K, dim, device="cpu")
    for f in tgmm.GMM._fields:
        _close(getattr(tm, f), getattr(jm, f), 1e-7)
    for step in range(3):
        cell = rng.integers(0, C - 1, N)                  # the last cell gets no samples
        x = (rng.normal(size=(N, dim)) * 0.15 + rng.uniform(0.2, 0.8, (1, dim))).astype(np.float32)
        sw = rng.gamma(2.0, 0.5, N).astype(np.float32)
        jm = jgmm.gmm_em_step(jm, jnp.asarray(cell), jnp.asarray(x), jnp.asarray(sw))
        tm = tgmm.gmm_em_step(tm, _t(cell), _t(x), _t(sw))
        for f in tgmm.GMM._fields:
            _close(getattr(tm, f), getattr(jm, f), 3e-4 if f == "cov" else 1e-5)
        tm = convert.gmm_from_numpy(convert.flatten(jm), device="cpu")   # JAX's state onward
    q = rng.uniform(0.0, 1.0, (2048, dim)).astype(np.float32)
    cq = rng.integers(0, C, 2048)
    np.testing.assert_allclose(tgmm.gmm_pdf(tm, _t(cq), _t(q)).numpy(),
                               np.asarray(jgmm.gmm_pdf(jm, jnp.asarray(cq), jnp.asarray(q))),
                               rtol=1e-5)
    us, ug = rng.random(2048, dtype=np.float32), rng.normal(size=(2048, dim)).astype(np.float32)
    _close(tgmm.gmm_sample(tm, _t(cq), _t(us), _t(ug)),
           jgmm.gmm_sample(jm, jnp.asarray(cq), jnp.asarray(us), jnp.asarray(ug)), 1e-5)


# ---- training, sampling, rendering ----

def test_trained_histogram_matches_jax(scenes, trained):
    js, ts = scenes["cornell"]
    jgd, tgd = trained
    # the second batch's photons, deposit by deposit
    pm_j = jppm.trace_photons(js, 1 << 12, jnp.uint32(1),
                              jpt.specialize_config(js, jpt.PTConfig(**TRAIN)))
    pm_t = tppm.trace_photons(ts, 1 << 12, 1, tpt.specialize_config(ts, tpt.PTConfig(**TRAIN)))
    flat_t, lum_t = tg.deposit_rows(tgd, pm_t)
    flat_j = (np.asarray(jgrid.cell_of_position(jgd.grid, pm_j.p)) * 64
              + np.asarray(jg._bin_of(jg._dir_to_uv(pm_j.wi))))
    valid = pm_j.valid.__array__()
    np.testing.assert_array_equal(pm_t.valid.numpy(), valid)
    flips = valid & (flat_t.numpy() != flat_j)
    assert int(flips.sum()) <= 1e-3 * int(valid.sum()) + 1, int(flips.sum())
    h_j, h_t = np.asarray(jgd.hist), tgd.hist.numpy()
    moved = float(lum_t.numpy()[flips].sum())
    assert np.abs(h_t - h_j).max() <= 1e-5 * h_j.sum() + moved
    assert h_t.sum() == pytest.approx(h_j.sum(), rel=1e-6)
    assert (h_t >= 0).all() and (h_t.sum(1) > 0).mean() > 0.05


def test_guided_sample_and_pdf_match_jax(trained):
    jgd, _ = trained
    tgd = convert.guiding_from_numpy(convert.flatten(jgd), device="cpu")
    rng = np.random.default_rng(2)
    p = rng.uniform([-0.9, 0.1, 0.1], [0.9, 1.9, 1.9], (4096, 3)).astype(np.float32)
    u1 = rng.random(4096, dtype=np.float32)
    u2 = rng.random((4096, 2), dtype=np.float32)
    d_t, pdf_t, use_t = tg._guided_sample(tgd, _t(p), _t(u1), _t(u2))
    d_j, pdf_j, use_j = (np.asarray(x) for x in jg._guided_sample(jgd, jnp.asarray(p),
                                                                  jnp.asarray(u1), jnp.asarray(u2)))
    np.testing.assert_array_equal(use_t.numpy(), use_j)
    same = (np.abs(d_t.numpy() - d_j).max(-1) <= 1e-5) & use_j
    assert (~same & use_j).sum() <= 1e-3 * use_j.sum() + 1, int((~same & use_j).sum())
    np.testing.assert_allclose(pdf_t.numpy()[same], pdf_j[same], rtol=1e-5)
    dirs = d_j[use_j]
    np.testing.assert_allclose(tg._guided_pdf(tgd, _t(p[use_j]), _t(dirs)).numpy(),
                               np.asarray(jg._guided_pdf(jgd, jnp.asarray(p[use_j]),
                                                         jnp.asarray(dirs))), rtol=1e-5)
    # the sampler and the pdf agree with each other (tests/test_guided.py)
    np.testing.assert_allclose(tg._guided_pdf(tgd, _t(p), d_t).numpy()[use_j],
                               pdf_t.numpy()[use_j], rtol=1e-4)
    uv = tg._dir_to_uv(d_t[use_t])
    np.testing.assert_allclose(tg._uv_to_dir(uv).numpy(), d_t[use_t].numpy(), atol=1e-3)


@pytest.mark.parametrize("name", ["cornell", "caustic"])
def test_render_guided_matches_jax(scenes, name):
    js, ts = scenes[name]
    jgd = jg.make_guiding(js, res=6)
    jgd = jg.train_guiding(js, jgd, 1 << 12, 0, jpt.PTConfig(**TRAIN))
    tgd = convert.guiding_from_numpy(convert.flatten(jgd), device="cpu")
    np.testing.assert_array_equal(tgd.hist.numpy(), np.asarray(jgd.hist))
    cfg = dict(max_depth=5, rr_start=99)
    img = tg.render_guided(ts, tgd, 16, 16, 4, 3, tpt.PTConfig(**cfg))
    _close(img, jg.render_guided(js, jgd, 16, 16, 4, 3, jpt.PTConfig(**cfg)), 1e-4)
    assert float(img.mean()) > 0


def _block_gap(a, b, k=4):
    h, w, _ = a.shape
    bm = lambda x: x.reshape(h // k, k, w // k, k, 3).mean((1, 3))  # noqa: E731
    return np.abs(bm(a) - bm(b)).sum() / np.abs(bm(b)).sum()


def test_guided_unbiased_against_path_tracer(scenes):
    """tests/test_guided.py's gates on the port: trained (32x32, 4 x 16
    spp, res 6, two batches of 2^14 photons) within 0.1, empty (24x24, 32
    spp, res 4) within 0.08."""
    _, ts = scenes["cornell"]
    cfg = tpt.PTConfig(max_depth=5, rr_start=99)
    gd = tg.make_guiding(ts, res=6)
    for i in range(2):
        gd = tg.train_guiding(ts, gd, 1 << 14, i, tpt.PTConfig(**TRAIN))
    img_g = sum(tg.render_guided(ts, gd, 32, 32, 16, i, cfg).numpy() for i in range(4)) / 4
    img_p = sum(tpt.render(ts, 32, 32, 16, i + 100, cfg).numpy() for i in range(4)) / 4
    assert np.isfinite(img_g).all()
    assert _block_gap(img_g, img_p) < 0.1

    cfg = tpt.PTConfig(max_depth=4, rr_start=99)
    empty = tg.make_guiding(ts, res=4)
    gap = _block_gap(tg.render_guided(ts, empty, 24, 24, 32, 3, cfg).numpy(),
                     tpt.render(ts, 24, 24, 32, 3, cfg).numpy())
    assert gap < 0.08
