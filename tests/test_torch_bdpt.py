"""The bidirectional engines (light tracer, BDPT, VCM) and what they add to
the port (the camera's lens connection, the splat film) against the JAX
package on the CPU, and each engine against the unidirectional path tracer.

Tolerances:
  * `sample_direct` within 1e-6 (relative, plus 1e-6 of the values'
    scale): the same float32 operations, the camera transform summed in
    another order;
  * the splat sum: the plain version's float64 sums rounded to float32
    equal a float64 reference rounded once, bit for bit;
  * engines on the caustic scene at 16x16, 2 spp, seed 3 (one light path a
    sample): every pixel within 1e-3 relative plus 1e-6, the image sums
    within 1e-5 relative (LT 7.2e-7, BDPT 2.0e-6, VCM 4.8e-7 absolute
    measured): float32 rounding in the intersector and the BSDFs; BDPT's
    ray count exactly equal;
  * converged images on the Cornell box (12 passes at 48x48, 8 spp, depth
    4, as tests/test_bdpt.py runs the JAX engines): the 4x4-pixel block
    means of BDPT within 0.12 and of VCM within 0.15 (relative L1) of the
    path tracer's, the JAX package's bounds.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.render import bdpt as jbdpt
from cudatracerlib_tpu.render import light_tracer as jlt
from cudatracerlib_tpu.render import vcm as jvcm
from cudatracerlib_tpu.scene import sensors as jsensors
from cudatracerlib_tpu.scene.shapes import caustic_scene as jcaustic
from cudatracerlib_tpu_torch.image import film as tfilm
from cudatracerlib_tpu_torch.render import bdpt as tbdpt
from cudatracerlib_tpu_torch.render import light_tracer as tlt
from cudatracerlib_tpu_torch.render import path_tracer as tpt
from cudatracerlib_tpu_torch.render import vcm as tvcm
from cudatracerlib_tpu_torch.scene import sensors as tsensors
from cudatracerlib_tpu_torch.scene import shapes as tshapes

W = H = 16
SPP, SEED = 2, 3


@pytest.fixture(scope="module")
def scenes():
    return jcaustic(), tshapes.caustic_scene(device="cpu")


def _close(t, j, rtol=1e-6, err_msg=""):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=rtol,
                               atol=1e-6 * max(float(np.abs(j).max()), 1.0), err_msg=err_msg)


def _assert_images_close(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape == (H, W, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6)
    assert abs(got.sum() - want.sum()) <= 1e-5 * abs(want.sum())
    assert want.mean() > 0.1


@pytest.mark.parametrize("aspect", [1.0, 1.5])
def test_sample_direct_matches_jax(scenes, aspect):
    """Points in front of, beside and behind a camera, inside and outside
    the frustum."""
    js, ts = scenes
    jcam = js.camera._replace(aspect=np.float32(aspect))
    tcam = ts.camera._replace(aspect=torch.tensor(np.float32(aspect)))
    p = np.random.default_rng(4).uniform(-4.0, 4.0, (4096, 3)).astype(np.float32)
    want = jsensors.sample_direct(jcam, p)
    got = tsensors.sample_direct(tcam, torch.from_numpy(p))
    for name, g, w in zip(("uv", "d", "dist", "importance"), got[:4], want[:4]):
        _close(g, w, err_msg=name)
    # the frustum test on the port's own uv (an ulp may move a border point)
    uv, inside = got[0], got[4]
    np.testing.assert_array_equal(inside.numpy(), np.asarray(want[4]))
    assert 0 < int(inside.sum()) < 4096
    assert bool(((uv >= 0) & (uv < 1)).all(-1)[inside].all())


def test_camera_pdf_matches_jax(scenes):
    js, ts = scenes
    d = np.random.default_rng(5).normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _close(tbdpt._camera_pdf_w(ts.camera, torch.from_numpy(d), 48),
           jbdpt._camera_pdf_w(js.camera, d, 48))


@pytest.mark.parametrize("n,n_px", [(0, 7), (1, 1), (5000, 64), (40_000, 4096)])
def test_splat_sum_matches_float64(n, n_px):
    """Splats summed by pixel on the CPU (the plain version of the card's
    segment-sum kernel): every pixel equals the float64 sum rounded once;
    a pixel no splat reaches is 0."""
    rng = np.random.default_rng(n)
    pix = rng.integers(0, n_px, n)
    val = rng.normal(size=(n, 3)).astype(np.float32)
    ref = np.zeros((n_px, 3))
    np.add.at(ref, pix, val.astype(np.float64))
    got = tfilm.splat_sum(torch.from_numpy(pix), torch.from_numpy(val), n_px)
    assert got.dtype == torch.float32 and got.shape == (n_px, 3)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.float32))
    assert (got.numpy()[np.bincount(pix, minlength=n_px) == 0] == 0).all()


def test_light_trace_matches_jax(scenes):
    js, ts = scenes
    want = jlt.render_light_trace(js, W, H, W * H * SPP, SEED)
    got = tlt.render_light_trace(ts, W, H, W * H * SPP, SEED)
    _assert_images_close(got, want)


def test_bdpt_matches_jax(scenes):
    js, ts = scenes
    want, want_rays = jbdpt.render_bdpt_counted(js, W, H, SPP, SEED)
    got, rays = tbdpt.render_bdpt_counted(ts, W, H, SPP, SEED)
    assert rays.dtype == torch.int64 and int(rays) == int(want_rays) > 10_000
    _assert_images_close(got, want)
    assert torch.equal(tbdpt.render_bdpt(ts, W, H, SPP, SEED), got)


def test_vcm_matches_jax(scenes):
    js, ts = scenes
    want = jvcm.render_vcm(js, W, H, SPP, SEED, 1)
    got = tvcm.render_vcm(ts, W, H, SPP, SEED, 1)
    _assert_images_close(got, want)


def test_unported_emitters_raise():
    """Every light type's emitted rays are ported (the point-lit Cornell box
    and the constant-environment furnace are held to JAX in
    tests/test_torch_camera_lights.py), and so are the material features
    the bidirectional engines used to refuse: on the furnace with a
    subsurface material or a normal map, the light tracer, BDPT and VCM
    render as JAX's do, which evaluate neither the maps nor the walk."""
    from cudatracerlib_tpu.scene.shapes import furnace_scene as jfurnace

    for kw in (dict(sss=1), dict(tex_normal=1)):
        scene = tshapes.furnace_scene(device="cpu", **kw)
        jscene = jfurnace(**kw)
        for label, got, want in (
                ("lt", lambda: tlt.render_light_trace(scene, 4, 4, 1024, 0),  # noqa: B023
                 lambda: jlt.render_light_trace(jscene, 4, 4, 1024, 0)),  # noqa: B023
                ("bdpt", lambda: tbdpt.render_bdpt(scene, 4, 4, 1, 0),  # noqa: B023
                 lambda: jbdpt.render_bdpt(jscene, 4, 4, 1, 0)),  # noqa: B023
                ("vcm", lambda: tvcm.render_vcm(scene, 4, 4, 1, 0),  # noqa: B023
                 lambda: jvcm.render_vcm(jscene, 4, 4, 1, 0))):  # noqa: B023
            g, w = got().numpy(), np.asarray(want())
            assert g.shape == w.shape == (4, 4, 3) and np.isfinite(g).all(), (kw, label)
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-6, err_msg=f"{kw} {label}")
            assert w.mean() > 0, (kw, label)


def _avg(fn, n, seed0):
    return sum(fn(s + seed0).numpy().astype(np.float64) for s in range(n)) / n


def _blocks(img):
    return img.reshape(12, 4, 12, 4, 3).mean((1, 3))


@pytest.fixture(scope="module")
def cornell_pt():
    scene = tshapes.cornell_box(device="cpu")
    cfg = tpt.PTConfig(max_depth=4, rr_start=99)
    with torch.no_grad():
        ref = _avg(lambda s: tpt.render(scene, 48, 48, 8, s, cfg), 12, 0)
    return scene, cfg, _blocks(ref)


def test_bdpt_converges_to_pt(cornell_pt):
    scene, cfg, a = cornell_pt
    b = _blocks(_avg(lambda s: tbdpt.render_bdpt(scene, 48, 48, 8, s,
                                                 tbdpt.BDPTConfig(base=cfg)), 12, 500))
    rel = np.abs(a - b).sum() / np.abs(a).sum()
    assert rel < 0.12, f"BDPT vs PT disagree: rel={rel}"


def test_vcm_converges_to_pt(cornell_pt):
    scene, cfg, a = cornell_pt
    b = _blocks(_avg(lambda s: tvcm.render_vcm(scene, 48, 48, 8, s, s,
                                               tvcm.VCMConfig(base=cfg)), 12, 900))
    rel = np.abs(a - b).sum() / np.abs(a).sum()
    assert rel < 0.15, f"VCM vs PT disagree: rel={rel}"
