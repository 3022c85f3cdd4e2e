"""Path-tracer parity: the port against the JAX package on the Cornell box,
both computing on identical scene arrays (the port's scene comes from the
JAX scene through `scene_from_numpy`).

Tolerances, stated once:
  * one `surface_bounce` (4096 lanes, fixed seed): masks equal on every
    lane; float outputs within 1e-5 relative + 2e-6 absolute (a few float32
    ulps of the unit-scale directions);
  * per-pixel images: at least 99% of pixels within 1e-3 relative on every
    channel (a path that grazes an edge may take the other side after a
    float32 rounding difference), and the image means within 0.5%;
  * ray counts within 0.1%.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.render import path_tracer as jpt
from cudatracerlib_tpu.sampling.rng import Sampler as JSampler
from cudatracerlib_tpu.scene.shapes import cornell_box as jcornell
from cudatracerlib_tpu_torch.convert import flatten, scene_from_numpy
from cudatracerlib_tpu_torch.render import path_tracer as tpt
from cudatracerlib_tpu_torch.sampling.rng import Sampler as TSampler
from cudatracerlib_tpu_torch.scene import bsdf as tbsdf
from cudatracerlib_tpu_torch.scene.shapes import cornell_box as tcornell


@pytest.fixture(scope="module")
def scenes():
    js = jcornell()
    return js, scene_from_numpy(flatten(js), device="cpu")


def _assert_images_close(port, ref, frac=0.99, rel=1e-3):
    port, ref = port.numpy(), np.asarray(ref)
    assert port.shape == ref.shape and np.isfinite(port).all()
    ok = (np.abs(port - ref) <= rel * np.abs(ref) + 1e-6).all(-1)
    assert ok.mean() >= frac, f"only {ok.mean():.4f} of pixels within {rel}"
    assert abs(port.mean() - ref.mean()) <= 5e-3 * abs(ref.mean())


def test_surface_bounce_one_bounce(scenes):
    js, ts = scenes
    n = 4096
    rng = np.random.default_rng(0)
    o = np.tile(np.array([[0.0, -3.25, 1.0]], np.float32), (n, 1))
    d = np.stack([rng.uniform(-0.3, 0.3, n), np.ones(n), rng.uniform(-0.3, 0.3, n)], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tp = rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32)
    prev_pdf = rng.uniform(0.0, 2.0, n).astype(np.float32)
    prev_delta = rng.random(n) < 0.5
    active = rng.random(n) < 0.9
    pid = np.arange(n, dtype=np.uint32)
    jcfg = jpt.specialize_config(js, jpt.PTConfig(max_depth=5))
    tcfg = tpt.specialize_config(ts, tpt.PTConfig(max_depth=5))
    for depth in (0, 5):
        jo = jpt.surface_bounce(
            js, jcfg, o=jnp.asarray(o), d=jnp.asarray(d), active=jnp.asarray(active),
            throughput=jnp.asarray(tp), prev_pdf=jnp.asarray(prev_pdf),
            prev_delta=jnp.asarray(prev_delta), eta_scale=jnp.ones(n),
            path_len=jnp.zeros(n), sampler=JSampler.create(jnp.uint32(7), jnp.asarray(pid), 0),
            depth=depth)
        to = tpt.surface_bounce(
            ts, tcfg, o=torch.from_numpy(o), d=torch.from_numpy(d),
            active=torch.from_numpy(active), throughput=torch.from_numpy(tp),
            prev_pdf=torch.from_numpy(prev_pdf), prev_delta=torch.from_numpy(prev_delta),
            eta_scale=torch.ones(n), sampler=TSampler.create(7, torch.from_numpy(pid.astype(np.int64)), 0),
            depth=depth)
        for f in ("cont", "delta_now"):
            np.testing.assert_array_equal(getattr(to, f).numpy(), np.asarray(getattr(jo, f)), f)
        c = to.cont.numpy()
        assert 0.3 < c.mean() < 0.95
        for f in ("L_add", "bs_pdf", "eta_scale"):
            np.testing.assert_allclose(getattr(to, f).numpy(), np.asarray(getattr(jo, f)),
                                       rtol=1e-5, atol=2e-6, err_msg=f)
        for f in ("o", "d", "throughput"):
            np.testing.assert_allclose(getattr(to, f).numpy()[c], np.asarray(getattr(jo, f))[c],
                                       rtol=1e-5, atol=2e-6, err_msg=f)
        assert int(to.n_rays) == int(jo.n_rays) and int(to.n_nonfinite) == 0
        np.testing.assert_array_equal(to.sampler.state.numpy().astype(np.uint32),
                                      np.asarray(jo.sampler.state))


def test_render_entry_shape(scenes):
    """The `__graft_entry__.entry()` shape: 64x64, 2 spp, depth 5, seed 0."""
    js, ts = scenes
    ref = jpt.render(js, 64, 64, 2, jnp.uint32(0), jpt.PTConfig(max_depth=5))
    _assert_images_close(tpt.render(ts, 64, 64, 2, 0, tpt.PTConfig(max_depth=5)), ref)


@pytest.mark.slow
def test_render_counted_config1():
    """Bench config 1: 256x256, 16 spp, depth 5, seed 3, on the port's own
    `cornell_box()` (no Russian roulette: depths 0-4 < rr_start 5). Some
    eight minutes on the CPU, so out of tier-1; chip_smoke.py holds the
    card's seed-3 mean to JAX's within 0.5%."""
    js = jcornell()
    ref_img, ref_rays = jpt.render_counted(js, 256, 256, 16, 3, jpt.PTConfig(max_depth=5))
    img, rays = tpt.render_counted(tcornell(device="cpu"), 256, 256, 16, 3, tpt.PTConfig(max_depth=5))
    assert rays.dtype == torch.int64
    assert abs(int(rays) - float(ref_rays)) <= 1e-3 * float(ref_rays)
    assert np.isfinite(img.numpy()).all() and img.shape == (256, 256, 3)
    ref_mean = float(np.asarray(ref_img).mean())
    assert abs(float(img.mean()) - ref_mean) <= 5e-3 * ref_mean


@pytest.mark.parametrize("cfg", [
    dict(max_depth=6, rr_start=2),   # Russian roulette fires from depth 2
    dict(max_depth=3, direct=False),  # no next-event estimation
], ids=["russian_roulette", "no_nee"])
def test_render_counted_variants(scenes, cfg):
    js, ts = scenes
    ref_img, ref_rays = jpt.render_counted(js, 48, 32, 4, 11, jpt.PTConfig(**cfg))
    img, rays = tpt.render_counted(ts, 48, 32, 4, 11, tpt.PTConfig(**cfg))
    _assert_images_close(img, ref_img)
    assert abs(int(rays) - float(ref_rays)) <= 1e-3 * float(ref_rays)


def test_render_progressive(scenes):
    js, ts = scenes
    cfg = dict(max_depth=3)
    ref = jpt.render_progressive(js, 32, 32, 2, 3, 0xFFFFFFFE, jpt.PTConfig(**cfg))
    got = tpt.render_progressive(ts, 32, 32, 2, 3, 0xFFFFFFFE, tpt.PTConfig(**cfg))
    _assert_images_close(got, ref)
    # seeds wrap as uint32: the third pass uses seed 0
    last = tpt.render(ts, 32, 32, 2, 0, tpt.PTConfig(**cfg))
    first_two = sum(tpt.render(ts, 32, 32, 2, s, tpt.PTConfig(**cfg))
                    for s in (0xFFFFFFFE, 0xFFFFFFFF))
    torch.testing.assert_close(got, (first_two + last) / 3, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("cfg", [
    dict(height_maps=True), dict(parallax=True), dict(rec_filter=5), dict(sss=True),
    dict(alpha_test=True), dict(normal_maps=True), dict(media_modes=(0,)),
    dict(bsdf_types=(0, 16)), dict(light_types=(3, 6)), dict(tex_types=(0, 2)),
], ids=lambda c: next(iter(c)))
def test_unported_config_raises(scenes, cfg):
    """Features that are not ported, and tags and filters that do not
    exist, raise instead of rendering black. The config is given already
    specialized, so its flags are not replaced. (Regularization, the
    filters 1-4 and every BSDF and light type are ported:
    tests/test_torch_filter.py and tests/test_torch_bsdf_more.py hold them
    to JAX.)"""
    _, ts = scenes
    spec = dict(tpt.specialize_config(ts, tpt.PTConfig())._asdict(), max_depth=2)
    with pytest.raises(NotImplementedError):
        tpt.render(ts, 8, 8, 1, 0, tpt.PTConfig(**{**spec, **cfg}))


def test_unported_bsdf_types_raise():
    """Every BSDF type is ported, and a scene of any of them renders; a
    scene whose materials use a feature that is not ported (here the
    spheres' glass made THINDIELECTRIC with subsurface scattering) raises
    when its specialization is derived from the arrays."""
    s = tcornell(extra_objects="spheres", device="cpu")
    bt = s.materials.bsdf_type.clone()
    bt[5] = tbsdf.THINDIELECTRIC
    s = s._replace(materials=s.materials._replace(bsdf_type=bt), spec=None)
    img = tpt.render(s, 8, 8, 1, 0, tpt.PTConfig(max_depth=2))
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0
    sss = s.materials.sss.clone()
    sss[5] = 1
    s = s._replace(materials=s.materials._replace(sss=sss))
    with pytest.raises(NotImplementedError):
        tpt.render(s, 8, 8, 1, 0, tpt.PTConfig(max_depth=2))
