"""The subsurface random walk: the port's `_sss_walk` against the JAX
package's lane for lane, tests/test_sss.py's Marble sphere rendered by both,
the gradient with respect to `sss_sigma_s` against `jax.grad`, and
`convert.with_grad` over the atlas and the sigmas together.

Tolerances:
  * the walk: the exit and continue masks and the samplers' states equal on
    every lane, exit points, directions and weights within 1e-5 relative
    plus 1e-5 (a lane's weight is a product over up to 8 events);
  * renders: every pixel within 1e-3 relative plus 1e-6 (the walk's
    decisions compare uniform numbers with Fresnel terms and distances with
    hits, and an ulp could flip one; none did), rays exactly equal;
  * gradients: within 1e-3 relative of the largest entry plus 1e-6 (the
    float32 sums of many lanes run in another order).
"""
import os
import sys

import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.render import path_tracer as jpt
from cudatracerlib_tpu.sampling.rng import Sampler as JSampler
from cudatracerlib_tpu.scene import material_lib as jmlib
from cudatracerlib_tpu_torch.convert import flatten, grads, scene_from_numpy, with_grad
from cudatracerlib_tpu_torch.render import path_tracer as tpt
from cudatracerlib_tpu_torch.sampling.rng import Sampler as TSampler
from cudatracerlib_tpu_torch.scene import material_lib as tmlib
from cudatracerlib_tpu_torch.scene import scene as tsc
from test_sss import _sss_scene

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import texture_cases  # noqa: E402

CFG = dict(max_depth=4, rr_start=99, sss_steps=8)


@pytest.fixture(scope="module")
def scenes():
    js = _sss_scene(jmlib.sss_record("Marble", scale=3.0))
    return js, scene_from_numpy(flatten(js), device="cpu")


def test_material_lib_and_case_equal(scenes):
    """The port's material_lib is the JAX package's, and the SSS case of
    tools/texture_cases.py (which chip_smoke.py renders) is
    tests/test_sss.py's scene, array for array."""
    assert tmlib.MEDIA == jmlib.MEDIA and tmlib.CONDUCTORS == jmlib.CONDUCTORS
    rec_t, rec_j = tmlib.sss_record("Skin1", 2.0, 0.3), jmlib.sss_record("Skin1", 2.0, 0.3)
    assert rec_t.keys() == rec_j.keys()
    for k in rec_t:
        np.testing.assert_array_equal(rec_t[k], rec_j[k], err_msg=k)
    js, _ = scenes
    ts = texture_cases.build(texture_cases.sss_case(tmlib.sss_record), tsc.build_scene,
                             tsc.Materials, tsc.Textures, tsc.Camera, device="cpu")
    a, b = flatten(js), flatten(ts)
    assert set(a) == set(b)
    for k in a:
        bits = lambda x: x.view(np.int32) if x.dtype == np.float32 else x  # noqa: E731
        np.testing.assert_array_equal(bits(a[k]), bits(b[k]), err_msg=k)
    spec = tpt.specialize_config(ts, tpt.PTConfig())
    assert spec.sss and spec.bsdf_types == (0, 2)


def test_walk_lanes(scenes):
    """One walk of 8 steps from the sphere's first hits (camera rays of a
    32x32 frame going on straight inside), lane by lane."""
    js, ts = scenes
    o, d, _, _ = tpt.camera_rays(ts, 32, 32, 1, 5)
    hit = tsc.scene_intersect(ts, o, d)
    it = tsc.make_interaction(ts, o, d, hit)
    entered = hit.valid & (it.mat_id == 0)
    assert entered.float().mean() > 0.2
    n_entry = it.n_geo * torch.sign((it.n_geo * -d).sum(-1, keepdim=True))
    pid = np.arange(o.shape[0], dtype=np.uint32)
    cfg = tpt.specialize_config(ts, tpt.PTConfig(**CFG))
    got = tpt._sss_walk(ts, cfg, entered=entered, p0=it.p, d0=d, n_entry=n_entry,
                        mat_id=it.mat_id, sampler=TSampler.create(9, torch.from_numpy(
                            pid.astype(np.int64)), 0))
    j = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    want = jpt._sss_walk(js, jpt.PTConfig(**cfg._asdict()), entered=j(entered), p0=j(it.p),
                         d0=j(d), n_entry=j(n_entry), mat_id=j(it.mat_id),
                         sampler=JSampler.create(jnp.uint32(9), jnp.asarray(pid), 0))
    exited = got[0].numpy()
    np.testing.assert_array_equal(exited, np.asarray(want[0]))
    assert 0.1 < exited[entered.numpy()].mean() < 1.0
    for k, name in ((1, "exit_o"), (2, "exit_d"), (3, "weight")):
        np.testing.assert_allclose(got[k].numpy()[exited], np.asarray(want[k])[exited],
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got[4].state.numpy().astype(np.uint32),
                                  np.asarray(want[4].state))
    assert int(got[5]) == int(want[5]) > 0


def test_render(scenes):
    """The Marble sphere at 16x16, 4 spp, depth 4, 8 walk steps, seed 3:
    rays equal, every pixel, and light bleeding through the sphere."""
    js, ts = scenes
    want, want_rays = jpt.render_counted(js, 16, 16, 4, jnp.uint32(3), jpt.PTConfig(**CFG))
    got, rays = tpt.render_counted(ts, 16, 16, 4, 3, tpt.PTConfig(**CFG))
    assert int(rays) == int(want_rays)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-6)
    assert float(got[5:11, 5:11].mean()) > 0


def _assert_grad_close(got, want, name):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0 and np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * scale + 1e-6, err_msg=name)


def test_sigma_s_gradient(scenes):
    """d mean(render) / d sss_sigma_s at 8x8, 4 spp, seed 5, against
    jax.grad (the pdf detached, the weights attached, as JAX does)."""
    js, ts = scenes

    def jloss(sig):
        sc = js._replace(materials=js.materials._replace(sss_sigma_s=sig))
        return jpt.render(sc, 8, 8, 4, jnp.uint32(5), jpt.PTConfig(**CFG)).mean()

    want = jax.grad(jloss)(js.materials.sss_sigma_s)
    tg = with_grad(ts, ["materials.sss_sigma_s"])
    tpt.render(tg, 8, 8, 4, 5, tpt.PTConfig(**CFG)).mean().backward()
    _assert_grad_close(grads(tg)["materials.sss_sigma_s"], want, "sss_sigma_s")


def test_with_grad_atlas_and_sigmas():
    """`convert.with_grad(scene, ["textures.atlas", "materials.sss_sigma_s"])`
    on the Marble sphere over a floor textured by a seeded IMAGE (two atlas
    layers, the floor on the second): both gradients against jax.grad, the
    atlas round-tripped through `flatten` / `scene_from_numpy`."""
    from cudatracerlib_tpu.scene.textures import Textures as JTextures

    js = _sss_scene(jmlib.sss_record("Marble", scale=3.0))
    rng = np.random.default_rng(8)
    images = [rng.uniform(0, 1, (8, 8, 3)), rng.uniform(0.02, 0.3, (32, 32, 3))]
    js = js._replace(textures=JTextures.build([
        {"type": 0, "color_a": [1.0, 1.0, 1.0]},
        {"type": 2, "image_id": 1, "uv_xform": [4, 4, 0, 0]},
        {"type": 0, "color_a": [0, 0, 0]}], images=images))
    arrays = flatten(js)
    ts = scene_from_numpy(arrays, device="cpu")
    np.testing.assert_array_equal(flatten(ts)["textures.atlas"], arrays["textures.atlas"])
    assert ts.textures.atlas.shape == (2, 87381, 3)
    cfg = tpt.specialize_config(ts, tpt.PTConfig(**CFG))
    assert cfg.tex_types == (0, 2) and cfg.sss

    def jloss(atlas, sig):
        sc = js._replace(textures=js.textures._replace(atlas=atlas),
                         materials=js.materials._replace(sss_sigma_s=sig))
        return jpt.render(sc, 8, 8, 4, jnp.uint32(5), jpt.PTConfig(**cfg._asdict())).mean()

    want = jax.grad(jloss, argnums=(0, 1))(js.textures.atlas, js.materials.sss_sigma_s)
    paths = ["textures.atlas", "materials.sss_sigma_s"]
    tg = with_grad(ts, paths)
    tpt.render(tg, 8, 8, 4, 5, cfg).mean().backward()
    got = grads(tg, paths)
    for path, w in zip(paths, want):
        _assert_grad_close(got[path], w, path)
    assert np.abs(got["textures.atlas"][0]).max() == 0   # the first layer is unused
