"""Scene parity: the port's `cornell_box()` against the JAX package's, array
by array (exactly equal), the `scene_from_numpy` round trip, camera rays
lane by lane (within 1e-6) and first hits (prim ids equal on every lane)."""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.render import path_tracer as jpt
from cudatracerlib_tpu.sampling.rng import Sampler as JSampler
from cudatracerlib_tpu.scene import scene as jscene_mod
from cudatracerlib_tpu.scene import sensors as jsensors
from cudatracerlib_tpu.scene import bsdf as jbsdf
from cudatracerlib_tpu.scene.shapes import cornell_box as jcornell
from cudatracerlib_tpu.scene.shapes import furnace_scene as jfurnace
from cudatracerlib_tpu_torch.convert import flatten, scene_from_numpy
from cudatracerlib_tpu_torch.render import path_tracer as tpt
from cudatracerlib_tpu_torch.scene import scene as tscene_mod
from cudatracerlib_tpu_torch.scene import sensors as tsensors
from cudatracerlib_tpu_torch.scene.shapes import cornell_box as tcornell
from cudatracerlib_tpu_torch.scene.shapes import furnace_scene as tfurnace


@pytest.fixture(scope="module")
def scenes():
    return jcornell(), tcornell(device="cpu")


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _camera_rays(width, height, spp, seed, jscene, tscene):
    """Both packages' render prologue: block-ordered pixel ids, sampler,
    jitter, aperture draw, camera rays (the JAX side spelled out from
    `_render_body`, the port's through `camera_rays`)."""
    perm = jpt.block_order_pixels_np(width, height)
    pid = np.tile(perm, spp)
    sidx = np.repeat(np.arange(spp, dtype=np.uint32), width * height)
    js = JSampler.create(jnp.uint32(seed), jnp.asarray(pid), jnp.asarray(sidx))
    js, jit = js.next_2d()
    px, py = (pid % width).astype(np.float32), (pid // width).astype(np.float32)
    juv = jnp.stack([(px + jit[:, 0]) / width, (py + jit[:, 1]) / height], -1)
    js, jap = js.next_2d()
    jo, jd, _ = jsensors.sample_ray(jscene.camera, juv, jap)

    to, td, _, ts = tpt.camera_rays(tscene, width, height, spp, seed)
    return (jo, jd, js), (to, td, ts)


def test_cornell_arrays_exactly_equal(scenes):
    js, ts = scenes
    a, b = flatten(js), flatten(ts)
    assert set(a) == set(b)
    for k in sorted(a):
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]), err_msg=k)
    assert ts.bvh.woop.shape == (60, 12) and ts.bvh.nodes.shape == (14, 16)


@pytest.mark.parametrize("kw", [dict(), dict(albedo=0.8, bsdf_type=jbsdf.ROUGHCONDUCTOR,
                                             alpha_u=0.3, alpha_v=0.3)],
                         ids=["diffuse", "roughconductor"])
def test_furnace_arrays_exactly_equal(kw):
    """`furnace_scene` (a sphere in a CONSTANT_ENV light) array by array, and
    its specialization."""
    js, ts = jfurnace(**kw), tfurnace(device="cpu", **kw)
    a, b = flatten(js), flatten(ts)
    assert set(a) == set(b)
    for k in sorted(a):
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]), err_msg=k)
    spec = tpt.specialize_config(ts, tpt.PTConfig())
    jspec = jpt.specialize_config(js, jpt.PTConfig())
    assert spec.light_types == jspec.light_types == (5,)
    assert spec.bsdf_types == jspec.bsdf_types


def test_specialization_matches(scenes):
    js, ts = scenes
    want = jpt.specialize_config(js, jpt.PTConfig(max_depth=5))
    got = tpt.specialize_config(ts, tpt.PTConfig(max_depth=5))
    for f in tpt.PTConfig._fields:
        assert getattr(got, f) == getattr(want, f), f
    assert got.flat_shading and got.bsdf_types == (0,) and got.light_types == (3,)


def test_scene_from_numpy_roundtrip(scenes):
    js, ts = scenes
    arrays = flatten(js)
    conv = scene_from_numpy(arrays, device="cpu")
    back = flatten(conv)
    assert set(back) == set(arrays)
    for k in arrays:
        np.testing.assert_array_equal(_bits(back[k]), _bits(arrays[k]), err_msg=k)
    # a converted scene has no build-time specialization; it is derived from the arrays
    assert conv.spec is None
    assert tpt.specialize_config(conv, tpt.PTConfig()) == tpt.specialize_config(ts, tpt.PTConfig())


def test_camera_rays_lane_by_lane(scenes):
    js, ts = scenes
    (jo, jd, jsmp), (to, td, tsmp) = _camera_rays(64, 48, 2, 5, js, ts)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tsmp.state.numpy().astype(np.uint32), np.asarray(jsmp.state))


def test_pixel_spread(scenes):
    js, ts = scenes
    for a, b in zip(tsensors.pixel_spread(ts.camera, 256, 256),
                    jsensors.pixel_spread(js.camera, 256, 256)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7)


@pytest.mark.parametrize("flat", [True, False])
def test_first_hits_and_interaction(scenes, flat):
    js, ts = scenes
    (jo, jd, _), (to, td, _) = _camera_rays(64, 64, 1, 0, js, ts)
    jhit = jscene_mod.scene_intersect(js, jo, jd)
    thit = tscene_mod.scene_intersect(ts, to, td)
    np.testing.assert_array_equal(thit.valid.numpy(), np.asarray(jhit.valid))
    np.testing.assert_array_equal(thit.prim.numpy(), np.asarray(jhit.prim))
    v = thit.valid.numpy()
    assert v.mean() > 0.7  # the box is open toward the camera
    np.testing.assert_allclose(thit.t.numpy()[v], np.asarray(jhit.t)[v], rtol=1e-6)
    np.testing.assert_allclose(thit.bary.numpy()[v], np.asarray(jhit.bary)[v], atol=1e-5)
    jit = jscene_mod.make_interaction(js, jo, jd, jhit, flat=flat)
    tit = tscene_mod.make_interaction(ts, to, td, thit, flat=flat)
    # missed lanes carry no surface: compare the hit lanes (float32 rounding)
    for name in ("p", "n_geo", "uv"):
        np.testing.assert_allclose(getattr(tit, name).numpy()[v],
                                   np.asarray(getattr(jit, name))[v],
                                   rtol=1e-6, atol=2e-5, err_msg=name)
    for a, b in zip(tit.frame, jit.frame):
        np.testing.assert_allclose(a.numpy()[v], np.asarray(b)[v], rtol=1e-6, atol=2e-5)
    np.testing.assert_array_equal(tit.mat_id.numpy(), np.asarray(jit.mat_id))
    jmp = jscene_mod.gather_mat_params(js, jit, (0,))
    tmp = tscene_mod.gather_mat_params(ts, tit, (0,))
    for f in tmp._fields:
        np.testing.assert_array_equal(getattr(tmp, f).numpy(), np.asarray(getattr(jmp, f)),
                                      err_msg=f)


def test_occlusion_queries(scenes):
    js, ts = scenes
    rng = np.random.default_rng(9)
    o = rng.uniform([-0.9, 0.1, 0.1], [0.9, 1.9, 1.9], (4096, 3)).astype(np.float32)
    p = rng.uniform([-0.25, 0.75, 1.99], [0.25, 1.25, 1.99], (4096, 3)).astype(np.float32)
    dvec = p - o
    dist = np.linalg.norm(dvec, axis=-1).astype(np.float32)
    d = (dvec / dist[:, None]).astype(np.float32)
    jb = jscene_mod.scene_occluded(js, jnp.asarray(o), jnp.asarray(d), 1e-3,
                                   jnp.asarray(dist - 2e-3))
    tb = tscene_mod.scene_occluded(ts, torch.from_numpy(o), torch.from_numpy(d), 1e-3,
                                   torch.from_numpy(dist - 2e-3))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert 0.05 < tb.numpy().mean() < 0.95
