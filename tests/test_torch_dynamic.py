"""DynamicScene (scene/dynamic.py) against the JAX package on the CPU: the
flattened `update()` and a JAX instanced Scene carried across by `convert`.

Tolerances, stated once:
  * the flattened scene's arrays (Woop rows, nodes, shading, materials,
    textures, lights, light CDF) within 1e-6 of JAX's; the specialization
    equal to the one JAX derives;
  * renders (32x32, 4 spp, depth 3): every pixel within 1e-4 of JAX's.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.render import path_tracer as jpt
from cudatracerlib_tpu.scene import dynamic as jdyn
from cudatracerlib_tpu.scene import shapes as jshapes
from cudatracerlib_tpu.scene.sensors import Camera as JCamera
from cudatracerlib_tpu_torch.convert import flatten, scene_from_numpy
from cudatracerlib_tpu_torch.render import path_tracer as tpt
from cudatracerlib_tpu_torch.scene import bsdf as TB
from cudatracerlib_tpu_torch.scene import dynamic as tdyn
from cudatracerlib_tpu_torch.scene import shapes as tshapes
from cudatracerlib_tpu_torch.scene.sensors import Camera as TCamera

CFG = dict(max_depth=3)


def _populate(ds, sh, Camera, ball_normals=False):
    """A scene exercising the creation API: two meshes (the ball with its
    own vertex normals if `ball_normals`), four nodes (one removed, one
    moved), an emissive quad, a point light, a checker texture and an
    environment map. JAX's flattened update cannot take mesh normals: it
    renormalizes them with `np.linalg.norm(n, -1, ...)`, ord -1 on a 3-D
    array, which raises; the port's takes axis -1."""
    rng = np.random.default_rng(7)
    ball = sh.sphere([0.0, 0.0, 0.0], 0.5, 6, 12)
    n_ball = ball / np.linalg.norm(ball, axis=-1, keepdims=True)
    m_ball = ds.create_mesh(ball, normals=n_ball.astype(np.float32) if ball_normals else None)
    m_box = ds.create_mesh(sh.box([-0.4, -0.4, 0.0], [0.4, 0.4, 0.8]))
    floor = ds.create_mesh(sh.quad([-3, -3, 0], [3, -3, 0], [3, 3, 0], [-3, 3, 0]))
    lightq = ds.create_mesh(sh.quad([-0.5, -0.5, 2.8], [-0.5, 0.5, 2.8], [0.5, 0.5, 2.8],
                                    [0.5, -0.5, 2.8]))
    tex = ds.add_texture({"type": 1, "color_a": [0.8, 0.2, 0.2], "color_b": [0.2, 0.2, 0.8],
                          "uv_xform": [8, 8, 0, 0]})
    m = np.eye(4)
    m[:3, 3] = [0.8, 0.3, 0.5]
    ds.create_node(m_ball, m, {"bsdf_type": TB.ROUGHCONDUCTOR, "alpha_u": 0.2, "alpha_v": 0.2})
    gone = ds.create_node(m_box, np.eye(4))
    moved = ds.create_node(m_box, np.eye(4), {"bsdf_type": TB.DIFFUSE, "tex_albedo": tex})
    m2 = np.eye(4)
    m2[:3, :3] *= 0.6
    m2[:3, 3] = [-0.9, -0.2, 0.0]
    ds.set_node_transform(moved, m2)
    ds.remove_node(gone)
    ds.create_node(floor, np.eye(4), {"bsdf_type": TB.DIFFUSE, "tex_albedo": tex})
    ln = ds.create_node(lightq, np.eye(4))
    ds.make_node_emissive(ln, [9.0, 8.0, 7.0])
    ds.create_light({"type": 0, "position": [1.5, -1.5, 2.0], "radiance": [3.0, 3.0, 3.0]})
    ds.set_environment_map(rng.uniform(0.05, 0.3, (8, 16, 3)).astype(np.float32),
                           radiance=(0.5, 0.5, 0.5))
    ds.set_camera(Camera.look_at([0, -4.5, 2.0], [0, 0, 0.4], up=[0, 0, 1], fov_deg=45.0))
    return ds


@pytest.fixture(scope="module")
def flat():
    js = _populate(jdyn.DynamicScene(), jshapes, JCamera).update()
    ts = _populate(tdyn.DynamicScene(device="cpu"), tshapes, TCamera).update()
    return js, ts


def test_flattened_update_matches_jax(flat):
    js, ts = flat
    a, b = flatten(js), flatten(ts)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(b[k], np.asarray(a[k]), rtol=0, atol=1e-6, err_msg=k)
    assert int(ts.bvh.woop.shape[0]) > 150 and ts.n_lights == 3
    spec = tpt.specialize_config(ts, tpt.PTConfig())
    jspec = jpt.specialize_config(js, jpt.PTConfig())
    for f in ("bsdf_types", "light_types", "tex_types", "flat_shading"):
        assert getattr(spec, f) == getattr(jspec, f), f


def test_flattened_update_renders_as_jax(flat):
    js, ts = flat
    ref = np.asarray(jpt.render(js, 32, 32, 4, jnp.uint32(2), jpt.PTConfig(**CFG)))
    img = tpt.render(ts, 32, 32, 4, 2, tpt.PTConfig(**CFG)).numpy()
    assert np.isfinite(img).all() and img.mean() > 0.02
    np.testing.assert_allclose(img, ref, rtol=0, atol=1e-4)


def test_update_caches_until_changed():
    ds = _populate(tdyn.DynamicScene(device="cpu"), tshapes, TCamera, True)
    s1 = ds.update()
    assert ds.update() is s1
    inst = ds.update(instancing=True)
    assert inst.instances and not ds.update().instances   # a flattened scene again
    with pytest.raises(ValueError):
        tdyn.DynamicScene(device="cpu").update()


def test_converted_jax_instanced_scene_renders_as_jax():
    js = _populate(jdyn.DynamicScene(), jshapes, JCamera, True).update(instancing=True)
    ts = scene_from_numpy(flatten(js), device="cpu")
    assert len(ts.blas) == len(ts.instances) == 4
    assert not any(k.startswith("blas.") and ".clusters." in k for k in flatten(ts))
    ref = np.asarray(jpt.render(js, 32, 32, 4, jnp.uint32(2), jpt.PTConfig(**CFG)))
    img = tpt.render(ts, 32, 32, 4, 2, tpt.PTConfig(**CFG)).numpy()
    np.testing.assert_allclose(img, ref, rtol=0, atol=1e-4)
    # the port's own instanced update builds the same scene
    own = _populate(tdyn.DynamicScene(device="cpu"), tshapes, TCamera, True).update(
        instancing=True)
    for k, v in flatten(ts).items():
        np.testing.assert_allclose(flatten(own)[k], v, rtol=0, atol=1e-6, err_msg=k)
    assert own.spec == ts.spec
