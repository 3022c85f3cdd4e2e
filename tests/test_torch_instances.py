"""Instanced scenes (scene/instances.py, the instanced paths of scene.py and
path_tracer._sss_walk) against the JAX package on the CPU, on the scenes of
tests/test_instances.py, each built by both packages' DynamicScene.

Tolerances, stated once:
  * intersect_instances on 4,096 camera rays: packed prims equal, t within
    1e-5; any-hit valid equal; the 300-instance forest on 64 rays: prims
    equal, t within 1e-5, valid equal;
  * a 48x48, 8-spp render (depth 3) of the instanced scene: every pixel
    within 1e-4 of JAX's instanced render;
  * the subsurface walk on an instanced Marble cube: rays equal, the image
    mean within 1e-5 relative.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.render import path_tracer as jpt
from cudatracerlib_tpu.sampling.rng import Sampler as JSampler
from cudatracerlib_tpu.scene import dynamic as jdyn
from cudatracerlib_tpu.scene import material_lib as jmlib
from cudatracerlib_tpu.scene import scene as jscene
from cudatracerlib_tpu.scene import sensors as jsensors
from cudatracerlib_tpu.scene import shapes as jshapes
from cudatracerlib_tpu_torch import _tree
from cudatracerlib_tpu_torch.convert import flatten, scene_from_numpy
from cudatracerlib_tpu_torch.render import path_tracer as tpt
from cudatracerlib_tpu_torch.scene import bsdf as TB
from cudatracerlib_tpu_torch.scene import dynamic as tdyn
from cudatracerlib_tpu_torch.scene import instances as tinst
from cudatracerlib_tpu_torch.scene import material_lib as tmlib
from cudatracerlib_tpu_torch.scene import scene as tscene
from cudatracerlib_tpu_torch.scene import sensors as tsensors
from cudatracerlib_tpu_torch.scene import shade_pack
from cudatracerlib_tpu_torch.scene import shapes as tshapes

JAX = dict(ds=lambda: jdyn.DynamicScene(), shapes=jshapes, camera=jsensors.Camera)
PORT = dict(ds=lambda: tdyn.DynamicScene(device="cpu"), shapes=tshapes, camera=tsensors.Camera)
DIFFUSE = {"bsdf_type": TB.DIFFUSE, "tex_albedo": 0}


def _translate(x, y, z, s=1.0):
    m = np.eye(4)
    m[:3, :3] *= s
    m[:3, 3] = [x, y, z]
    return m


def _rot_z(deg):
    a = np.radians(deg)
    m = np.eye(4)
    m[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    return m


def build(pkg, n=4, instancing=False, cube_record=None):
    """tests/test_instances.py `_build`: n rotated, scaled cubes on a floor
    under an emissive quad (optionally another material for the cubes)."""
    ds, sh = pkg["ds"](), pkg["shapes"]
    cube = ds.create_mesh(sh.box([-0.3, -0.3, 0.0], [0.3, 0.3, 0.6]))
    floor = ds.create_mesh(sh.quad([-4, -4, 0], [4, -4, 0], [4, 4, 0], [-4, 4, 0]))
    lightq = ds.create_mesh(sh.quad([-0.6, -0.6, 3.2], [-0.6, 0.6, 3.2], [0.6, 0.6, 3.2],
                                    [0.6, -0.6, 3.2]))
    nodes = [ds.create_node(cube, _rot_z(360.0 * i / n) @ _translate(1.2, 0.0, 0.0,
                                                                       s=0.7 + 0.15 * i),
                            cube_record or DIFFUSE) for i in range(n)]
    ds.create_node(floor, np.eye(4), DIFFUSE)
    ln = ds.create_node(lightq, np.eye(4), DIFFUSE)
    ds.make_node_emissive(ln, [14.0, 13.0, 12.0])
    ds.set_camera(pkg["camera"].look_at([0, -5.5, 3.0], [0, 0, 0.4], up=[0, 0, 1],
                                        fov_deg=45.0))
    return ds, nodes, ds.update(instancing=instancing)


def forest(pkg, n=300):
    """tests/test_instances.py's 300-instance forest: one cube mesh, seeded
    placements and scales, a floor."""
    ds, sh = pkg["ds"](), pkg["shapes"]
    cube = ds.create_mesh(sh.box([-0.1, -0.1, 0.0], [0.1, 0.1, 0.3]))
    rng = np.random.default_rng(3)
    for _ in range(n):
        x, y = rng.uniform(-3, 3, 2)
        ds.create_node(cube, _translate(x, y, 0.0, s=0.5 + rng.uniform(0, 1)), DIFFUSE)
    floor = ds.create_mesh(sh.quad([-4, -4, 0], [4, -4, 0], [4, 4, 0], [-4, 4, 0]))
    ds.create_node(floor, np.eye(4), DIFFUSE)
    ds.set_camera(pkg["camera"].look_at([0, -6, 4.0], [0, 0, 0.2], up=[0, 0, 1], fov_deg=50.0))
    return ds, rng


@pytest.fixture(scope="module")
def scenes():
    return build(JAX, 4, True)[2], build(PORT, 4, True)[2]


def _camera_rays(js, n=4096):
    pid = jnp.arange(n, dtype=jnp.uint32)
    s, u = JSampler.create(jnp.uint32(0), pid, pid * 0).next_2d()
    o, d, _ = jsensors.sample_ray(js.camera, u, u)
    return o, d, torch.from_numpy(np.asarray(o)), torch.from_numpy(np.asarray(d))


def test_scene_arrays_match_jax(scenes):
    js, ts = scenes
    a, b = flatten(js), flatten(ts)
    assert set(a) == set(b) and any(k.startswith("instances.2.") for k in b)
    for k in a:
        np.testing.assert_allclose(b[k], np.asarray(a[k]), rtol=0, atol=1e-6, err_msg=k)
    assert not shade_pack.pack_enabled(ts)


def test_intersect_instances_match_jax(scenes):
    js, ts = scenes
    jo, jd, o, d = _camera_rays(js)
    hj, ht = jscene.scene_intersect(js, jo, jd), tscene.scene_intersect(ts, o, d)
    np.testing.assert_array_equal(ht.prim.numpy(), np.asarray(hj.prim))
    v = ht.valid.numpy()
    assert v.mean() > 0.5 and (ht.prim.numpy()[v] >= tinst.instance_tpad(ts.blas)).any()
    np.testing.assert_allclose(ht.t.numpy()[v], np.asarray(hj.t)[v], rtol=0, atol=1e-5)
    aj = jscene.scene_intersect(js, jo, jd, any_hit=True)
    at = tscene.scene_intersect(ts, o, d, any_hit=True)
    np.testing.assert_array_equal(at.valid.numpy(), np.asarray(aj.valid))


def test_many_instances_match_jax():
    (jds, rng), (tds, _) = forest(JAX), forest(PORT)
    js, ts = jds.update(instancing=True), tds.update(instancing=True)
    assert sum(g.to_object.shape[0] for g in ts.instances) == 301
    o = np.stack([rng.uniform(-3, 3, 64), np.full(64, -6.0), np.full(64, 4.0)], -1)
    o = o.astype(np.float32)
    d = np.tile([0.0, 0.8, -0.6], (64, 1)).astype(np.float32)
    hj = jscene.scene_intersect(js, jnp.asarray(o), jnp.asarray(d))
    ht = tscene.scene_intersect(ts, torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_array_equal(ht.valid.numpy(), np.asarray(hj.valid))
    np.testing.assert_array_equal(ht.prim.numpy(), np.asarray(hj.prim))
    np.testing.assert_allclose(ht.t.numpy(), np.asarray(hj.t), rtol=0, atol=1e-5)
    # the flattened scene agrees (tests/test_instances.py's own gate)
    hf = tscene.scene_intersect(tds.update(instancing=False), torch.from_numpy(o),
                                torch.from_numpy(d))
    assert not tds._scene.instances
    np.testing.assert_allclose(ht.t.numpy(), hf.t.numpy(), rtol=1e-4, atol=1e-4)


def test_render_matches_jax():
    js, ts = build(JAX, 3, True)[2], build(PORT, 3, True)[2]
    ref = np.asarray(jpt.render(js, 48, 48, 8, jnp.uint32(1), jpt.PTConfig(max_depth=3)))
    img = tpt.render(ts, 48, 48, 8, 1, tpt.PTConfig(max_depth=3)).numpy()
    assert np.isfinite(img).all() and img.mean() > 0.05
    np.testing.assert_allclose(img, ref, rtol=0, atol=1e-4)
    # a JAX instanced scene carried across by convert renders the same
    conv = tpt.render(scene_from_numpy(flatten(js), device="cpu"), 48, 48, 8, 1,
                      tpt.PTConfig(max_depth=3)).numpy()
    np.testing.assert_allclose(conv, ref, rtol=0, atol=1e-4)


def test_sss_walk_on_instanced_scene_matches_jax():
    """The walk decodes the packed prim before its face-normal gather and
    maps the normal to world space. JAX's instanced specialization leaves
    `sss` out, so the flag is given explicitly; the port's partial `spec`
    merges the same way."""
    jrec, trec = jmlib.sss_record("Marble", scale=3.0), tmlib.sss_record("Marble", scale=3.0)
    js = build(JAX, 2, True, cube_record=jrec)[2]
    ts = build(PORT, 2, True, cube_record=trec)[2]
    assert "sss" not in ts.spec
    cfg = dict(max_depth=4, rr_start=99, sss=True, sss_steps=8)
    assert tpt.specialize_config(ts, tpt.PTConfig(**cfg)).sss
    assert not tpt.specialize_config(ts, tpt.PTConfig(max_depth=4)).sss
    ref, ref_rays = jpt.render_counted(js, 24, 24, 4, jnp.uint32(3), jpt.PTConfig(**cfg))
    img, rays = tpt.render_counted(ts, 24, 24, 4, 3, tpt.PTConfig(**cfg))
    _, plain_rays = tpt.render_counted(ts, 24, 24, 4, 3, tpt.PTConfig(max_depth=4, rr_start=99))
    assert int(rays) == int(ref_rays) > int(plain_rays)
    assert abs(float(img.mean()) - float(np.asarray(ref).mean())) <= 1e-5 * float(img.mean())


def test_o_mesh_memory():
    _, _, inst = build(PORT, 8, True)
    assert int(inst.shading.verts.shape[0]) < 8 * 12   # rows of unique meshes only
    assert len(inst.instances) == 3 and int(inst.instances[0].to_object.shape[0]) == 8


def test_transform_update_skips_blas_rebuild():
    ds, nodes, inst = build(PORT, 4, True)
    cache_ids = {k: id(v["bvh"]) for k, v in ds._blas_cache.items()}
    o, d = torch.tensor([[2.2, 0.0, 5.0]]), torch.tensor([[0.0, 0.0, -1.0]])
    h0 = tscene.scene_intersect(inst, o, d)
    ds.set_node_transform(nodes[0], _translate(2.2, 0.0, 0.0))
    inst2 = ds.update(instancing=True)
    assert {k: id(v["bvh"]) for k, v in ds._blas_cache.items()} == cache_ids
    h1 = tscene.scene_intersect(inst2, o, d)
    # before the move the ray over (2.2, 0) meets only the floor (t = 5);
    # after it, the moved cube's top (z = 0.6, t = 4.4)
    assert float(h1.t[0]) < float(h0.t[0]) - 0.3


def _leaves(obj):
    out = []
    _tree.tree_map(lambda t: out.append(t) or t, obj)
    return out


def test_scene_to_moves_blas_and_instances(scenes):
    _, ts = scenes
    moved = ts.to("meta")
    for part in (moved.blas, moved.instances):
        leaves = _leaves(part)
        assert len(leaves) > 10 and all(t.device.type == "meta" for t in leaves)
    assert isinstance(moved.blas, tuple) and isinstance(moved.blas[0], tinst.BlasEntry)
    assert isinstance(moved.instances[0], tinst.InstanceGroup)


def test_replicate_scene_moves_blas_and_instances(scenes):
    import torch.distributed as dist

    from cudatracerlib_tpu_torch.parallel import distributed, shard

    _, ts = scenes
    assert distributed.init_distributed(0, 1, "localhost", distributed.free_port(),
                                        device="cpu")
    try:
        rep = shard.replicate_scene(ts, shard.make_mesh(1, 1, device="cpu"))
    finally:
        dist.destroy_process_group()
    for a, b in zip(_leaves((ts.blas, ts.instances)), _leaves((rep.blas, rep.instances))):
        # bit-equal: node rows carry child codes bitcast to floats (some NaN)
        assert a is not b and a.numpy().tobytes() == b.numpy().tobytes()
    assert len(_leaves(rep.blas)) == 3 * 5   # nodes, woop, tri_index, chunk_boxes, tri_verts
