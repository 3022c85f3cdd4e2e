"""The watertight ray / triangle test (accel/traversal.py `_watertight`, the
plain version of csrc/watertight.cuh): the Woop test's crack closed.

The JAX package, and the port before it, decided a hit by the Woop rows'
u >= 0, v >= 0, u + v <= 1, each triangle rounding its own u and v: a ray on
a quad's shared diagonal could fail both and pass through a closed wall. The
port now decides by the edge functions of the triangles' sheared vertices,
which two triangles sharing an edge compute from the same two vertices.

Checks, stated once:
  * on a shared edge the two triangles' edge functions are exact negatives
    (or equal, for the other winding), bit for bit, at any scale;
  * Cornell's 256x256 pixel-centre rays (as render_aovs makes them): the
    CRACK_RAYS rays that the Woop decision loses through a wall now hit,
    through the all-rows sweep, the cull emulation `cull_sweep` and the BVH
    walk, which agree bit for bit; no ray passes through a wall (a miss a
    float64 test, tolerant by 1e-6 in the barycentrics, hits);
  * rays aimed at the shared diagonals of random quads at three scales
    (tools/crack_cases.py) each hit their own quad, and each is inside at
    least one of its two triangles (both only where the edge function is
    exactly zero);
  * against JAX's `intersect_woop` on the same Cornell rays the port differs
    on JAX_DIFFERENT rays: JAX_THROUGH_WALL of them JAX misses through the
    crack, the rest hit the other triangle of a shared edge at an equal t
    (ROADMAP queue 3, "The reference behaves as below");
  * the BVH's vertex rows (`tri_verts`) that `convert`, `refit_bvh` and the
    instanced scene rebuild equal `vertex_rows` of their triangles.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import os
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.accel import traversal as jtrav
from cudatracerlib_tpu.scene.shapes import cornell_box as jcornell
from cudatracerlib_tpu_torch import convert
from cudatracerlib_tpu_torch.accel import bvh as tbvh
from cudatracerlib_tpu_torch.accel import traversal as ttrav
from cudatracerlib_tpu_torch.ops import intersect_bvh as bvh_ops
from cudatracerlib_tpu_torch.ops import intersect_dense as ops
from cudatracerlib_tpu_torch.scene import sensors
from cudatracerlib_tpu_torch.scene.shapes import cornell_box

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import crack_cases as cc  # noqa: E402  (tools/crack_cases.py)

SIZE = 256
CRACK_RAYS = 9          # the port's Woop decision lost these through a wall
JAX_DIFFERENT = 18
JAX_THROUGH_WALL = 9


@pytest.fixture(scope="module")
def cornell():
    """The port's Cornell box and its pixel-centre rays, as render_aovs makes them."""
    scene = cornell_box(device="cpu")
    pid = torch.arange(SIZE * SIZE)
    uv = torch.stack([((pid % SIZE).float() + 0.5) / SIZE,
                      ((pid // SIZE).float() + 0.5) / SIZE], -1)
    o, d, _ = sensors.sample_ray(scene.camera, uv, torch.full_like(uv, 0.5))
    return scene, o, d


def _woop_decision(woop, o, d):
    """(B,) the Woop test's closest-hit validity, on the port's own t, u, v."""
    return cc.woop_decision(woop, o, d)[0]


@pytest.mark.parametrize("scale", cc.SCALES)
def test_shared_edge_functions_are_exact_negatives(scale):
    """The edge function of a shared edge, computed in each of the two
    triangles, is the same number up to sign, bit for bit: the property
    the test's watertightness rests on."""
    tris, o, d, _ = cc.diagonal_quads(32, 16, scale, 7)
    verts = tbvh.vertex_rows(torch.from_numpy(tris))
    o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
    cx, cy = ttrav._shear(d_t.unbind(-1))
    q = torch.arange(o.shape[0]) // 16
    p1, p2 = verts[2 * q].unbind(-1), verts[2 * q + 1].unbind(-1)
    _, (u1, v1, w1) = ttrav._edge_functions(p1, o_t.unbind(-1), cx, cy)
    _, (u2, v2, w2) = ttrav._edge_functions(p2, o_t.unbind(-1), cx, cy)
    # triangle 2k is (A, B, C), 2k + 1 is (A, C, E) on even quads, (A, E, C) on odd ones:
    # the shared edge A-C is V (edge C -> A) of the first, W (A -> C) or V (C -> A) of the second
    even = (q % 2 == 0)
    assert torch.equal(torch.where(even, -w2, v2), v1)


def test_cornell_crack_rays_hit(cornell):
    scene, o, d = cornell
    bvh = scene.bvh
    hit = ttrav.intersect_brute_force(bvh.woop, o, d, verts=bvh.tri_verts)
    culled, _, _ = ops.cull_sweep(bvh.woop, bvh.chunk_boxes, o, d, verts=bvh.tri_verts)
    walked = bvh_ops.intersect_bvh_plain(bvh, o, d)
    assert torch.equal(culled.prim, hit.prim) and torch.equal(culled.t[hit.valid], hit.t[hit.valid])
    same_tri = bvh.tri_index[walked.prim.clamp(min=0).long()] == bvh.tri_index[hit.prim.clamp(
        min=0).long()]
    assert torch.equal(walked.valid, hit.valid) and bool(same_tri[hit.valid].all())
    covered = torch.from_numpy(cc.through_wall(scene.shading.verts.numpy(), o.numpy(), d.numpy()))
    old = _woop_decision(bvh.woop, o, d)
    assert int((covered & ~old).sum()) == CRACK_RAYS
    assert int((covered & ~hit.valid).sum()) == 0
    assert int((covered & ~walked.valid).sum()) == 0
    assert bool(hit.valid[covered & ~old].all())
    assert torch.equal(hit.valid, covered)   # every hit is a wall the float64 test finds


@pytest.mark.parametrize("scale", cc.SCALES)
def test_shared_diagonal_rays_hit_their_quad(scale):
    tris, o, d, quad = cc.diagonal_quads(48, 24, scale, 11)
    woop = torch.from_numpy(tbvh.woop_transform(tris[:, 0], tris[:, 1], tris[:, 2]))
    verts = tbvh.vertex_rows(torch.from_numpy(tris))
    o_t, d_t, own = torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(quad)
    hit = ttrav.intersect_brute_force(woop, o_t, d_t, verts=verts)
    assert bool(hit.valid.all()) and torch.equal(hit.prim.long() // 2, own)
    culled, _, _ = ops.cull_sweep(woop, tbvh.chunk_boxes_from_woop(woop), o_t, d_t, verts=verts)
    assert torch.equal(culled.prim, hit.prim) and torch.equal(culled.t, hit.t)
    b = tbvh.build_bvh(tris, device="cpu")
    walked = bvh_ops.intersect_bvh_plain(b, o_t, d_t)
    assert bool(walked.valid.all())
    assert torch.equal(b.tri_index[walked.prim.long()].long() // 2, own)
    # each ray is inside at least one of its quad's two triangles
    rows = torch.stack([2 * own, 2 * own + 1], -1)
    _, _, _, inside = ttrav.intersect_woop(woop[rows], o_t[:, None], d_t[:, None], 1e-4, torch.inf,
                                           verts=verts[rows])
    assert bool(inside.any(-1).all())
    assert int((~_woop_decision(woop, o_t, d_t)).sum()) > 0.05 * o.shape[0]   # the Woop crack


def test_differences_from_jax_are_the_crack(cornell):
    """The port against JAX's `intersect_woop` (its brute force) on the same
    rays: JAX_DIFFERENT rays differ, JAX_THROUGH_WALL of them through JAX's
    crack, the rest on a shared edge at an equal t."""
    scene, o, d = cornell
    hit = ttrav.intersect_brute_force(scene.bvh.woop, o, d, verts=scene.bvh.tri_verts)
    jh = jtrav.intersect_brute_force(SimpleNamespace(woop=jnp.asarray(scene.bvh.woop.numpy())),
                                     jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    jprim = torch.from_numpy(np.array(jh.prim))
    differ = jprim != hit.prim
    assert int(differ.sum()) == JAX_DIFFERENT
    assert int((differ & (jprim < 0)).sum()) == JAX_THROUGH_WALL
    both = differ & (jprim >= 0) & hit.valid
    jt = torch.from_numpy(np.array(jh.t))
    assert int(both.sum()) == JAX_DIFFERENT - JAX_THROUGH_WALL
    assert bool(((jt[both] - hit.t[both]).abs() <= 1e-5 * hit.t[both]).all())
    same = ~differ & hit.valid
    np.testing.assert_allclose(hit.t[same].numpy(), jt[same].numpy(), rtol=1e-6)


def test_vertex_rows_rebuilt_with_the_bvh():
    """`tri_verts` equals `vertex_rows` of the rows' triangles wherever the
    BVH is built or rebuilt: build_scene, convert (from the JAX Scene's
    shading vertices), refit_bvh, and an instanced scene's BLASes through
    convert and the port's DynamicScene."""
    from cudatracerlib_tpu.scene import dynamic as jdyn
    from cudatracerlib_tpu.scene import sensors as jsensors
    from cudatracerlib_tpu.scene import shapes as jshapes
    from cudatracerlib_tpu_torch.accel import refit
    from cudatracerlib_tpu_torch.scene import dynamic as tdyn
    from cudatracerlib_tpu_torch.scene import sensors as tsensors
    from cudatracerlib_tpu_torch.scene import shapes as tshapes

    port = cornell_box(device="cpu")
    conv = convert.scene_from_numpy(convert.flatten(jcornell()), device="cpu")
    for s in (port, conv):
        assert torch.equal(s.bvh.tri_verts, tbvh.vertex_rows(s.shading.verts))
    assert torch.equal(conv.bvh.tri_verts, port.bvh.tri_verts)
    assert "bvh.tri_verts" not in convert.flatten(port)

    bvh, host = tbvh.build_bvh(port.shading.verts.numpy(), with_host=True, device="cpu")
    plan = refit.build_refit_plan(host["nodes"], host["root"], device="cpu")
    moved = bvh.tri_verts.reshape(-1, 3, 4)[..., :3] * 1.25 + 0.5   # leaf order
    new = refit.refit_bvh(bvh, plan, moved)
    assert torch.equal(new.tri_verts, tbvh.vertex_rows(moved))

    def instanced(ds, sh, camera):
        diffuse = {"bsdf_type": 0, "tex_albedo": 0}
        cube = ds.create_mesh(sh.box([-0.3, -0.3, 0.0], [0.3, 0.3, 0.6]))
        floor = ds.create_mesh(sh.quad([-4, -4, 0], [4, -4, 0], [4, 4, 0], [-4, 4, 0]))
        lightq = ds.create_mesh(sh.quad([-0.6, -0.6, 3.2], [-0.6, 0.6, 3.2], [0.6, 0.6, 3.2],
                                        [0.6, -0.6, 3.2]))
        for i in range(3):
            m = np.eye(4)
            m[:3, 3] = [1.2 * i - 1.2, 0.0, 0.0]
            ds.create_node(cube, m, diffuse)
        ds.create_node(floor, np.eye(4), diffuse)
        ds.make_node_emissive(ds.create_node(lightq, np.eye(4), diffuse), [14.0, 13.0, 12.0])
        ds.set_camera(camera.look_at([0, -5.5, 3.0], [0, 0, 0.4], up=[0, 0, 1], fov_deg=45.0))
        return ds.update(instancing=True)

    js = instanced(jdyn.DynamicScene(), jshapes, jsensors.Camera)
    ts = instanced(tdyn.DynamicScene(device="cpu"), tshapes, tsensors.Camera)
    cs = convert.scene_from_numpy(convert.flatten(js), device="cpu")
    for k, (a, b) in enumerate(zip(cs.blas, ts.blas)):
        base = int(cs.instances[k].prim_base[0])
        rows = cs.shading.verts[base:base + a.bvh.woop.shape[0]]
        assert torch.equal(a.bvh.tri_verts, tbvh.vertex_rows(rows))
        assert torch.equal(a.bvh.tri_verts, b.bvh.tri_verts)
    assert torch.equal(cs.bvh.tri_verts, cs.blas[0].bvh.tri_verts)
