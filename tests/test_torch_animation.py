"""Skinned animation (scene/animation.py) against the JAX package on the CPU:
tests/test_animation.py's two-bone beam, posed, rendered and differentiated
with respect to the pose.

The port's scene and rig come from the JAX ones' arrays (`convert`).
Tolerances, stated once:
  * skinned vertices within 1e-6;
  * the posed scene's node boxes and normals within 1e-6, child codes
    bit-equal, face normals refreshed (JAX's stay at the rest pose), Woop rows within 1e-5 of each row's size (the refit test's
    gate, tests/test_torch_refit.py);
  * a 32x32, 4-spp render of the posed scene: every pixel within 1e-4;
  * the gradient of that render's mean with respect to the pose within
    1e-3 of `jax.grad`'s largest entry, entry by entry.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.accel.bvh import build_bvh as jbuild_bvh
from cudatracerlib_tpu.render import path_tracer as jpt
from cudatracerlib_tpu.scene import animation as janim
from cudatracerlib_tpu.scene import bsdf as JB
from cudatracerlib_tpu.scene import lights as JL
from cudatracerlib_tpu.scene.scene import Materials as JMaterials
from cudatracerlib_tpu.scene.scene import build_scene as jbuild_scene
from cudatracerlib_tpu.scene.sensors import Camera as JCamera
from cudatracerlib_tpu.scene.shapes import box as jbox
from cudatracerlib_tpu.scene.textures import Textures as JTextures
from cudatracerlib_tpu_torch.convert import flatten, scene_from_numpy, skinned_from_numpy
from cudatracerlib_tpu_torch.render import path_tracer as tpt
from cudatracerlib_tpu_torch.scene import animation as tanim
from cudatracerlib_tpu_torch.scene import scene as tscene

CFG = dict(max_depth=3)
SIZE, SPP, SEED = 32, 4, 5


def _pose(angle_deg):
    """Bone 0 at rest, bone 1 rotated about z through the origin."""
    a = np.radians(angle_deg)
    R = np.eye(4, dtype=np.float32)
    R[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    return np.stack([np.eye(4, dtype=np.float32), R])


@pytest.fixture(scope="module")
def beam():
    """tests/test_animation.py's beam along +x in [0, 2], bone 1's weight
    growing with x, in both packages; a point light joins its constant
    environment, so the image depends on the pose differentiably (under the
    environment alone a convex diffuse beam shades the same at any pose).
    Its uv chart is not the default one, so it is not flat-shaded: the flat
    path reads `n_face`, which the port's animate_scene refreshes and JAX's
    leaves at the rest pose (test_n_face_follows_the_pose)."""
    tris = jbox([0, -0.1, -0.1], [2, 0.1, 0.1])
    uvs = np.zeros((len(tris), 3, 2), np.float32)    # a half-scale chart: not flat-shaded
    uvs[:, 1, 0] = uvs[:, 2, 1] = 0.5
    js = jbuild_scene(
        tris, None, uvs, np.zeros(len(tris), np.int32),
        JMaterials.build([{"bsdf_type": JB.DIFFUSE}]),
        JTextures.build([{"type": 0, "color_a": [0.5] * 3}]),
        [{"type": JL.CONSTANT_ENV, "radiance": [1, 1, 1]},
         {"type": JL.POINT, "position": [1.0, -1.5, 1.5], "radiance": [4.0, 4.0, 4.0]}],
        JCamera.look_at([1, -4, 0.5], [1, 0, 0]))
    verts = np.asarray(js.shading.verts)
    w_b1 = np.clip(verts[..., 0] / 2.0, 0, 1)
    bone_ids = np.zeros(verts.shape[:2] + (4,), np.int32)
    bone_ids[..., 1] = 1
    weights = np.zeros(verts.shape[:2] + (4,), np.float32)
    weights[..., 0] = 1 - w_b1
    weights[..., 1] = w_b1
    _, host = jbuild_bvh(tris, with_host=True)
    jmesh = janim.make_skinned(js, host["nodes"], host["root"], bone_ids, weights,
                               np.stack([np.eye(4)] * 2))
    ts = scene_from_numpy(flatten(js), device="cpu")
    tmesh = skinned_from_numpy(flatten(jmesh), device="cpu")
    return js, jmesh, ts, tmesh, host


def test_make_skinned_matches_conversion(beam):
    js, jmesh, ts, tmesh, host = beam
    built = tanim.make_skinned(ts, host["nodes"], host["root"], tmesh.bone_ids.numpy(),
                               tmesh.weights.numpy(), tmesh.inv_bind.numpy())
    for f in ("rest", "bone_ids", "weights", "inv_bind"):
        assert torch.equal(getattr(built, f), getattr(tmesh, f)), f
    for a, b in zip(built.plan.level_nodes, tmesh.plan.level_nodes):
        assert torch.equal(a, b)


def test_skin_vertices_match_jax(beam):
    js, jmesh, ts, tmesh, _ = beam
    pose = _pose(90.0)
    ref = np.asarray(janim.skin_vertices(jmesh, jnp.asarray(pose)))
    got = tanim.skin_vertices(tmesh, torch.from_numpy(pose)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    verts = np.asarray(js.shading.verts)
    assert got[verts[..., 0] > 1.9][:, 1].mean() > 1.0   # the tip bends to +y


@pytest.fixture(scope="module")
def posed(beam):
    js, jmesh, ts, tmesh, _ = beam
    pose = _pose(35.0)
    return (janim.animate_scene(js, jmesh, jnp.asarray(pose)),
            tanim.animate_scene(ts, tmesh, torch.from_numpy(pose)), ts)


def test_animate_scene_matches_jax(posed):
    js2, ts2, ts = posed
    jn, tn = np.asarray(js2.bvh.nodes), ts2.bvh.nodes.numpy()
    np.testing.assert_allclose(tn[:, :12], jn[:, :12], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tn[:, 12:].view(np.int32), jn[:, 12:].view(np.int32))
    np.testing.assert_allclose(ts2.shading.normals.numpy(), np.asarray(js2.shading.normals),
                               rtol=0, atol=1e-6)
    ref = np.asarray(js2.bvh.woop).astype(np.float64)
    T = ref.shape[0]
    size = np.repeat(np.abs(ref).reshape(T, 3, 4)[:, :, :3].max(-1), 4, axis=1)
    v0 = np.asarray(js2.shading.verts)[:, 0]
    for c in (3, 7, 11):
        size[:, c] = (np.abs(ref[:, c - 3:c]) * np.abs(v0)).sum(-1)
    assert (np.abs(ts2.bvh.woop.numpy() - ref) <= 1e-5 * size).all()
    assert float(ts2.bvh.world_max[1]) > 0.5
    # the rest pose's specialization rides along; the chunk boxes follow the pose
    assert ts.spec is None and ts2.spec == tscene.scene_spec(ts)
    assert not torch.equal(ts2.bvh.chunk_boxes, ts.bvh.chunk_boxes)


def test_n_face_follows_the_pose(beam, posed):
    """The port refreshes the face normals that the flat path, the shade
    pack and the subsurface walk read; JAX keeps the rest pose's."""
    js, _, ts, _, _ = beam
    js2, ts2, _ = posed
    assert not tpt.specialize_config(ts2, tpt.PTConfig()).flat_shading
    v = ts2.shading.verts
    n = torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True)
    np.testing.assert_allclose(ts2.shading.n_face.numpy(), n.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(js2.shading.n_face), np.asarray(js.shading.n_face))
    assert not np.allclose(ts2.shading.n_face.numpy(), np.asarray(js.shading.n_face))


def test_posed_render_matches_jax(posed):
    js2, ts2, _ = posed
    ref = np.asarray(jpt.render(js2, SIZE, SIZE, SPP, jnp.uint32(SEED), jpt.PTConfig(**CFG)))
    got = tpt.render(ts2, SIZE, SIZE, SPP, SEED, tpt.PTConfig(**CFG)).numpy()
    assert np.isfinite(got).all() and got.mean() > 0.1
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_pose_gradient_matches_jax(beam):
    js, jmesh, ts, tmesh, _ = beam
    pose = _pose(35.0)

    def jloss(p):
        s = janim.animate_scene(js, jmesh, p)
        return jpt.render(s, SIZE, SIZE, SPP, jnp.uint32(SEED), jpt.PTConfig(**CFG)).mean()

    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(pose))
    tp = torch.from_numpy(pose).requires_grad_()
    loss = tpt.render(tanim.animate_scene(ts, tmesh, tp), SIZE, SIZE, SPP, SEED,
                      tpt.PTConfig(**CFG)).mean()
    loss.backward()
    jg = np.asarray(jg)
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    assert np.abs(jg).max() > 0 and np.isfinite(tp.grad.numpy()).all()
    np.testing.assert_allclose(tp.grad.numpy(), jg, rtol=0, atol=1e-3 * np.abs(jg).max())
