"""Bench config 3's scene (the procedural bigscene) in the port against the
JAX package, on the CPU, at n_tris_target = 20,000 (12,476 triangles,
13,748 padded Woop rows, the BVH walk's band).

Tolerances:
  * scene arrays exactly equal, the BVH nodes bit for bit (their child
    codes are int32 bit patterns in float32 lanes, NaNs among them);
  * `render_wavefront_counted` at 16x16, 2 spp, depth 5, seed 3: the ray
    count equal, every pixel within 1e-3 relative plus 1e-6 (2.9e-6
    absolute and 2.0e-6 relative measured): float32 rounding in the two
    BVH walks and the shading.
The JAX package caches the built scene in npz files: the tests point its
cache at a temporary directory.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import inspect

import numpy as np
import pytest
import torch

from cudatracerlib_tpu.render import path_tracer as jpt
from cudatracerlib_tpu.render import wavefront as jwf
from cudatracerlib_tpu.scene import bigscene as jbig
from cudatracerlib_tpu_torch import convert
from cudatracerlib_tpu_torch.convert import flatten
from cudatracerlib_tpu_torch.render import path_tracer as tpt
from cudatracerlib_tpu_torch.render import wavefront as twf
from cudatracerlib_tpu_torch.render.light_tracer import render_light_trace
from cudatracerlib_tpu_torch.scene import bigscene as tbig

N_TRIS = 20_000


@pytest.fixture(scope="module")
def jax_cache(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUDATRACERLIB_TPU_SCENE_CACHE", str(tmp_path_factory.mktemp("jax_scenes")))
        yield


@pytest.fixture(scope="module")
def scenes(jax_cache):
    return jbig.build_big_scene(N_TRIS), tbig.build_big_scene(N_TRIS, device="cpu")


def _assert_arrays_equal(a, b):
    assert set(b) <= set(a), sorted(set(b) - set(a))
    for k in sorted(b):
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        if a[k].dtype == np.float32:  # bit patterns: NaN codes compare equal
            np.testing.assert_array_equal(a[k].view(np.int32), b[k].view(np.int32), err_msg=k)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_build_big_scene_defaults_to_the_card():
    assert inspect.signature(tbig.build_big_scene).parameters["device"].default == "cuda"


@pytest.mark.parametrize("n_tris,seed", [(2_000, 0), (N_TRIS, 5), (60_000, 1)])
def test_geometry_exactly_equal(jax_cache, n_tris, seed):
    """The generator alone: vertices and material ids equal JAX's exactly
    at several sizes and seeds."""
    jv, jm = jbig._big_geometry(n_tris, seed)
    tv, tm = tbig._big_geometry(n_tris, seed)
    assert tv.dtype == np.float32 and tm.dtype == np.int32 and tv.shape == (tm.shape[0], 3, 3)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tm, jm)
    assert set(np.unique(tm)) == {0, 1, 2}


def test_bigscene_arrays_exactly_equal(scenes):
    js, ts = scenes
    assert ts.bvh.woop.shape == (13_748, 12)
    _assert_arrays_equal(flatten(js), flatten(ts))


def test_jax_bigscene_converts(scenes):
    """`scene_from_numpy` takes the JAX bigscene's arrays: the result equals
    the port's own build field for field (the dense intersector's chunk
    boxes, a derived leaf, are rebuilt from the Woop rows there and unused
    above the dense band)."""
    js, ts = scenes
    conv = convert.scene_from_numpy(flatten(js), device="cpu")
    _assert_arrays_equal(flatten(ts), flatten(conv))
    assert conv.bvh.chunk_boxes.shape == ts.bvh.chunk_boxes.shape


def test_env_light_variant_equal(jax_cache):
    js = jbig.build_big_scene(2_000, light="env")
    ts = tbig.build_big_scene(2_000, light="env", device="cpu")
    _assert_arrays_equal(flatten(js), flatten(ts))
    assert ts.spec["light_types"] == (5,)  # CONSTANT_ENV
    # emitted rays of a constant environment are not ported
    with pytest.raises(NotImplementedError):
        render_light_trace(ts, 8, 8, 64, 0)


def test_bigscene_wavefront_matches_jax(scenes):
    """Bench config 3's engine at 16x16, 2 spp, depth 5, seed 3 (JAX: 1,125
    rays, mean 0.158682)."""
    js, ts = scenes
    ref, ref_rays = jwf.render_wavefront_counted(js, 16, 16, 2, 3, jpt.PTConfig(max_depth=5))
    img, rays = twf.render_wavefront_counted(ts, 16, 16, 2, 3, tpt.PTConfig(max_depth=5))
    assert rays.dtype == torch.int64 and int(rays) == int(ref_rays)
    ref = np.asarray(ref)
    assert img.shape == (16, 16, 3) and bool(torch.isfinite(img).all())
    np.testing.assert_allclose(img.numpy(), ref, rtol=1e-3, atol=1e-6)
    assert float(img.mean()) > 0.05


def _depth_by_recursion(nodes, code):
    if code < 0:
        return 0
    c = nodes[code, 12:14].copy().view(np.int32)
    return 1 + max(_depth_by_recursion(nodes, int(c[0])), _depth_by_recursion(nodes, int(c[1])))


def test_tree_depth_and_stack_overflow(scenes, monkeypatch):
    """`tree_depth` against a recursive walk of the bigscene's BVH; within
    that depth the oracle's STACK_DEPTH-entry stack never overflows, and a
    stack cut below it overflows on some camera rays (each push onto a full
    stack counted) and loses hits."""
    from cudatracerlib_tpu_torch.accel import traversal
    from cudatracerlib_tpu_torch.accel.bvh import tree_depth
    from cudatracerlib_tpu_torch.ops.intersect_bvh import intersect_bvh_plain

    _, ts = scenes
    nodes = ts.bvh.nodes.numpy()
    depth = tree_depth(nodes, int(ts.bvh.root_code))
    assert depth == _depth_by_recursion(nodes, int(ts.bvh.root_code))
    assert 4 < depth <= traversal.STACK_DEPTH
    _, o, d, _ = twf._camera_ray(ts, torch.arange(1024), 3, 32, 32)
    hit, over = intersect_bvh_plain(ts.bvh, o, d, with_overflow=True)
    hit2, n_inner, _, _, over2 = intersect_bvh_plain(ts.bvh, o, d, with_counts=True,
                                                      with_overflow=True)
    assert int(over.sum()) == 0 and torch.equal(over, over2) and torch.equal(hit.t, hit2.t)
    assert int(n_inner.max()) > depth
    monkeypatch.setattr(traversal, "STACK_DEPTH", 2)
    cut, over_cut = intersect_bvh_plain(ts.bvh, o, d, with_overflow=True)
    assert int((over_cut > 0).sum()) > 0
    assert bool((cut.t >= hit.t).all()) and not torch.equal(cut.prim, hit.prim)


def test_compare_hits_tells_coincident_ties_from_errors():
    """Two hits at distinct rows and one t: a tie when the hit point lies on
    both triangles (coplanar and overlapping, like two box bottoms at
    z = 0), an error when it does not."""
    from cudatracerlib_tpu_torch.accel.bvh import woop_transform
    from cudatracerlib_tpu_torch.accel.traversal import Hit
    from cudatracerlib_tpu_torch.ops.intersect_dense import compare_hits

    tris = np.array([[[0, 0, 0], [2, 0, 0], [0, 2, 0]], [[0.5, 0.5, 0], [3, 0.5, 0], [0.5, 3, 0]],
                     [[0, 0, 1], [1, 0, 1], [0, 1, 1]]], np.float32)
    woop = torch.from_numpy(woop_transform(tris[:, 0], tris[:, 1], tris[:, 2]))
    ones = torch.ones(2)
    a = Hit(t=ones, prim=torch.tensor([0, 0], dtype=torch.int32),
            bary=torch.tensor([[0.4, 0.4], [0.4, 0.4]]), valid=ones > 0)
    b = Hit(t=ones, prim=torch.tensor([1, 2], dtype=torch.int32),
            bary=torch.tensor([[0.12, 0.12], [0.3, 0.3]]), valid=ones > 0)
    r = compare_hits(a, b, woop, 1e-4, torch.inf)
    assert (r["prim_mismatch"], r["prim_mismatch_coincident"],
            r["prim_mismatch_not_grazing"]) == (2, 1, 1)
