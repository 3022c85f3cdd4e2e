"""BVH refit (accel/refit.py) against the JAX package on the CPU, and the
port's own chunk boxes after a refit.

Both refit the same tree (the JAX BVH's arrays carried across by
`convert.bvh_from_numpy`). Tolerances, stated once:
  * Woop rows: within 1e-6 relative (plus 1e-6 of the table's largest
    entry) of JAX's closed form, on tests/test_animation.py's 200 triangles;
    the refitted ones (500 small triangles) within 1e-5 of each row's
    size (`_assert_woop_close`);
  * the refit plan's levels and child codes equal; refitted node boxes
    within 1e-6, child codes bit-equal;
  * hits of the refitted tree against brute force: valid equal, t rtol 1e-3
    (tests/test_animation.py's gate);
  * every refitted row's triangle lies inside its chunk's refitted box, and
    the dense kernel's cull emulation on those boxes finds exactly the
    brute-force hits (the stale boxes do not).
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.accel import refit as jrefit
from cudatracerlib_tpu.accel.bvh import build_bvh as jbuild_bvh
from cudatracerlib_tpu_torch.accel import refit as trefit
from cudatracerlib_tpu_torch.accel.bvh import CHUNK_ROWS, build_bvh
from cudatracerlib_tpu_torch.accel.traversal import intersect, intersect_brute_force
from cudatracerlib_tpu_torch.convert import bvh_from_numpy, flatten
from cudatracerlib_tpu_torch.ops.intersect_dense import cull_sweep


def test_woop_transform_device_matches_jax():
    rng = np.random.default_rng(0)
    tris = rng.normal(size=(200, 3, 3)).astype(np.float32)
    ref = np.asarray(jrefit.woop_transform_device(jnp.asarray(tris)))
    got = trefit.woop_transform_device(torch.from_numpy(tris)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def _assert_woop_close(got, ref, v0):
    """Within 1e-5 of each row's size: its largest |coefficient|, and for
    its offset -r.v0 the sum of |r_k v0_k| (the offset cancels). The
    nested cross products of a small triangle round differently under
    XLA's CPU (which may contract them into FMAs): 2.3e-6 of the row's size
    at most on this case."""
    T = ref.shape[0]
    size = np.repeat(np.abs(ref).reshape(T, 3, 4)[:, :, :3].max(-1), 4, axis=1).astype(np.float64)
    for c in (3, 7, 11):
        size[:, c] = (np.abs(ref[:, c - 3:c]) * np.abs(v0)).sum(-1)
    assert (np.abs(got.astype(np.float64) - ref) <= 1e-5 * size).all()


def _deformed_case(T=500):
    """tests/test_animation.py's refit case: 500 small triangles, then a
    translation and a nonuniform stretch."""
    rng = np.random.default_rng(1)
    c = rng.uniform(0, 1, (T, 1, 3))
    tris = (c + rng.uniform(-0.05, 0.05, (T, 3, 3))).astype(np.float32)
    deformed = tris * np.array([1.3, 0.8, 1.0], np.float32) + 0.2
    return rng, tris, deformed


@pytest.fixture(scope="module")
def refitted():
    rng, tris, deformed = _deformed_case()
    jbvh, host = jbuild_bvh(tris, with_host=True)
    jplan = jrefit.build_refit_plan(host["nodes"], host["root"])
    order = np.asarray(jbvh.tri_index)
    jnew = jrefit.refit_bvh(jbvh, jplan, jnp.asarray(deformed[order]))
    tbvh = bvh_from_numpy(flatten(jbvh), tris[order], device="cpu")
    tplan = trefit.build_refit_plan(host["nodes"], host["root"], device="cpu")
    tnew = trefit.refit_bvh(tbvh, tplan, torch.from_numpy(deformed[order]))
    return dict(rng=rng, host=host, jplan=jplan, tplan=tplan, jnew=jnew, tbvh=tbvh, tnew=tnew,
                deformed_leaf=deformed[order])


def test_refit_plan_matches_jax(refitted):
    jp, tp = refitted["jplan"], refitted["tplan"]
    assert len(jp.level_nodes) == len(tp.level_nodes) > 3
    for a, b in zip(jp.level_nodes, tp.level_nodes):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(tp.c0.numpy(), np.asarray(jp.c0))
    np.testing.assert_array_equal(tp.c1.numpy(), np.asarray(jp.c1))


def test_refit_nodes_match_jax(refitted):
    jn, tn = np.asarray(refitted["jnew"].nodes), refitted["tnew"].nodes.numpy()
    np.testing.assert_allclose(tn[:, :12], jn[:, :12], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tn[:, 12:].view(np.int32), jn[:, 12:].view(np.int32))
    np.testing.assert_allclose(refitted["tnew"].world_min, np.asarray(refitted["jnew"].world_min),
                               atol=1e-6)
    np.testing.assert_allclose(refitted["tnew"].world_max, np.asarray(refitted["jnew"].world_max),
                               atol=1e-6)
    _assert_woop_close(refitted["tnew"].woop.numpy(), np.asarray(refitted["jnew"].woop),
                       refitted["deformed_leaf"][:, 0])
    # the refit moved the boxes
    assert not np.allclose(tn[:, :12], refitted["tbvh"].nodes.numpy()[:, :12])


def _rays(rng, B=1024):
    o = rng.uniform(-0.3, 1.6, (B, 3)).astype(np.float32)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d)


def test_refit_hits_match_brute_force(refitted):
    o, d = _rays(np.random.default_rng(2))
    bvh = refitted["tnew"]
    h = intersect(bvh, o, d)
    truth = intersect_brute_force(bvh.woop, o, d, verts=bvh.tri_verts)
    assert torch.equal(h.valid, truth.valid) and int(h.valid.sum()) > 20
    m = h.valid
    np.testing.assert_allclose(h.t[m].numpy(), truth.t[m].numpy(), rtol=1e-3)


def test_refitted_rows_inside_refitted_chunk_boxes(refitted):
    bvh = refitted["tnew"]
    v = torch.from_numpy(refitted["deformed_leaf"])
    boxes = bvh.chunk_boxes
    assert boxes.shape == (-(-v.shape[0] // CHUNK_ROWS), 8)
    chunk = torch.arange(v.shape[0]) // CHUNK_ROWS
    lo, hi = boxes[chunk, None, 0:3], boxes[chunk, None, 4:7]
    assert bool(((v >= lo) & (v <= hi)).all())
    # the rest-pose boxes do not hold the deformed triangles
    old = refitted["tbvh"].chunk_boxes
    assert not bool(((v >= old[chunk, None, 0:3]) & (v <= old[chunk, None, 4:7])).all())


def test_dense_cull_on_refitted_mesh_finds_brute_force_hits():
    """A refitted mesh below 4096 rows through the dense kernel's cull
    emulation: the refitted boxes find every hit, the stale ones lose some."""
    _, tris, deformed = _deformed_case()
    bvh, host = build_bvh(tris, with_host=True, device="cpu")
    assert bvh.woop.shape[0] <= 4096
    plan = trefit.build_refit_plan(host["nodes"], host["root"], device="cpu")
    new = trefit.refit_bvh(bvh, plan, torch.from_numpy(deformed[host["order"]]))
    o, d = _rays(np.random.default_rng(3), 4096)
    truth = intersect_brute_force(new.woop, o, d, verts=new.tri_verts)
    hit, _, _ = cull_sweep(new.woop, new.chunk_boxes, o, d, verts=new.tri_verts)
    m = truth.valid
    assert torch.equal(hit.prim, truth.prim) and torch.equal(hit.t[m], truth.t[m])
    assert int(m.sum()) > 100
    stale, _, _ = cull_sweep(new.woop, bvh.chunk_boxes, o, d, verts=new.tri_verts)
    assert int((stale.prim != truth.prim).sum()) > 0


def test_degenerate_triangle_opens_its_chunk():
    """A near-degenerate triangle's closed-form rows are huge (JAX clamps
    the determinant at 1e-20): its chunk's box is all of space."""
    rng = np.random.default_rng(4)
    tris = rng.uniform(0, 1, (64, 3, 3)).astype(np.float32)
    tris[5, 2] = tris[5, 0] + 1e-7 * (tris[5, 1] - tris[5, 0])   # a sliver
    bvh, host = build_bvh(tris, with_host=True, device="cpu")
    plan = trefit.build_refit_plan(host["nodes"], host["root"], device="cpu")
    new = trefit.refit_bvh(bvh, plan, torch.from_numpy(tris[host["order"]]))
    row = int(np.nonzero(host["order"] == 5)[0][0])
    box = new.chunk_boxes[row // CHUNK_ROWS]
    assert bool(torch.isinf(box[0:3]).all() and torch.isinf(box[4:7]).all())
