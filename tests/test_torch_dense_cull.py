"""The dense intersector's chunk cull, on the CPU: the chunk boxes and the
plain cull emulation `cull_sweep` that the CUDA kernel's per-lane cull
follows (the kernel itself is held to the plain version on the card, in
test_torch_cuda.py).

- `woop_vertices` recovers the triangles behind a Woop table to 1e-5 of the
  scene's scale; degenerate (all-zero) rows are flagged and a chunk of them
  gets the empty box.
- The boxes built with the BVH equal the ones derived from its Woop rows to
  a hundredth of their padding, and contain every triangle of their chunk.
- `cull_sweep` gives t and prim bit-equal to the all-rows brute force, the
  port's and the JAX package's, on Cornell camera rays, the caustic
  scene's first photon rays and a soup of axis-aligned (zero-thickness)
  triangles with rays grazing their planes; its per-ray counts are the
  chunks whose box test passes at the final t, as the dense bound charges.
Inputs are made with numpy from fixed seeds.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.accel import traversal as jtrav
from cudatracerlib_tpu_torch.accel import bvh as tbvh
from cudatracerlib_tpu_torch.accel import traversal as ttrav
from cudatracerlib_tpu_torch.ops import intersect_dense as ops
from cudatracerlib_tpu_torch.render import path_tracer as pt
from cudatracerlib_tpu_torch.render import ppm
from cudatracerlib_tpu_torch.scene.shapes import caustic_scene, cornell_box


def _axis_soup(seed, n_tri=120):
    """Triangles in the planes x, y or z = a multiple of 0.5: each chunk box
    is thin or of zero thickness before its padding. Every 7th triangle is
    a point, so its Woop row is all zero."""
    rng = np.random.default_rng(seed)
    tris = rng.uniform(-1.0, 1.0, (n_tri, 3, 3))
    for k in range(n_tri):
        tris[k, :, k % 3] = rng.choice(np.arange(-2, 3) * 0.5)
    tris[::7, 1:] = tris[::7, :1]
    return tris.astype(np.float32)


def _axis_rays(tris, n, seed):
    """A third aimed at triangle centroids, a third along the axes, a third
    grazing: an origin coordinate on a triangle's plane and the direction
    in that plane."""
    rng = np.random.default_rng(seed)
    k = n // 3
    o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    target = tris[rng.integers(0, len(tris), k)].mean(1)
    d = np.empty((n, 3), np.float32)
    d[:k] = target - o[:k]
    axis = rng.integers(0, 3, k)
    d[k:2 * k] = 0.0
    d[np.arange(k, 2 * k), axis] = rng.choice([-1.0, 1.0], k)
    src = rng.integers(0, len(tris), n - 2 * k)
    plane = src % 3
    rows = np.arange(2 * k, n)
    o[rows, plane] = tris[src, 0, plane]
    d[2 * k:] = rng.normal(size=(n - 2 * k, 3))
    d[rows, plane] = 0.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _photon_rays(scene, n):
    """The caustic scene's first photon-walk rays, as trace_photons emits
    them (captured at the dense intersector)."""
    seen = []
    real = ops.intersect_dense

    def capture(woop, o, d, *args, **kw):
        seen.append((o.clone(), d.clone()))
        return real(woop, o, d, *args, **kw)

    ops.intersect_dense = capture
    try:
        cfg = pt.specialize_config(scene, ppm.PPMConfig().base._replace(max_depth=1))
        ppm.trace_photons(scene, n, 3, cfg)
    finally:
        ops.intersect_dense = real
    return seen[0]


@pytest.fixture(scope="module")
def tables():
    """name -> (woop (T, 12), chunk boxes of the BVH, vertices (T, 3, 3) in row order)."""
    out = {}
    for name, scene in (("cornell", cornell_box(device="cpu")),
                        ("caustic", caustic_scene(device="cpu"))):
        out[name] = (scene.bvh.woop, scene.bvh.chunk_boxes, scene.shading.verts)
    tris = _axis_soup(5)
    bvh, host = tbvh.build_bvh(tris, with_host=True, device="cpu")
    out["axis_soup"] = (bvh.woop, bvh.chunk_boxes, torch.from_numpy(host["tris"]))
    rng = np.random.default_rng(8)
    soup = (rng.uniform(-1, 1, (300, 1, 3)) + rng.normal(scale=0.1, size=(300, 3, 3)))
    bvh, host = tbvh.build_bvh(soup.astype(np.float32), with_host=True, device="cpu")
    out["soup"] = (bvh.woop, bvh.chunk_boxes, torch.from_numpy(host["tris"]))
    return out


NAMES = ["cornell", "caustic", "axis_soup", "soup"]


def _well_conditioned(woop, verts):
    v = verts.double()
    lo, hi = v.amin(1), v.amax(1)
    scale = (woop.double()[:, [0, 1, 2, 4, 5, 6]].abs().amax(-1)
             * ((hi - lo).amax(-1) + torch.maximum(lo.abs(), hi.abs()).amax(-1)))
    return ~(woop == 0).all(-1) & (scale <= tbvh.MAX_WOOP_SCALE)


@pytest.mark.parametrize("name", NAMES)
def test_woop_inverse_recovers_triangles(tables, name):
    woop, _, verts = tables[name]
    got, ok = tbvh.woop_vertices(woop)
    assert not ok[(woop == 0).all(-1)].any() and got[~ok].isnan().all()
    good = _well_conditioned(woop, verts)
    assert good.float().mean() > 0.9 and not (good & ~ok).any()
    scale = float(verts.abs().max())
    assert float((got[good] - verts[good].double()).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("name", NAMES)
def test_bvh_boxes_equal_derived_and_contain_their_rows(tables, name):
    woop, boxes, verts = tables[name]
    derived = tbvh.chunk_boxes_from_woop(woop)
    assert boxes.shape == derived.shape == (-(-woop.shape[0] // tbvh.CHUNK_ROWS), 8)
    finite = torch.isfinite(boxes).all(-1)
    assert torch.equal(finite, torch.isfinite(derived).all(-1))
    assert torch.equal(boxes[~finite], derived[~finite])  # all of space: +-inf
    lo, hi = boxes[finite, 0:3], boxes[finite, 4:7]
    core = (hi - lo).amax(-1) + torch.maximum(lo.abs(), hi.abs()).amax(-1)
    pad = tbvh.BOX_PAD_REL * core + tbvh.BOX_PAD_ABS
    assert ((boxes[finite] - derived[finite]).abs().amax(-1) <= 0.01 * pad).all()
    chunk = torch.arange(woop.shape[0]) // tbvh.CHUNK_ROWS
    rows = _well_conditioned(woop, verts)
    v = verts[rows]
    assert (v >= boxes[chunk[rows], None, 0:3]).all() and (v <= boxes[chunk[rows], None, 4:7]).all()
    if name != "caustic":  # its near-degenerate pole rows open 4 of 99 boxes
        assert finite.all()


def test_zero_and_wild_rows():
    """A chunk of all-zero rows gets the empty box; a nonzero row that does
    not invert opens its chunk's box to all of space."""
    tri = np.eye(3, dtype=np.float32)[None].repeat(8, 0)
    woop = torch.zeros(70, 12)
    woop[:8] = torch.from_numpy(tbvh.woop_transform(tri[:, 0], tri[:, 1], tri[:, 2]))
    woop[64] = 1.0  # singular: rows u, v, w all equal
    boxes = tbvh.chunk_boxes_from_woop(woop)
    assert (boxes[0, 0:3] < 0).all() and (boxes[0, 4:7] > 1).all()
    assert (boxes[1, [0, 1, 2, 4, 5, 6]] == tbvh.EMPTY_BOX).all()
    assert (boxes[2, 0:3] == -torch.inf).all() and (boxes[2, 4:7] == torch.inf).all()


def _rays_for(tables, name, n):
    if name == "cornell":
        scene = cornell_box(device="cpu")
        o, d, _, _ = pt.camera_rays(scene, 32, 24, 2, 3)
        return o, d
    if name == "caustic":
        return _photon_rays(caustic_scene(device="cpu"), n)
    o, d = _axis_rays(tables[name][2].numpy(), n, 11)
    return torch.from_numpy(o), torch.from_numpy(d)


@pytest.mark.parametrize("finite", [False, True], ids=["open", "per_ray_t_max"])
@pytest.mark.parametrize("name", ["cornell", "caustic", "axis_soup"])
def test_cull_sweep_bit_equal_to_brute_force(tables, name, finite):
    woop, boxes, tris = tables[name]
    verts = tbvh.vertex_rows(tris)
    o, d = _rays_for(tables, name, 1536)
    t_max = np.full(o.shape[0], np.inf, np.float32)
    if finite:
        t_max = np.random.default_rng(4).uniform(0.5, 6.0, o.shape[0]).astype(np.float32)
    got, n_chunks, n_rows = ops.cull_sweep(woop, boxes, o, d, 1e-4, torch.from_numpy(
        np.asarray(t_max)), verts=verts)
    port = ttrav.intersect_brute_force(woop, o, d, 1e-4,
                                       torch.from_numpy(np.minimum(t_max, ops.T_MAX_CLAMP)),
                                       verts=verts)
    jax_ = jtrav.intersect_brute_force(SimpleNamespace(woop=jnp.asarray(woop.numpy())),
                                       jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                                       1e-4, jnp.asarray(t_max))
    valid = got.valid.numpy()
    assert valid.sum() > 0.1 * o.shape[0]
    for ref in (port, jax_):
        np.testing.assert_array_equal(valid, np.asarray(ref.valid))
        np.testing.assert_array_equal(got.prim.numpy(), np.asarray(ref.prim))
        np.testing.assert_array_equal(got.t.numpy()[valid], np.asarray(ref.t)[valid])
        np.testing.assert_array_equal(got.bary.numpy()[valid], np.asarray(ref.bary)[valid])
    # a hit's own chunk is always among the counted ones
    assert (n_chunks[got.valid] >= 1).all() and (n_rows[got.valid] >= 1).all()


@pytest.mark.parametrize("name", ["cornell", "caustic", "axis_soup"])
def test_cull_counts_are_the_boxes_entered_at_the_final_t(tables, name):
    """The counts, recomputed with numpy's float32 slab test at each ray's
    final t, and the rows of those chunks."""
    woop, boxes, tris = tables[name]
    o, d = _rays_for(tables, name, 600)
    hit, n_chunks, n_rows = ops.cull_sweep(woop, boxes, o, d, 1e-4, np.inf,
                                           verts=tbvh.vertex_rows(tris))
    on, dn = o.numpy(), d.numpy()
    small = np.float32(1e-20)
    safe = np.where(np.abs(dn) < small, np.where(dn < 0, -small, small), dn)
    inv = (np.float32(1.0) / safe).astype(np.float32)
    lo, hi = boxes[:, 0:3].numpy(), boxes[:, 4:7].numpy()
    t0 = (lo[None] - on[:, None]) * inv[:, None]
    t1 = (hi[None] - on[:, None]) * inv[:, None]
    near, far = np.minimum(t0, t1).max(-1), np.maximum(t0, t1).min(-1)
    t_final = hit.t.numpy()[:, None]
    enter = np.maximum(near, np.float32(1e-4)) <= np.minimum(far, t_final)
    rows = np.minimum(woop.shape[0] - tbvh.CHUNK_ROWS * np.arange(boxes.shape[0]),
                      tbvh.CHUNK_ROWS)
    np.testing.assert_array_equal(n_chunks.numpy(), enter.sum(-1))
    np.testing.assert_array_equal(n_rows.numpy(), (enter * rows).sum(-1))
    assert int(n_rows.sum()) <= o.shape[0] * woop.shape[0]
    if name == "caustic":  # the cull skips most of the 99 chunks
        assert float(n_chunks.double().mean()) < 0.5 * boxes.shape[0]


def test_empty_ranges_enter_nothing(tables):
    woop, boxes, tris = tables["caustic"]
    o, d = _rays_for(tables, "caustic", 256)
    t_min = torch.full((o.shape[0],), 0.5)
    t_max = torch.where(torch.arange(o.shape[0]) % 2 == 0, 0.25, 0.5)
    hit, n_chunks, n_rows = ops.cull_sweep(woop, boxes, o, d, t_min, t_max,
                                           verts=tbvh.vertex_rows(tris))
    assert not hit.valid.any() and (n_chunks == 0).all() and (n_rows == 0).all()
    assert torch.equal(hit.t, t_max)


def test_range_arg_scalars_and_per_ray():
    assert ops.range_arg(0.5, 4, "cpu") == (0.5, None)
    assert ops.range_arg(torch.tensor(2.0), 4, "cpu") == (2.0, None)
    assert ops.range_arg(np.float32(np.inf), 4, "cpu") == (np.inf, None)
    v, per_ray = ops.range_arg(torch.arange(4, dtype=torch.float64), 4, "cpu")
    assert v == 0.0 and per_ray.dtype == torch.float32 and per_ray.is_contiguous()
    with pytest.raises(ValueError):
        ops.range_arg(torch.zeros(3), 4, "cpu")
