"""Dense intersector parity: the port's plain version (what `intersect_dense`
runs for CPU tensors) against the JAX package's Pallas `intersect_dense` in
interpret mode and against its `intersect_brute_force`, on the triangle
soups of test_pallas.py and on the Cornell box.

Tolerances: `valid` equal on every ray; `prim` equal, or pointing at
identical Woop rows (leaf padding duplicates triangles); t and the
barycentrics within 1e-5 (relative and absolute) on valid rays. The Pallas
kernel evaluates u, v in another order than `intersect_woop`, hence not
bit-exact; misses are compared only through `valid`, since the dense path
clamps t_max to 1e30 where the brute force keeps inf.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cudatracerlib_tpu.accel import traversal as jtrav
from cudatracerlib_tpu.accel.bvh import build_bvh as jbuild_bvh
from cudatracerlib_tpu.ops.intersect_pallas import intersect_dense as jdense
from cudatracerlib_tpu.scene.shapes import cornell_box as jcornell
from cudatracerlib_tpu_torch.accel import traversal as ttrav
from cudatracerlib_tpu_torch.accel.bvh import vertex_rows
from cudatracerlib_tpu_torch.ops import intersect_dense as tops
from test_pallas import _rays, _scene_tris

TOL = 1e-5


def _soup(n_spheres, seed):
    tris = _scene_tris(n_spheres=n_spheres, seed=seed)
    return tris, jbuild_bvh(tris)


def _verts(tris, bvh):
    """The vertex rows of a JAX BVH's Woop rows (leaf order, padding included)."""
    return vertex_rows(torch.from_numpy(tris[np.asarray(bvh.tri_index)]))


@pytest.fixture(scope="module")
def soups():
    return {"soup2": _soup(2, 7), "soup4": _soup(4, 3)}


@pytest.fixture(scope="module")
def cornell_rays():
    """Cornell's woop table and rays from inside the box toward random
    directions plus rays from the camera through the box."""
    scene = jcornell()
    rng = np.random.default_rng(21)
    n = 2048
    o = np.concatenate([rng.uniform([-0.9, 0.1, 0.1], [0.9, 1.9, 1.9], (n, 3)),
                        np.tile([[0.0, -3.25, 1.0]], (n, 1))]).astype(np.float32)
    d = np.concatenate([rng.normal(size=(n, 3)),
                        np.stack([rng.uniform(-0.35, 0.35, n), np.ones(n),
                                  rng.uniform(-0.35, 0.35, n)], -1)]).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return scene.bvh, np.asarray(scene.shading.verts), jnp.asarray(o), jnp.asarray(d)


def _tt(x):
    return torch.from_numpy(np.array(x))


def _port(bvh, tris, o, d, **kw):
    """The port's dense wrapper on a JAX BVH's Woop rows; `tris` are the
    scene's (T, 3, 3) triangles, indexed by the BVH's tri_index."""
    return tops.intersect_dense(_tt(bvh.woop), _tt(o), _tt(d), verts=_verts(tris, bvh), **kw)


def _assert_parity(port, ref, woop):
    woop = np.asarray(woop)
    pv, rv = port.valid.numpy(), np.asarray(ref.valid)
    assert (pv == rv).all(), f"valid differs on {(pv != rv).sum()} rays"
    pp, rp = port.prim.numpy(), np.asarray(ref.prim)
    assert (pp[~pv] == -1).all()
    diff = pv & (pp != rp)
    assert (woop[pp[diff]] == woop[rp[diff]]).all(), "prim differs at distinct woop rows"
    np.testing.assert_allclose(port.t.numpy()[pv], np.asarray(ref.t)[pv], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(port.bary.numpy()[pv], np.asarray(ref.bary)[pv],
                               rtol=TOL, atol=TOL)
    return int(pv.sum())


CASES = {
    "closest": dict(),
    "finite_tmax": dict(t_max=2.0),
    "any_hit": dict(t_max=2.0, any_hit=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("soup", ["soup2", "soup4"])
def test_plain_vs_pallas_interpret(soups, soup, case):
    tris, bvh = soups[soup]
    o, d = _rays(tris, 512, seed=11)
    kw = CASES[case]
    with pltpu.force_tpu_interpret_mode():
        ref = jdense(bvh, o, d, **kw)
    port = _port(bvh, tris, o, d, **kw)
    if kw.get("any_hit"):
        assert (port.valid.numpy() == np.asarray(ref.valid)).all()
    else:
        assert _assert_parity(port, ref, bvh.woop) > 50


@pytest.mark.parametrize("case", ["closest", "finite_tmax"])
@pytest.mark.parametrize("soup", ["soup2", "soup4"])
def test_plain_vs_brute_force(soups, soup, case):
    tris, bvh = soups[soup]
    o, d = _rays(tris, 1024, seed=13)
    kw = CASES[case]
    ref = jtrav.intersect_brute_force(bvh, o, d, **kw)
    assert _assert_parity(_port(bvh, tris, o, d, **kw), ref, bvh.woop) > 50
    # the traversal-level brute force is the same sweep without the 1e30 clamp
    port_bf = ttrav.intersect_brute_force(_tt(bvh.woop), _tt(o), _tt(d), **kw,
                                          verts=_verts(tris, bvh))
    np.testing.assert_array_equal(port_bf.prim.numpy(), np.asarray(ref.prim))
    np.testing.assert_array_equal(port_bf.t.numpy(), np.asarray(ref.t))


@pytest.mark.parametrize("case", sorted(CASES))
def test_cornell_plain_vs_pallas_and_brute_force(cornell_rays, case):
    bvh, verts, o, d = cornell_rays
    kw = CASES[case]
    with pltpu.force_tpu_interpret_mode():
        ref = jdense(bvh, o, d, **kw)
    port = tops.intersect_dense(_tt(bvh.woop), _tt(o), _tt(d), verts=vertex_rows(_tt(verts)), **kw)
    bf = jtrav.intersect_brute_force(bvh, o, d, t_max=kw.get("t_max", jnp.inf))
    if kw.get("any_hit"):
        assert (port.valid.numpy() == np.asarray(ref.valid)).all()
        assert (port.valid.numpy() == np.asarray(bf.valid)).all()
    else:
        assert _assert_parity(port, ref, bvh.woop) > 1000
        # same arithmetic as intersect_woop: bit-equal hits
        np.testing.assert_array_equal(port.prim.numpy(), np.asarray(bf.prim))
        np.testing.assert_array_equal(port.t.numpy()[port.valid.numpy()],
                                      np.asarray(bf.t)[np.asarray(bf.valid)])


def test_per_ray_range_bounds(soups):
    tris, bvh = soups["soup2"]
    o, d = _rays(tris, 512, seed=17)
    t_max = np.random.default_rng(3).uniform(0.5, 6.0, 512).astype(np.float32)
    t_min = np.full(512, 0.05, np.float32)
    ref = jtrav.intersect_brute_force(bvh, o, d, jnp.asarray(t_min), jnp.asarray(t_max))
    port = _port(bvh, tris, o, d, t_min=torch.from_numpy(t_min), t_max=torch.from_numpy(t_max))
    assert _assert_parity(port, ref, bvh.woop) > 50
    assert (port.t.numpy()[~port.valid.numpy()] == t_max[~port.valid.numpy()]).all()


def test_wrapper_cpu_takes_plain_version_and_counts_no_launch(soups):
    tris, bvh = soups["soup2"]
    o, d = _rays(tris, 256, seed=19)
    before = dict(tops.launches)
    woop, to, td = (_tt(x) for x in (bvh.woop, o, d))
    verts = _verts(tris, bvh)
    a = tops.intersect_dense(woop, to, td, any_hit=True, verts=verts)
    b = tops.intersect_dense_plain(woop, to, td, verts=verts)
    assert tops.launches == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a.prim.dtype == torch.int32 and a.t.dtype == torch.float32
    assert (a.t[~a.valid] == 1e30).all()


def test_wrapper_rejects_bad_inputs():
    woop = verts = torch.zeros(4, 12)
    o = torch.zeros(8, 3)
    with pytest.raises(ValueError):
        tops.intersect_dense(torch.zeros(4, 9), o, o, verts=verts)
    with pytest.raises(ValueError):
        tops.intersect_dense(woop, o, o, verts=torch.zeros(5, 12))
    with pytest.raises(ValueError):
        tops.intersect_dense(woop, torch.zeros(8, 4), torch.zeros(8, 4), verts=verts)
    with pytest.raises(TypeError):
        tops.intersect_dense(woop.double(), o, o, verts=verts)
    with pytest.raises(ValueError):
        tops.intersect_dense(woop.to("meta"), o.to("meta"), o.to("meta"), verts=verts.to("meta"))


def test_dispatch_above_dense_band_is_not_ported():
    """Above the dense band the dispatch used to raise; it now walks the
    BVH: for CPU tensors through the plain version, the oracle `intersect`,
    whose hits it returns unchanged. Other devices are refused."""
    from cudatracerlib_tpu_torch.accel.bvh import build_bvh
    from cudatracerlib_tpu_torch.scene.shapes import sphere

    bvh = build_bvh(sphere([0, 0, 0], 1.0, n_theta=48, n_phi=48), device="cpu")
    assert bvh.woop.shape[0] > ttrav.DENSE_MAX_TRIS
    rng = np.random.default_rng(4)
    o = torch.from_numpy(rng.uniform(-2, 2, (256, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(scale=0.3, size=(256, 3)).astype(np.float32)) - o, dim=-1)
    got = ttrav.intersect_auto(bvh, o, d)
    want = ttrav.intersect(bvh, o, d)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got.valid.float().mean() > 0.5
    with pytest.raises(ValueError):
        ttrav.intersect_auto(bvh.to("meta"), o.to("meta"), d.to("meta"))
