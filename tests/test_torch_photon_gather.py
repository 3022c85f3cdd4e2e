"""The photon lookups of the PPM slice against the JAX package, on the CPU:
the hash grid (build and capped query), the photon tiles, and the plain
version of the photon-major density kernel.

Inputs are made with numpy from seeds. Tolerances:
  * grid arrays, capped query results and photon tiles exactly equal: both
    packages sort stably by the same float32 cell ids;
  * `photon_density_plain` against an exhaustive float64 numpy sum within
    1e-5 relative (+1e-6 absolute): the per-pair weights agree to float32
    rounding, the sums differ by their float32 rounding;
  * against JAX's `photon_density_tpu` run in interpret mode on the same
    tiles within 1e-4 relative (+1e-4 of the largest sum): that kernel
    splits flux and weights into bf16 hi/lo pairs and expands d^2 as
    |p|^2 + |q|^2 - 2 p.q (2.9e-5 measured on a cloud of this size).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cudatracerlib_tpu.accel import hashgrid as jhg
from cudatracerlib_tpu.ops import photon_gather as jpg
from cudatracerlib_tpu_torch.accel import hashgrid as thg
from cudatracerlib_tpu_torch.ops import photon_gather as tpg

RES = 14          # cells of 1/14 >= the radius over the unit box
RADIUS = 0.07
BOX = (np.zeros(3, np.float32), np.ones(3, np.float32))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _photons(seed, n, hotspot=False):
    """Photons on the floor (z = 0, n = +z) and a wall (x = 0, n = +x) of
    the unit box, with exact duplicates (ties), positions on cell faces,
    10% invalid, and incoming directions on both sides of the surface. With
    `hotspot` they crowd within 0.02 of one floor point."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    n_floor = (2 * n) // 3
    pos[:n_floor, 2] = 0.0
    pos[n_floor:, 0] = 0.0
    if hotspot:
        pos[:n_floor, :2] = 0.5 + rng.uniform(-0.02, 0.02, (n_floor, 2)).astype(np.float32)
    pos[10:40] = pos[40:70]                           # exact ties
    pos[70:90, 1] = np.float32(5.0 / RES)             # on a cell face
    normal = np.zeros((n, 3), np.float32)
    normal[:n_floor, 2] = 1.0
    normal[n_floor:, 0] = 1.0
    wi = _unit(rng.normal(size=(n, 3)).astype(np.float32) + 1.5 * normal)
    power = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    valid = rng.random(n) >= 0.1
    return pos, power, normal, wi, valid


def _queries(seed, n, hotspot=False):
    """Gather queries on the floor, cell-sorted as the eye pass sorts them,
    10% invalid; the first block of 256 lies far from every photon."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    q[:, 2] = 0.0
    if hotspot:
        q[:, :2] = 0.5 + rng.uniform(-0.02, 0.02, (n, 2)).astype(np.float32)
    qn = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    valid = rng.random(n) >= 0.1
    inv_cell = RES / (BOX[1] - BOX[0])
    cid = thg.cell_index(_t(BOX[0]), _t(inv_cell), RES, _t(q)).numpy()
    order = np.argsort(np.where(valid, cid, RES ** 3), kind="stable")
    q, qn, valid = q[order], qn[order], valid[order]
    if not hotspot:
        q[:256, :2] += 7.0     # a block no tile reaches
    return q, qn, valid


def _exhaustive(pos, power, normal, wi, valid, q, qn, qv, radius):
    """[sum w * flux, sum w] per query in float64 over every valid photon."""
    p, pw, pn, pwi = (x[valid].astype(np.float64) for x in (pos, power, normal, wi))
    d2 = ((q[:, None, :].astype(np.float64) - p[None]) ** 2).sum(-1)
    w = np.maximum(1.0 - d2 / np.float64(np.float32(radius)) ** 2, 0.0)
    w = np.where(qn.astype(np.float64) @ pn.T > 0.7, w, 0.0)
    w = np.where(qn.astype(np.float64) @ pwi.T >= 0.0, w, 0.0)
    w = np.where(qv[:, None], w, 0.0)
    return w @ pw, w.sum(1)


def _tiles(ph):
    pos, power, normal, wi, valid = ph
    return tpg.build_photon_tiles(_t(pos), _t(power), _t(normal), _t(valid), BOX[0], BOX[1],
                                  RES, wi=_t(wi))


@pytest.mark.parametrize("n", [3000, 512, 7], ids=["cloud", "one-tile", "tiny"])
def test_build_photon_tiles_exactly_equal(n):
    ph = _photons(n, n)
    tiles, aabbs = _tiles(ph)
    pos, power, normal, wi, valid = (jnp.asarray(x) for x in ph)
    jt, ja = jpg.build_photon_tiles(pos, power, normal, valid, BOX[0], BOX[1], RES, wi=wi)
    assert tiles.shape == (-(-n // tpg.PT), 16, tpg.PT) and aabbs.shape == (tiles.shape[0], 8)
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(aabbs.numpy(), np.asarray(ja))
    assert (tpg.BQ, tpg.PT, tpg.FAR, tpg.NORMAL_MIN_DOT) == (jpg.BQ, jpg.PT, jpg.FAR,
                                                             jpg.NORMAL_MIN_DOT)


CASES = {"cloud": (3000, 1200, False), "hotspot": (2000, 300, True)}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    n_ph, n_q, hot = CASES[request.param]
    ph = _photons(1, n_ph, hot)
    qs = _queries(2, n_q, hot)
    return request.param, ph, qs


def test_density_plain_matches_exhaustive_sum(case):
    name, ph, (q, qn, qv) = case
    tiles, aabbs = _tiles(ph)
    flux, sw = tpg.photon_density_plain(tiles, aabbs, _t(q), _t(qn), _t(qv), RADIUS)
    ref_flux, ref_w = _exhaustive(*ph, q, qn, qv, RADIUS)
    np.testing.assert_allclose(flux.numpy(), ref_flux, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sw.numpy(), ref_w, rtol=1e-5, atol=1e-6)
    assert (sw.numpy()[~qv] == 0).all() and (flux.numpy()[~qv] == 0).all()
    if name == "hotspot":
        # every valid query sees far more than the query-major cap of 128
        p, pn = ph[0][ph[4]], ph[2][ph[4]]
        near = ((q[:, None] - p[None]) ** 2).sum(-1) < np.float32(RADIUS) ** 2
        assert (near & (pn[None, :, 2] > 0.7)).sum(1)[qv].min() > 128
    else:
        # the far block culls every tile and returns 0
        keep = tpg.block_cull(aabbs, _t(q), _t(qv), RADIUS)
        assert not keep[0].any() and keep.any()
        assert (sw.numpy()[:256] == 0).all() and (ref_w[256:][qv[256:]] > 0).mean() > 0.5


def test_density_plain_matches_jax_interpret_kernel(case):
    _, ph, (q, qn, qv) = case
    tiles, aabbs = _tiles(ph)
    flux, sw = tpg.photon_density_plain(tiles, aabbs, _t(q), _t(qn), _t(qv), RADIUS)
    with pltpu.force_tpu_interpret_mode():
        jf, jw = jpg.photon_density_tpu(jnp.asarray(tiles.numpy()), jnp.asarray(aabbs.numpy()),
                                        jnp.asarray(q), jnp.asarray(qn), jnp.asarray(qv),
                                        jnp.float32(RADIUS))
    # valid queries only: the TPU kernel leaves an invalid query's sums
    # undefined (its +-FAR position meets the FAR padding photons of the
    # tiles its block keeps), where the port writes 0
    jf, jw = np.asarray(jf)[qv], np.asarray(jw)[qv]
    np.testing.assert_allclose(flux.numpy()[qv], jf, rtol=1e-4, atol=1e-4 * np.abs(jf).max())
    np.testing.assert_allclose(sw.numpy()[qv], jw, rtol=1e-4, atol=1e-4 * np.abs(jw).max())


def test_density_cpu_wrapper_takes_plain_and_counts_no_launch(case):
    _, ph, (q, qn, qv) = case
    tiles, aabbs = _tiles(ph)
    before = dict(tpg.launches)
    got = tpg.photon_density(tiles, aabbs, _t(q), _t(qn), _t(qv), RADIUS)
    want = tpg.photon_density_plain(tiles, aabbs, _t(q), _t(qn), _t(qv), RADIUS)
    assert tpg.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    pairs = tpg.surviving_pairs(aabbs, _t(q), _t(qv), RADIUS)
    assert pairs % tpg.PT == 0 and 0 < pairs <= int(qv.sum()) * tiles.shape[0] * tpg.PT
    with pytest.raises(TypeError):
        tpg.photon_density(tiles, aabbs, _t(q).double(), _t(qn), _t(qv), RADIUS)
    with pytest.raises(TypeError):
        tpg.photon_density(tiles, aabbs, _t(q), _t(qn), _t(qv).int(), RADIUS)
    with pytest.raises(ValueError):
        tpg.photon_density(tiles[:, :8], aabbs, _t(q), _t(qn), _t(qv), RADIUS)


def _grid_cloud():
    """Points with ties and points on cell faces, 15% invalid, dense enough
    that most queries overflow a cap of 16."""
    rng = np.random.default_rng(7)
    pts = rng.uniform(0.0, 1.0, (4000, 3)).astype(np.float32)
    pts[100:400] = pts[400:700]
    pts[700:800, 0] = np.float32(3.0 / 8.0)
    valid = rng.random(4000) >= 0.15
    centers = rng.uniform(-0.1, 1.1, (500, 3)).astype(np.float32)
    return pts, valid, centers


def test_hashgrid_build_and_capped_query_exactly_equal():
    pts, valid, centers = _grid_cloud()
    res, K = 8, 16
    jg = jhg.build_grid(jnp.asarray(pts), BOX[0], BOX[1], res, valid=jnp.asarray(valid))
    tg = thg.build_grid(_t(pts), BOX[0], BOX[1], res, valid=_t(valid))
    for f in ("order", "cell_start", "cell_of", "box_min", "inv_cell"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)),
                                      err_msg=f)
    ji, jv = jhg.query_sphere(jg, jnp.asarray(centers), 0.1, K)
    ti, tv = thg.query_sphere(tg, _t(centers), 0.1, K)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tv.all(1).float().mean() > 0.5 and not tv.all()            # overflow and short lists
    assert valid[ti.numpy()[tv.numpy()]].all()                 # invalid points never return
    c = _t(centers)
    np.testing.assert_array_equal(
        thg.cell_index(tg.box_min, tg.inv_cell, res, c).numpy(),
        np.asarray(jhg.cell_index(jg.box_min, jg.inv_cell, res, jnp.asarray(centers))))
