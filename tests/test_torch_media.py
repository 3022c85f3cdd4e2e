"""Phase functions and participating media in the port against the JAX
package on the CPU, both computing on the same tables (the port's Media is
built from the JAX Media's arrays by `convert.media_from_numpy`).

Tolerances, measured on this CPU and stated once:
  * phase functions on 4,096 directions: within 2e-6 relative (+1e-7;
    sampled directions +1e-6, a few ulps of the unit scale, for components
    near 0; a sample's pdf and weight against JAX's at the port's direction,
    which an ulp of it moves by up to 2e-4 where HG peaks or sin vanishes):
    the same float32 operations, the transcendentals an ulp apart;
  * `Media.build`: every array and the mode tuple exactly equal;
  * trilinear lookups: the port's 8-corner gather is bit-equal to JAX's
    8-corner gather path (`_grid_lookup1` with res3=None); JAX runs its
    one-hot contraction for a statically known scalar grid, whose float32
    sums round otherwise: within 4 ulps (3 measured, on 34% of points);
  * `sigma_at`, `le_at`, `density_at`, `transmittance` on 4,096 points and
    rays, in the const, scalar and gen modes and without modes: within
    4e-6 relative (+1e-7 of the values' scale);
  * `sample_distance` lane by lane: the sampler states exactly equal (the
    tracking loop's global trip count T reproduced, with T above one
    block of TRACK_BLOCK trips), the decisions (scatter, volume) equal on
    every lane, t and p within 1e-6 relative, weights and emission within
    4e-6 relative.
Alone this file takes about 25 s, most of it JAX compiling.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.sampling.rng import Sampler as JSampler
from cudatracerlib_tpu.scene import media as jm
from cudatracerlib_tpu.scene import phase as jph
from cudatracerlib_tpu.scene.shapes import cornell_box as jcornell
from cudatracerlib_tpu_torch.convert import flatten, media_from_numpy
from cudatracerlib_tpu_torch.sampling.rng import Sampler as TSampler
from cudatracerlib_tpu_torch.scene import media as tm
from cudatracerlib_tpu_torch.scene import phase as tph

N = 4096
GOLDEN = 0x9E3779B9


def _box():
    js = jcornell()
    return np.asarray(js.bvh.world_min), np.asarray(js.bvh.world_max)


def _rgb_records():
    rng = np.random.default_rng(7)
    return [dict(type=jm.GRID, sigma_a=[0.3, 0.2, 0.1], sigma_s=[0.5, 0.6, 0.7],
                 le=[0.4, 0.3, 0.2], phase_type=jph.HG, phase_g=0.5,
                 box_min=[-0.8, 0.2, 0.1], box_max=[0.7, 1.7, 1.9],
                 sigma_a_grid=rng.uniform(0.2, 1.5, (9, 6, 5)).astype(np.float32),
                 sigma_s_grid=rng.uniform(0.0, 2.0, (9, 6, 5, 3)).astype(np.float32),
                 le_grid=rng.uniform(0.0, 1.0, (9, 6, 5, 3)).astype(np.float32))]


def _overlap_records():
    return [dict(type=jm.HOMOGENEOUS, sigma_a=[0.4, 0.3, 0.2], sigma_s=[0.2, 0.5, 0.3],
                 le=[0.1, 0.0, 0.2], phase_type=jph.RAYLEIGH,
                 box_min=[-0.9, 0.1, 0.1], box_max=[0.4, 1.5, 1.6]),
            dict(type=jm.HOMOGENEOUS, sigma_a=[0.1] * 3, sigma_s=[0.9, 0.8, 0.7],
                 phase_type=jph.HG, phase_g=-0.4,
                 box_min=[-0.2, 0.6, 0.3], box_max=[0.9, 1.9, 1.8])]


CASES = {
    "plume": lambda lo, hi: tm.plume_records(lo, hi),
    "rgb": lambda lo, hi: _rgb_records(),
    "overlap": lambda lo, hi: _overlap_records(),
}
MODE_OF = {"plume": "scalar", "rgb": "gen", "overlap": "const"}


@pytest.fixture(scope="module")
def media():
    lo, hi = _box()
    out = {}
    for name, make in CASES.items():
        j = jm.Media.build(make(lo, hi))
        out[name] = (j, media_from_numpy(flatten(j), device="cpu"))
    return out


def _close(got, want, rtol, err_msg="", atol=1e-7):
    """Within rtol relative plus atol of the values' scale (at least 1)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=atol * max(float(np.abs(want).max()), 1.0), err_msg=err_msg)


def _dirs(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _points_rays(seed):
    lo, hi = _box()
    rng = np.random.default_rng(seed)
    p = rng.uniform(lo - 0.1, hi + 0.1, (N, 3)).astype(np.float32)
    d = _dirs(rng, N)
    t_max = rng.uniform(0.05, 3.5, N).astype(np.float32)
    return p, d, t_max


PHASES = [(jph.ISOTROPIC, 0.3), (jph.RAYLEIGH, 0.3), (jph.KAJIYA_KAY, 0.3)] + [
    (jph.HG, g) for g in (-0.7, 0.0, 0.3, 0.9)]


@pytest.mark.parametrize("ptype,g", PHASES)
def test_phase_matches_jax(ptype, g):
    rng = np.random.default_rng(11)
    wo, wi = _dirs(rng, N), _dirs(rng, N)
    u2 = rng.random((N, 2), dtype=np.float32)
    jt, jg = jnp.full((N,), ptype, jnp.int32), jnp.full((N,), g, jnp.float32)
    tt, tg = torch.full((N,), ptype, dtype=torch.int32), torch.full((N,), g)
    two, twi = torch.from_numpy(wo), torch.from_numpy(wi)
    _close(tph.eval_phase(tt, tg, two, twi), jph.eval_phase(jt, jg, wo, wi), 2e-6, "eval")
    _close(tph.pdf_phase(tt, tg, two, twi), jph.pdf_phase(jt, jg, wo, wi), 2e-6, "pdf")
    js = jph.sample_phase(jt, jg, wo, u2)
    ts = tph.sample_phase(tt, tg, two, torch.from_numpy(u2))
    _close(ts.wi, js.wi, 2e-6, "wi", atol=1e-6)
    # pdf and weight at the port's own direction: an ulp of wi moves HG's
    # pdf near its peak (g 0.9) and Kajiya-Kay's sin near the poles by ~1e-4
    wi = ts.wi.numpy()
    p, pdf = jph.eval_phase(jt, jg, wo, wi), jph.pdf_phase(jt, jg, wo, wi)
    _close(ts.pdf, pdf, 2e-6, "pdf")
    _close(ts.weight, np.asarray(p) / np.maximum(np.asarray(pdf), 1e-12), 2e-6, "weight")


@pytest.mark.parametrize("name", list(CASES))
def test_build_matches_jax(name):
    """`Media.build` from the same records, and `media_from_numpy` from the
    JAX arrays, give JAX's tables and its `static_modes`."""
    lo, hi = _box()
    recs = CASES[name](lo, hi)
    j = jm.Media.build(recs)
    for t in (tm.Media.build(recs, device="cpu"), media_from_numpy(flatten(j), device="cpu")):
        for f in jm.Media._fields:
            want, got = np.asarray(getattr(j, f)), getattr(t, f).numpy()
            assert got.dtype == want.dtype and np.array_equal(got, want), f
        assert t.modes == jm.static_modes(j)
        assert {m[0] for m in t.modes} == {MODE_OF[name]}


def test_build_defaults_to_the_card():
    import inspect

    for fn in (tm.Media.build, tm.Media.empty, tm.from_arrays, media_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_grid_lookup_against_both_jax_paths(media):
    j, t = media["plume"]
    mode = t.modes[0]
    p, _, _ = _points_rays(1)
    got = tm._grid_lookup1(t, 0, mode[1], torch.from_numpy(p)).numpy()
    gather = np.asarray(jm._grid_lookup1(j, 0, mode[1], jnp.asarray(p), None))
    onehot = np.asarray(jm._grid_lookup1(j, 0, mode[1], jnp.asarray(p), mode[3]))
    assert np.array_equal(got, gather)
    assert _ulps(got, onehot).max() <= 4


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("with_modes", [True, False])
def test_lookups_and_transmittance_match_jax(media, name, with_modes):
    j, t = media[name]
    modes = t.modes if with_modes else None
    p, d, t_max = _points_rays(2)
    tp, td, ttm = (torch.from_numpy(x) for x in (p, d, t_max))
    js_, jt_ = jm.sigma_at(j, jnp.asarray(p), modes)
    ts_, tt_ = tm.sigma_at(t, tp, modes)
    _close(ts_, js_, 4e-6, "sigma_s")
    _close(tt_, jt_, 4e-6, "sigma_t")
    assert float(tt_.max()) > 0
    _close(tm.transmittance(t, tp, td, 1e-3, ttm, modes),
           jm.transmittance(j, jnp.asarray(p), jnp.asarray(d), 1e-3, jnp.asarray(t_max), modes),
           4e-6, "transmittance")
    for v in range(t.count):
        jv, tv = jnp.full((N,), v, jnp.int32), torch.full((N,), v, dtype=torch.int64)
        _close(tm.le_at(t, tv, tp), jm.le_at(j, jv, jnp.asarray(p)), 4e-6, f"le_at {v}")
        _close(tm.density_at(t, tv, tp), jm.density_at(j, jv, jnp.asarray(p)), 4e-6,
               f"density_at {v}")
        _close(tm.sigma_t_at(t, tv, tp), jm.sigma_t_at(j, jv, jnp.asarray(p)), 4e-6,
               f"sigma_t_at {v}")


def _trips(state0, state1):
    """The tracking loop's trip count T from the sampler's start and end
    states: (end - start) / GOLDEN draws (mod 2^32), minus the volume draw,
    halved."""
    draws = ((state1 - state0) % (1 << 32)) * pow(GOLDEN, -1, 1 << 32) % (1 << 32)
    assert (draws == draws[0]).all()
    return (int(draws[0]) - 1) // 2


@pytest.mark.parametrize("name,scale", [("plume", 1.0), ("plume", 8.0), ("rgb", 1.0),
                                        ("overlap", 1.0)])
def test_sample_distance_lane_by_lane(name, scale):
    """The plume at 8x its density needs ~28 tracking trips, several host
    blocks; every lane's sampler must still end where JAX's does."""
    lo, hi = _box()
    recs = CASES[name](lo, hi)
    for r in recs:
        r["sigma_a"] = np.asarray(r["sigma_a"], np.float32) * scale
        r["sigma_s"] = np.asarray(r["sigma_s"], np.float32) * scale
    j = jm.Media.build(recs)
    t = media_from_numpy(flatten(j), device="cpu")
    p, d, t_max = _points_rays(3)
    pid = np.arange(N, dtype=np.uint32)
    js = JSampler.create(jnp.uint32(5), jnp.asarray(pid), jnp.uint32(0))
    ts = TSampler.create(5, torch.from_numpy(pid.astype(np.int64)), 0)
    want = jm.sample_distance(j, jnp.asarray(p), jnp.asarray(d), 1e-3, jnp.asarray(t_max), js,
                              modes=t.modes)
    got = tm.sample_distance(t, *(torch.from_numpy(x) for x in (p, d)), 1e-3,
                             torch.from_numpy(t_max), ts, modes=t.modes)
    s0 = np.asarray(js.state).astype(np.int64)
    np.testing.assert_array_equal(got[0].state.numpy(), np.asarray(want[0].state).astype(np.int64))
    trips = _trips(s0, got[0].state.numpy())
    if scale > 1:
        assert trips > tm.TRACK_BLOCK, trips
    for i, (n, rtol) in enumerate([("t", 1e-6), ("scatter", 0), ("weight", 4e-6), ("vid", 0),
                                   ("p", 1e-6), ("emit", 4e-6)], start=1):
        w = np.asarray(want[i])
        if rtol == 0:
            np.testing.assert_array_equal(got[i].numpy(), w, err_msg=n)
        else:
            _close(got[i], w, rtol, n)
    assert 0 < float(got[2].float().mean()) < 1
