"""SPPM (stochastic progressive photon mapping) in the port against the JAX
package on the CPU: the Cornell box, bench config 4's plume in it and the
caustic scene, built from the JAX package's arrays (`scene_from_numpy`,
`media_from_numpy`), so both compute on the same tables. This file holds
the hash grid's subsampled query, the media-aware photon walk, the surface
passes (constant radius, kNN radii, final gathering) and `sppm_develop`;
test_torch_sppm_vol.py holds the three volume estimators, with this file's
helpers.

Tolerances, measured on this CPU and stated once:
  * `query_sphere_sampled`: indices, validity and weights exactly equal;
  * `trace_photons_vol` (2^12 photons, seed 5, depth 6): validity masks
    exactly equal; on valid slots positions, directions, powers and beam
    lengths within 1e-5 relative, plus 1e-4 absolute on positions and
    lengths, 1e-5 on directions, 1e-6 on powers (measured: 7.8e-5 on 13 of
    73,728 coordinates, as the PPM photon pass): the same draws, the delta
    tracking's trip count included, the same float32 operations;
  * two passes of `render_sppm_pass` (16x16, 2^12 photons, seed 5): r2 and
    n_acc within 1e-5 relative (measured equal), tau and l_other within 1e-3
    relative + 1e-5 of the field's largest entry, and each pass's image
    within the same (measured: 2.9e-6 relative at worst on the surface
    passes; VOL_BEAM 2.2e-4 at one pixel, where a photon lying on a camera
    step's cell boundary an ulp moves is counted in the other step); the
    image means within 1e-5 relative.
Alone this file takes about 30 s, most of it JAX compiling the passes.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.accel import hashgrid as jhg
from cudatracerlib_tpu.render import sppm as jsppm
from cudatracerlib_tpu.render.path_tracer import PTConfig as JPTConfig
from cudatracerlib_tpu.render.path_tracer import specialize_config as jspecialize
from cudatracerlib_tpu.scene import media as jm
from cudatracerlib_tpu.scene.shapes import caustic_scene as jcaustic
from cudatracerlib_tpu.scene.shapes import cornell_box as jcornell
from cudatracerlib_tpu_torch.accel import hashgrid as thg
from cudatracerlib_tpu_torch.convert import flatten, media_from_numpy, scene_from_numpy
from cudatracerlib_tpu_torch.render import path_tracer as tpt
from cudatracerlib_tpu_torch.render import sppm as tsppm
from cudatracerlib_tpu_torch.scene import media as tm

N_PHOTONS, SIZE, SEED = 1 << 12, 16, 5
RTOL, FIELD_FRAC = 1e-3, 1e-5
# trace_photons_vol, absolute part of each field's tolerance: positions as
# tests/test_torch_ppm.py's photon pass states (an ulp of a hit distance
# grows at grazing bounces), directions 1e-5, the rest 1e-6
ATOL = {"p": 1e-4, "o": 1e-4, "t": 1e-4, "wi": 1e-5, "d": 1e-5, "n": 1e-5}


@pytest.fixture(scope="module")
def cornell_plume():
    """((JAX scene, JAX media), (port scene, port media)): the Cornell box
    with bench config 4's plume."""
    js = jcornell()
    jmed = jm.Media.build(tm.plume_records(np.asarray(js.bvh.world_min),
                                           np.asarray(js.bvh.world_max)))
    return ((js, jmed), (scene_from_numpy(flatten(js), device="cpu"),
                         media_from_numpy(flatten(jmed), device="cpu")))


def assert_passes_match(jax_pair, port_pair, vol_estimator, passes=2, **kw):
    """`passes` SPPM passes on both packages from a fresh state; states and
    images compared after each."""
    (js, jmed), (ts, tmed) = jax_pair, port_pair
    jcfg = jsppm.SPPMConfig(n_photons=N_PHOTONS, vol_estimator=vol_estimator, **kw)
    tcfg = tsppm.SPPMConfig(n_photons=N_PHOTONS, vol_estimator=vol_estimator, **kw)
    jstate = tstate = None
    for _ in range(passes):
        jimg, jstate = jsppm.render_sppm_pass(js, SIZE, SIZE, SEED, jstate, jcfg, media=jmed)
        timg, tstate = tsppm.render_sppm_pass(ts, SIZE, SIZE, SEED, tstate, tcfg, media=tmed)
        for name in ("r2", "n_acc"):
            np.testing.assert_allclose(getattr(tstate, name).numpy(),
                                       np.asarray(getattr(jstate, name)), rtol=1e-5, err_msg=name)
        for name, got, want in (("tau", tstate.tau, jstate.tau),
                                ("l_other", tstate.l_other, jstate.l_other),
                                ("image", timg, jimg)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                       atol=FIELD_FRAC * np.abs(want).max(), err_msg=name)
        assert int(tstate.n_passes) == int(jstate.n_passes)
        want_mean = float(np.asarray(jimg).mean())
        assert abs(float(timg.mean()) - want_mean) <= 1e-5 * abs(want_mean)
    assert torch.isfinite(timg).all() and timg.shape == (SIZE, SIZE, 3)
    return tstate, timg


def test_query_sphere_sampled_matches_jax():
    rng = np.random.default_rng(11)
    pts = rng.uniform(0.0, 1.0, (6000, 3)).astype(np.float32)
    pts[:2000] = 0.5 + 0.02 * rng.standard_normal((2000, 3)).astype(np.float32)  # a hot cell
    valid = rng.random(6000) > 0.1
    centers = rng.uniform(-0.05, 1.05, (700, 3)).astype(np.float32)
    centers[:50] = 0.5
    jg = jhg.build_grid(jnp.asarray(pts), [0, 0, 0], [1, 1, 1], 12, valid=jnp.asarray(valid))
    tg = thg.build_grid(torch.from_numpy(pts), [0, 0, 0], [1, 1, 1], 12,
                        valid=torch.from_numpy(valid))
    for K in (8, 32):
        want = jhg.query_sphere_sampled(jg, jnp.asarray(centers), K)
        got = thg.query_sphere_sampled(tg, torch.from_numpy(centers), K)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        assert float(got[2].max()) > 1.0 and bool(got[1].any())  # the hot cell is subsampled
    # the capped query keeps its results under the shared helpers
    want = jhg.query_sphere(jg, jnp.asarray(centers), 0.05, 32)
    got = thg.query_sphere(tg, torch.from_numpy(centers), 0.05, 32)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_trace_photons_vol_matches_jax(cornell_plume):
    (js, jmed), (ts, tmed) = cornell_plume
    jcfg = jspecialize(js, JPTConfig(max_depth=6, rr_start=2))
    tcfg = tpt.specialize_config(ts, tpt.PTConfig(max_depth=6, rr_start=2))
    want = jsppm.trace_photons_vol(js, jmed, N_PHOTONS, jnp.uint32(SEED), jcfg, with_beams=True)
    got = tsppm.trace_photons_vol(ts, tmed, N_PHOTONS, SEED, tcfg, with_beams=True)
    for w_map, g_map in zip(want, got):
        assert type(g_map).__name__ == type(w_map).__name__
        np.testing.assert_array_equal(g_map.valid.numpy(), np.asarray(w_map.valid))
        v = g_map.valid.numpy()
        assert v.any()
        for field in g_map._fields:
            g, w = getattr(g_map, field).numpy()[v], np.asarray(getattr(w_map, field))[v]
            if w.dtype == bool:
                np.testing.assert_array_equal(g, w, err_msg=field)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=ATOL.get(field, 1e-6),
                                           err_msg=field)


def test_surface_passes_match_jax(cornell_plume):
    """VOL_NONE: the media are left out, as in the JAX package."""
    state, _ = assert_passes_match(*cornell_plume, tsppm.VOL_NONE)
    assert float(state.n_acc.max()) > 0 and float(state.r2.min()) < 0.07 ** 2


def test_knn_radii_match_jax(cornell_plume):
    state, _ = assert_passes_match(*cornell_plume, tsppm.VOL_NONE, knn_target=8)
    assert float(state.r2.max()) > 0.07 ** 2 * 1.01  # some first-pass radii grew


def test_final_gather_matches_jax(cornell_plume):
    state, _ = assert_passes_match(*cornell_plume, tsppm.VOL_NONE, final_gather=True)
    assert float(state.n_acc.max()) == 0 and float(state.l_other.max()) > 0


def test_caustic_scene_pass_matches_jax():
    """The caustic scene: the shade pack's band (3,160 rows), photons
    through the DIELECTRIC sphere."""
    js = jcaustic()
    assert_passes_match((js, None), (scene_from_numpy(flatten(js), device="cpu"), None),
                        tsppm.VOL_NONE, passes=1)


def test_sppm_develop():
    state = tsppm.SPPMState(r2=torch.tensor([0.01, 0.04, 1e-20, 0.02]),
                            n_acc=torch.zeros(4), tau=torch.arange(12.0).reshape(4, 3),
                            l_other=torch.full((4, 3), 2.0),
                            n_passes=torch.tensor(2, dtype=torch.int64))
    jstate = jsppm.SPPMState(*(jnp.asarray(x.numpy()) for x in state[:4]),
                             n_passes=jnp.int32(2))
    got = tsppm.sppm_develop(state, 2, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(jsppm.sppm_develop(jstate, 2, 2)),
                               rtol=1e-6)
    fresh = tsppm.sppm_init(4, 0.07, device="cpu")
    assert torch.equal(tsppm.sppm_develop(fresh, 2, 2), torch.zeros(2, 2, 3))
