"""SPPM's volume estimators in the port against the JAX package on the CPU:
two passes on the Cornell box with bench config 4's plume at 16x16, 2^12
photons, with VOL_POINT (ray marching, a 3-D kernel over volume photons),
VOL_BEAM (the camera beam against photon points) and VOL_BEAMBEAM (photon
beams against the camera beam), and the estimators' chunking over camera
rays. test_torch_sppm.py states the tolerances. Alone this file takes about
45 s, most of it JAX compiling the passes.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import pytest
import torch

from cudatracerlib_tpu_torch.render import sppm as tsppm
from test_torch_sppm import SEED, assert_passes_match, cornell_plume  # noqa: F401


@pytest.mark.parametrize("vol_estimator", [tsppm.VOL_POINT, tsppm.VOL_BEAM, tsppm.VOL_BEAMBEAM])
def test_volume_estimator_matches_jax(cornell_plume, vol_estimator):  # noqa: F811
    state, img = assert_passes_match(*cornell_plume, vol_estimator)
    assert float(state.l_other.max()) > 0 and float(img.mean()) > 0


def test_volume_estimate_chunks_equal_one_batch(cornell_plume, monkeypatch):  # noqa: F811
    """The estimators take camera rays VOL_CHUNK at a time; chunks of 37
    rays give the one-batch images bit for bit."""
    _, (ts, tmed) = cornell_plume
    cfg = tsppm.SPPMConfig(n_photons=1 << 11, vol_estimator=tsppm.VOL_BEAMBEAM, vol_steps=8)
    whole, _ = tsppm.render_sppm_pass(ts, 12, 12, SEED, None, cfg, media=tmed)
    monkeypatch.setattr(tsppm, "VOL_CHUNK", 37)
    chunked, _ = tsppm.render_sppm_pass(ts, 12, 12, SEED, None, cfg, media=tmed)
    assert torch.equal(whole, chunked)
