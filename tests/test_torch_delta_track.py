"""Delta tracking's per-lane formulation, which the CUDA kernel of
ops/delta_track runs (a thread a lane), against the batch eager loop of
scene/media.py on the CPU.

The kernel rests on one fact: the batch loop's trip k draws at every lane's
start state + (2k + 1) and (2k + 2) Weyl steps, and a stopped lane ignores its
draws, so each lane can run its own trips from its own start, and T, the
number of trips the batch runs while any lane tracks, is the largest count
of trips a lane began while tracking. `_per_lane` below writes that in plain
PyTorch, one lane's trip at a time in each lane's own count (only the lanes
still tracking are looked up); it must equal the eager loop bit for bit: t,
real, T and the sampler after the trips. The kernel's own arithmetic is held
to the eager loop on the card (tests/test_torch_cuda.py).
"""
from types import SimpleNamespace

import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import numpy as np
import pytest
import torch

from cudatracerlib_tpu_torch.ops import delta_track as dt_op
from cudatracerlib_tpu_torch.sampling.rng import MASK, Sampler, pcg_hash, uint_to_unit_float
from cudatracerlib_tpu_torch.scene import media as tm
from cudatracerlib_tpu_torch.utils.timing import counters, reset_counters

N = 2048
GOLDEN = 0x9E3779B9
BOX = ([-1.0, -1.0, -1.0], [1.0, 1.0, 1.0])


def _plume(scale=1.0, extra=()):
    recs = tm.plume_records(np.array(BOX[0]), np.array(BOX[1]), res=16)
    for r in recs:
        r["sigma_a"] = np.asarray(r["sigma_a"], np.float32) * scale
        r["sigma_s"] = np.asarray(r["sigma_s"], np.float32) * scale
    return tm.Media.build(recs + list(extra), device="cpu")


def _rays(seed, n=N, miss=False):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if miss:  # far outside the box, pointing away from it
        o = np.abs(o) + 3.0
        d = np.abs(d)
    t_max = rng.uniform(0.5, 4.0, n).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max)


def _track_inputs(media, seed, miss=False):
    """The arguments `sample_distance` hands `delta_track` for seeded rays."""
    o, d, t_max = _rays(seed, miss=miss)
    seen, real = [], tm.delta_track

    def record(*args):
        seen.append(args)
        return real(*args)

    tm.delta_track = record
    try:
        tm.sample_distance(media, o, d, 1e-3, t_max,
                           Sampler.create(seed, torch.arange(N, dtype=torch.int64), 0),
                           modes=media.modes)
    finally:
        tm.delta_track = real
    (args,) = seen
    return list(args)


def _draw(state, k):
    """Draw k (from 1) of each lane's sampler: its start + k Weyl steps."""
    return uint_to_unit_float(pcg_hash((state + k * GOLDEN) & MASK))


def _per_lane(media, modes, o, d, u_near, u_far, maj, in_vol, state):
    """(t, real, T): each lane's trips from its own start, trip k of a lane
    drawing its start's draws 2k + 1 and 2k + 2; T the largest count."""
    t, real = u_near.clone(), torch.zeros_like(in_vol)
    trips = torch.zeros(o.shape[0], dtype=torch.int64)
    tracking = in_vol.clone()
    while bool(tracking.any()):
        i = tracking.nonzero().squeeze(1)
        k = trips[i]
        trips[i] = k + 1
        u = _draw(state[i], 2 * k + 1)
        t_new = t[i] + -torch.log(torch.clamp(1.0 - u, min=1e-12)) / maj[i]
        go = ~(t_new >= u_far[i])
        _, st = tm.sigma_at(media, o[i] + d[i] * t_new[:, None], modes)
        ratio = torch.clamp(st.mean(-1) / maj[i], 0.0, 1.0)
        hit = go & (_draw(state[i], 2 * k + 2) < ratio)
        t[i] = torch.where(go, t_new, t[i])
        real[i] = hit
        tracking[i] = go & ~hit & (trips[i] < tm.HARD_TRACK_CAP)
    return t, real, trips.max()


def _at_cap(args):
    """Lane 0 of the lanes in the volume under a majorant so large that its
    steps do not move t and its collisions have probability ~0: it tracks
    for HARD_TRACK_CAP trips."""
    lane = int(args[7].nonzero()[0, 0])
    args[6] = args[6].clone()
    args[6][lane] = 1e30
    return args


CASES = {
    "plume_seed3": lambda: _track_inputs(_plume(), 3),
    "plume_seed4": lambda: _track_inputs(_plume(), 4),
    "plume_seed5": lambda: _track_inputs(_plume(), 5),
    "plume_x8": lambda: _track_inputs(_plume(8.0), 6),
    "outside": lambda: _track_inputs(_plume(), 7, miss=True),
    "cap": lambda: _at_cap(_track_inputs(_plume(), 8)),
    "scalar_and_const": lambda: _track_inputs(_plume(extra=[dict(
        type=tm.HOMOGENEOUS, sigma_a=[0.4, 0.3, 0.2], sigma_s=[0.2, 0.5, 0.3],
        box_min=[-0.5, 0.0, -1.2], box_max=[1.3, 1.1, 0.4])]), 9),
}


@pytest.mark.parametrize("case", list(CASES))
def test_per_lane_trips_equal_the_batch_loop(case):
    args = CASES[case]()
    media, modes, state = args[0], args[1], args[8]
    reset_counters()
    t, real, T = tm.delta_track(*args)
    assert counters()["media.track.eager"] == 1
    t_l, real_l, T_l = _per_lane(*args)
    assert torch.equal(t_l, t) and torch.equal(real_l, real)
    assert int(T_l) == int(T)
    assert torch.equal(Sampler(state).skip(2 * T_l).state, Sampler(state).skip(2 * T).state)
    in_vol = args[7]
    if case == "outside":
        assert not bool(in_vol.any()) and int(T) == 0
        return
    assert bool(real.any()) and bool((in_vol & ~real).any())
    if case == "plume_x8":
        assert int(T) > tm.TRACK_BLOCK
    if case == "cap":
        assert int(T) == tm.HARD_TRACK_CAP
    if case == "scalar_and_const":
        assert [m[0] for m in modes] == ["scalar", "const"]


def test_the_kernel_takes_cuda_tensors_of_scalar_and_const_volumes():
    cuda = SimpleNamespace(device=torch.device("cuda"))
    cpu = torch.zeros(1, 3)
    mixed = _plume(extra=[dict(type=tm.HOMOGENEOUS)])
    rng = np.random.default_rng(1)
    gen = tm.Media.build([dict(type=tm.GRID, sigma_a_grid=rng.random((4, 4, 4)).astype(np.float32),
                               sigma_s_grid=rng.random((4, 4, 4)).astype(np.float32))],
                         device="cpu")
    assert tm._kernel_tracks(cuda, _plume().modes) and tm._kernel_tracks(cuda, mixed.modes)
    assert tm._kernel_tracks(cuda, ())
    assert not tm._kernel_tracks(cpu, _plume().modes)
    assert not tm._kernel_tracks(cuda, None)
    assert gen.modes[0][0] == "gen" and not tm._kernel_tracks(cuda, gen.modes)
    assert not tm._kernel_tracks(cuda, mixed.modes + gen.modes)


def test_the_kernel_table_stages_every_scalar_grid():
    lo, hi = BOX
    two = tm.Media.build(tm.plume_records(lo, hi, res=4) + [dict(type=tm.HOMOGENEOUS)]
                         + tm.plume_records(lo, hi, res=5), device="cpu")
    assert [m[0] for m in two.modes] == ["scalar", "const", "scalar"]
    n, scalar, off, res, qmax, stage_lo, stage_n = dt_op._table(two.modes)
    assert n == 3 and list(scalar) == [1, 0, 1] and list(off) == [1, 0, 65]
    assert list(res) == [4, 4, 4, 1, 1, 1, 5, 5, 5]
    assert (stage_lo, stage_n) == (1, 4 ** 3 + 5 ** 3) == (1, two.grid_data.numel() - 1)
    assert list(qmax)[6:] == pytest.approx(dt_op.qmax((5, 5, 5)))
    assert dt_op._table(tm.Media.build([dict(type=tm.HOMOGENEOUS)], device="cpu").modes)[5:] \
        == (0, 0)
    assert dt_op.mean_factor(1 << 21) == float(np.float32(1.0) / np.float32(3.0))


def test_the_kernel_wrapper_refuses_cpu_tensors():
    args = _track_inputs(_plume(), 10)
    media, modes = args[0], args[1]
    vols = dt_op.Volumes(media.box_min, media.box_max, media.active, media.sigma_a,
                         media.sigma_s, media.grid_data, modes)
    with pytest.raises(ValueError):
        dt_op.delta_track(vols, *args[2:])
