"""The port's spans and counters (utils/timing.py) on the CPU at tiny sizes.

Spans follow the torch profiler: without one they record nothing and no
device count is kept; under a CPU `torch.profiler` a Cornell `render` and a
plume `render_vol` record the tree ctl.pass > ctl.bounce (one a depth) >
ctl.intersect / ctl.media.*. The counters agree with what the engines
compute on their own: each bounce's `media.trips` with the trip count the
sampler states imply (`volpath.tracking_trips`), the tracking loop's host
reads with its iterations, the rays with lanes x calls. The image is
bit-equal with the profiler on and off, and the ops' `launches` read as
dicts, as `chip_smoke.py` reads them.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import json
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cudatracerlib_tpu_torch.ops import intersect_bvh as bvh_ops
from cudatracerlib_tpu_torch.ops import intersect_dense as dense_ops
from cudatracerlib_tpu_torch.ops import photon_gather as pg_ops
from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops
from cudatracerlib_tpu_torch.render import path_tracer as tpt
from cudatracerlib_tpu_torch.render import volpath as tvol
from cudatracerlib_tpu_torch.scene import media as tm
from cudatracerlib_tpu_torch.scene import shapes
from cudatracerlib_tpu_torch.utils import timing

W = H = 8
SPP = 2
DEPTH = 3
CFG = tpt.PTConfig(max_depth=DEPTH)


@pytest.fixture(scope="module")
def scenes():
    box = shapes.cornell_box(device="cpu")
    plume = tm.Media.build(tm.plume_records(box.bvh.world_min, box.bvh.world_max),
                           device="cpu")
    return box, plume


def _render(kind, scenes, seed=3):
    box, plume = scenes
    with torch.no_grad():
        if kind == "cornell":
            return tpt.render(box, W, H, SPP, seed, CFG)
        return tvol.render_vol(box, plume, W, H, SPP, seed, CFG)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _ctl_parent(e):
    """The innermost `ctl.` span that encloses event e on its thread."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith("ctl."):
        p = p.cpu_parent
    return p


def test_nothing_is_recorded_without_a_profiler(scenes):
    timing.reset_counters()
    assert timing.span("ctl.pass") is timing._NO_SPAN
    _render("plume", scenes)
    assert timing._DEVICE == []                       # no trips tensor kept
    assert timing.counters(profiled=True) == {}
    assert "media.trips" not in timing.counters()
    assert timing.counters()["media.track_calls"] == DEPTH


@pytest.mark.parametrize("kind", ["cornell", "plume"])
def test_the_span_tree_under_a_cpu_profiler(kind, scenes):
    _, prof = _profiled(lambda: _render(kind, scenes))
    ctl = [e for e in prof.events() if e.name.startswith("ctl.")]
    by = {}
    for e in ctl:
        by.setdefault(e.name, []).append(e)
    assert len(by["ctl.pass"]) == 1 and _ctl_parent(by["ctl.pass"][0]) is None
    assert len(by["ctl.bounce"]) == DEPTH
    assert all(_ctl_parent(e).name == "ctl.pass" for e in by["ctl.bounce"])
    # a closest hit and a shadow ray a bounce, each inside its bounce
    assert len(by["ctl.intersect"]) == 2 * DEPTH
    assert all(_ctl_parent(e).name == "ctl.bounce" for e in by["ctl.intersect"])
    media = {n: v for n, v in by.items() if n.startswith("ctl.media.")}
    if kind == "cornell":
        assert not media
        return
    # tracking once a bounce; the transmittance of the sampled segment and of the shadow ray
    assert len(media["ctl.media.track"]) == DEPTH
    assert len(media["ctl.media.transmittance"]) == 2 * DEPTH
    assert all(_ctl_parent(e).name == "ctl.bounce" for v in media.values() for e in v)
    bounces = sorted(by["ctl.bounce"], key=lambda e: e.time_range.start)
    for b in bounces:   # each bounce holds its own children
        kids = [e for e in ctl if _ctl_parent(e) is b]
        assert sorted(e.name for e in kids) == sorted(
            ["ctl.intersect"] * 2 + ["ctl.media.track"] + ["ctl.media.transmittance"] * 2)


def test_trips_and_host_reads_per_bounce(scenes, monkeypatch):
    """Each bounce's counted trips equal the trip count its lanes' sampler
    states imply, and the tracking loop reads the device once per block of
    TRACK_BLOCK trips plus the read that ends it."""
    seen = []
    inner = tvol.vol_bounce

    def bounce(scene, media, config, carry, depth):
        before = int(carry.sampler.state[0])
        timing.reset_counters()
        out = inner(scene, media, config, carry, depth)
        seen.append((before, int(out.sampler.state[0]), timing.counters(profiled=True)))
        return out

    monkeypatch.setattr(tvol, "vol_bounce", bounce)
    _profiled(lambda: _render("plume", scenes, seed=5))
    assert len(seen) == DEPTH
    trips = []
    for before, after, c in seen:
        T = tvol.tracking_trips(before, after)
        trips.append(T)
        assert c["media.track_calls"] == 1
        assert c["media.trips"] == T
        assert c["host_reads.media.delta_track"] == math.ceil(T / tm.TRACK_BLOCK) + 1
    assert max(trips) > 0


@pytest.mark.parametrize("kind", ["cornell", "plume"])
def test_rays_are_lanes_times_calls(kind, scenes):
    timing.reset_counters()
    _profiled(lambda: _render(kind, scenes))
    c = timing.counters(profiled=True)
    lanes, rows = W * H * SPP, int(scenes[0].bvh.woop.shape[0])
    for mode in ("closest", "any_hit"):
        assert c[f"intersect_dense.{mode}.calls"] == DEPTH
        assert c[f"intersect_dense.{mode}.rays"] == DEPTH * lanes
        assert c[f"intersect_dense.{mode}.rows"] == DEPTH * rows
    assert not any(k.startswith("intersect_bvh.") for k in c)


def test_call_sizes_of_both_intersectors_and_the_gather_backward(scenes):
    box = scenes[0]
    o = torch.zeros(5, 3) + torch.tensor([0.0, -3.0, 1.0])
    d = torch.tensor([[0.0, 1.0, 0.0]]).expand(5, 3).contiguous()
    timing.reset_counters()
    bvh_ops.intersect_bvh(box.bvh, o, d, any_hit=True)
    dense_ops.intersect_dense(box.bvh.woop, o, d, verts=box.bvh.tri_verts)
    table = torch.rand(7, 3, requires_grad=True)
    idx = torch.tensor([0, 2, 2, 6])
    _, prof = _profiled(lambda: sg_ops.gather_rows(table, idx).sum().backward())
    c = timing.counters()
    assert c["intersect_bvh.any_hit.calls"] == 1 and c["intersect_bvh.any_hit.rays"] == 5
    assert c["intersect_bvh.any_hit.rows"] == box.bvh.woop.shape[0]
    assert c["intersect_dense.closest.calls"] == 1 and c["intersect_dense.closest.rays"] == 5
    assert (c["gather_bwd.calls"], c["gather_bwd.lanes"], c["gather_bwd.values"],
            c["gather_bwd.rows"]) == (1, 4, 12, 7)
    assert [e.name for e in prof.events() if e.name.startswith("ctl.")] == ["ctl.gather_bwd"]
    assert torch.equal(table.grad[:, 0], torch.tensor([1.0, 0, 2, 0, 0, 0, 1]))


@pytest.mark.parametrize("kind", ["cornell", "plume"])
def test_the_image_is_bit_equal_with_the_profiler_on_and_off(kind, scenes):
    off = _render(kind, scenes, seed=11)
    on, _ = _profiled(lambda: _render(kind, scenes, seed=11))
    assert torch.equal(off, on)


def test_counters_read_back_device_counts_and_host_reads():
    timing.reset_counters()
    timing.count_device("x.n", torch.tensor(4))          # not profiling: not kept
    with profile(activities=[ProfilerActivity.CPU]):
        timing.count_device("x.n", torch.tensor(2))
        timing.count_device("x.n", torch.tensor(5))
        timing.count("x.calls", 3)
        assert timing.read_bool("x.site", torch.tensor([False, True]).any()) is True
    timing.count("x.calls")
    assert not timing.read_bool("x.site", torch.tensor(0))
    c, p = timing.counters(), timing.counters(profiled=True)
    assert (c["x.n"], c["x.calls"], c["host_reads.x.site"]) == (7, 4, 2)
    assert (p["x.n"], p["x.calls"], p["host_reads.x.site"]) == (7, 3, 1)
    timing.reset_counters()
    assert timing.counters(profiled=True) == {} and timing.counters()["x.calls"] == 0


def test_spans_are_host_ranges_that_draw_nothing_on_the_device():
    """A `record_function` range is a user annotation, which the profiler
    also draws on the device's timeline over the kernels it launched; the
    program's spans are function-scope ranges, which it does not."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span("ctl.a"):
            torch.ones(3).mul(2)
        with torch.profiler.record_function("ctl.b"):
            torch.ones(3).mul(2)
    flags = {e.name: e.is_user_annotation for e in prof.events() if e.name.startswith("ctl.")}
    assert flags == {"ctl.a": False, "ctl.b": True}


def test_uploads_are_counted_host_reads():
    """A host value copied to the card is followed by a stream synchronize:
    the sampler's seed (once a pass) and the GGX sampler's constant frame
    axis (once a bounce) count as host reads, by site."""
    from cudatracerlib_tpu_torch.math import microfacet
    from cudatracerlib_tpu_torch.sampling.rng import Sampler

    timing.reset_counters()
    ids = torch.arange(6)
    a = Sampler.create(12345, ids, torch.zeros(6, dtype=torch.int64))
    b = Sampler.create(torch.tensor(12345), ids, torch.zeros(6, dtype=torch.int64))
    assert torch.equal(a.state, b.state)
    wi = torch.nn.functional.normalize(torch.rand(4, 3) + 0.1, dim=-1)
    microfacet.sample(torch.ones(4, dtype=torch.int32), wi, torch.full((4,), 0.2),
                      torch.full((4,), 0.2), torch.rand(4, 2))
    c = timing.counters()
    assert c["host_reads.sampler.seed"] == 1 and c["host_reads.microfacet.sample"] == 1
    assert torch.equal(timing.upload("x", [1.0, 0.0], "cpu"), torch.tensor([1.0, 0.0]))


@pytest.mark.parametrize("mod, keys", [
    (dense_ops, ("closest", "any_hit")), (bvh_ops, ("closest", "any_hit")),
    (sg_ops, ("gather", "gather_bwd_tile", "gather_bwd_range", "gather_bwd_final")),
    (pg_ops, ("density", "density_reduce"))], ids=["dense", "bvh", "gather", "photon"])
def test_launch_dicts_read_as_before(mod, keys):
    """`chip_smoke.py` takes dict(ops.launches), sums its values, reads and
    compares keys, and zeroes a counter dict key by key."""
    launches = mod.launches
    for k in launches:
        launches[k] = 0
    assert dict(launches) == {k: 0 for k in keys}
    launches.add(keys[0])
    launches.add(keys[-1], 2)
    assert launches[keys[0]] == 1 and sum(launches.values()) == 3
    assert json.loads(json.dumps(dict(launches)))[keys[-1]] == 2
    assert timing.counters()[f"{launches.prefix}.{keys[-1]}"] == 2
    with pytest.raises(KeyError):
        launches["nothing"]
    for k in launches:
        launches[k] = 0
    assert sum(launches.values()) == 0
