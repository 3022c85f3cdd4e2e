"""CPU tests of what the benchmark reads from inside the program: the span
attribution of a trace (core/spans.py) on synthetic events, the readers of
the program's counters (core/program_counters.py and its metrics) on
synthetic records, and a traced run of every cell at tiny sizes, whose
result line carries every metric that reads the program."""
from __future__ import annotations

import json
import os
import sys
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from perfbench.core import program_counters, spans
from perfbench.core.cell import ROOT, load_cell
from perfbench.core.record import Record
from perfbench.core.trace import Trace, reduce

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]
PROGRAM = [m for m in BENCH["per_layer"] if m["source"] in ("program_counter", "program_span")]
SEED = 2 ** 31 + 977


def ev(name, a, b, dev=DeviceType.CPU, id=0, thread=1):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b),
                           device_type=dev, id=id, thread=thread)


def k(name, a, b, id):
    return ev(name, a, b, DeviceType.CUDA, id=id, thread=0)


# a pass (0-100) with two bounces; the second holds an intersect (52-60) and a
# host read; a backward span on another thread; Adam's annotation on the device
EVENTS = [
    ev("ctl.pass", 0, 100, id=1), ev("ctl.bounce", 10, 50, id=2), ev("ctl.bounce", 50, 90, id=3),
    ev("ctl.intersect", 52, 60, id=4), ev("aten::mul", 12, 14, id=5),
    ev("cudaLaunchKernel", 2, 3, id=100), ev("cudaLaunchKernel", 12, 13, id=101),
    ev("cudaLaunchKernel", 55, 56, id=102), ev("cudaLaunchKernel", 70, 71, id=103),
    ev("cudaLaunchKernel", 95, 96, id=104), ev("cudaLaunchKernel", 120, 121, id=105),
    ev("cudaMemcpyAsync", 75, 76, id=106), ev("cudaStreamSynchronize", 76, 80, id=107),
    ev("ctl.gather_bwd", 130, 140, id=8, thread=2), ev("cudaLaunchKernel", 131, 132, id=108, thread=2),
    ev("Optimizer.step#Adam.step", 150, 160, id=9),
    k("camera", 5, 8, 100), k("shade", 14, 20, 101), k("bvh_kernel", 58, 62, 102),
    k("nee", 72, 74, 103), k("Memcpy DtoH (Device -> Pageable)", 76, 77, 106),
    k("film", 97, 99, 104), k("add_", 122, 123, 105), k("gather_bwd_final_kernel", 133, 135, 108),
    k("Optimizer.step#Adam.step", 150, 152, 9),
]


def test_kernels_go_to_the_innermost_span_that_launched_them():
    st = spans.attribute(EVENTS)
    owner = {name: st.name_of(o) for name, _, _, o in st.kernels}
    assert owner == {"camera": "ctl.pass", "shade": "ctl.bounce", "bvh_kernel": "ctl.intersect",
                     "nee": "ctl.bounce", "Memcpy DtoH (Device -> Pageable)": "ctl.bounce",
                     "film": "ctl.pass", "add_": spans.OUTSIDE,
                     "gather_bwd_final_kernel": "ctl.gather_bwd"}   # Adam's annotation left out
    assert [s.name for s in st.spans] == ["ctl.pass", "ctl.bounce", "ctl.bounce", "ctl.intersect",
                                          "ctl.gather_bwd"]
    assert st.spans[3].parent == 2 and st.spans[1].parent == 0 and st.spans[4].parent is None
    by = st.by_span()
    assert by["ctl.bounce"]["count"] == 2
    assert by["ctl.bounce"]["self_s"] == pytest.approx(9e-6)        # shade, nee, the copy
    assert by["ctl.bounce"]["total_s"] == pytest.approx(13e-6)      # and the bvh kernel
    assert by["ctl.pass"]["self_launches"] == 2 and by["ctl.pass"]["total_launches"] == 6
    assert by["ctl.pass"]["total_s"] == pytest.approx(18e-6)
    assert by[spans.OUTSIDE]["total_s"] == pytest.approx(1e-6)
    assert st.device_seconds("ctl.intersect") == (1, pytest.approx(4e-6))
    assert st.device_seconds("ctl.bounce", children=False) == (3, pytest.approx(9e-6))
    assert st.device_seconds(["ctl.pass"])[0] == 6


def test_idle_gaps_and_host_reads_are_named_after_their_spans():
    st = spans.attribute(EVENTS)
    idle = st.idle_by_span()
    # gaps by midpoint: 8-14 and 20-58 in bounce 1; 62-72, 74-76 and 77-97 in
    # bounce 2 (62-72 after its intersect); 99-122 and 123-133 in no span
    assert idle == {"ctl.bounce": pytest.approx((6 + 38 + 10 + 2 + 20) * 1e-6),
                    spans.OUTSIDE: pytest.approx((23 + 10) * 1e-6)}
    assert st.syncs_by_span() == {"ctl.bounce": {"Memcpy DtoH": 1, "cudaStreamSynchronize": 1}}


def test_the_trace_reduction_is_unchanged_by_the_programs_spans():
    """The program's spans are host events only: the existing reduction
    reads the same kernels and busy time with them as without them, and an
    idle gap keeps the host op that held it."""
    base = [e for e in EVENTS if not e.name.startswith("ctl.")]
    a, b = reduce(SimpleNamespace(events=lambda: base), 1e-3), reduce(
        SimpleNamespace(events=lambda: EVENTS), 1e-3)
    assert a.kernels == b.kernels and a.busy_s == b.busy_s
    assert a.idle_by_host_op["cudaMemcpyAsync"] == b.idle_by_host_op["cudaMemcpyAsync"]
    # a gap no host op held is named after the span that held it
    assert a.idle_by_host_op["(no host op)"] > b.idle_by_host_op.get("(no host op)", 0.0)
    assert b.idle_by_host_op["ctl.bounce"] > 0


# ---- the readers of the program's counters ----

TIMING = program_counters.TIMING


def _program(monkeypatch, counts):
    monkeypatch.setitem(sys.modules, TIMING,
                        SimpleNamespace(counters=lambda profiled=False: dict(counts)))


TRACE = Trace(kernels=[("k", 0.0, 1.0)], wall_s=1.0, busy_s=1e-6)


def _reader(name):
    return load_cell(CELLS[0]).reader(name)


def test_readers_of_the_programs_counters(monkeypatch):
    _program(monkeypatch, {"media.trips": 57, "media.track_calls": 6,
                           "intersect_dense.closest.rays": 600, "intersect_dense.any_hit.rays": 600,
                           "intersect_bvh.closest.rays": 200, "intersect_dense.closest.rows": 9,
                           "host_reads.media.delta_track": 18, "host_reads.other": 2})
    rp = Record(unit="pass", setup_s=1.0, unit_walls=[0.1, 0.1], samples=100, trace=TRACE)
    rs = Record(unit="step", setup_s=1.0, unit_walls=[0.1] * 4, trace=TRACE)
    assert _reader("tracking_trips.render").read(rp) == pytest.approx(9.5)
    assert _reader("rays_per_sample.render").read(rp) == pytest.approx(14.0)
    assert _reader("host_reads_per_pass.render").read(rp) == 10.0
    assert _reader("host_reads_per_step.grad").read(rs) == 5.0
    for name in ("tracking_trips.render", "rays_per_sample.render", "host_reads_per_pass.render"):
        assert _reader(name).read(rs) is None, name       # the other unit
    assert _reader("host_reads_per_step.grad").read(rp) is None
    rp.trace = rs.trace = None                            # an untraced run
    assert all(_reader(m["name"]).read(r) is None for m in PROGRAM for r in (rp, rs))


def test_readers_give_none_where_the_program_has_no_counters(monkeypatch):
    """A program without the counters (an older one, whose timing module has
    no `counters`), or one that counted nothing while profiled."""
    rp = Record(unit="pass", setup_s=1.0, unit_walls=[0.1], samples=100, trace=TRACE)
    rs = Record(unit="step", setup_s=1.0, unit_walls=[0.1], trace=TRACE)
    monkeypatch.setitem(sys.modules, TIMING, SimpleNamespace())
    assert all(_reader(m["name"]).read(r) is None for m in PROGRAM for r in (rp, rs))
    monkeypatch.delitem(sys.modules, TIMING)
    assert all(_reader(m["name"]).read(r) is None for m in PROGRAM for r in (rp, rs))
    _program(monkeypatch, {})
    assert all(_reader(m["name"]).read(r) is None for m in PROGRAM for r in (rp, rs))
    _program(monkeypatch, {"launches.intersect_dense.closest": 0})   # no tracking, no reads
    assert _reader("tracking_trips.render").read(rp) is None
    assert _reader("host_reads_per_pass.render").read(rp) == 0.0


def test_the_program_metrics_are_declared_for_the_cells_that_read_them():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in PROGRAM:
        assert m["source"] == "program_counter" and m["workloads"], m["name"]
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", CELLS)), m["name"]


# ---- a traced run of every cell at tiny sizes on the CPU ----

SMALL = {
    "bigscene.render-1mp": {"config": {"n_tris_target": 20000},
                            "traffic": {"width": 32, "height": 32, "trace_passes": 2,
                                        "check": {"pass_from_first": 2, "pixels": 256,
                                                  "block_lanes": 4096}}},
    "plume.render-1mp": {"traffic": {"width": 32, "height": 32, "trace_passes": 2,
                                     "check": {"pass_from_first": 2, "pixels": 256,
                                               "block_lanes": 4096}}},
    "plume.grad-256": {"traffic": {"width": 16, "height": 16, "spp": 2, "trace_steps": 2,
                                   "check": {"block_lanes": 4096}}},
}


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reports_the_programs_metrics_and_its_breakdown(name):
    sys.path.insert(0, os.path.join(ROOT, "perfbench", "tools"))
    import span_breakdown

    from cudatracerlib_tpu_torch.utils import timing

    timing.reset_counters()
    res, line = span_breakdown.breakdown(name, SEED, device="cpu", overrides=SMALL[name])
    assert res["correct"], res["checks"]
    mine = [m["name"] for m in PROGRAM if name in m["workloads"]]
    assert mine and all(m in res["metrics"] for m in mine), (mine, res["metrics"])
    c, n = line["counters_per_unit"], line["units"]
    cell = load_cell(name, overrides=SMALL[name])
    depth = cell.config["max_depth"]
    assert line["by_span"]["ctl.pass"]["count"] == 1
    assert line["by_span"]["ctl.bounce"]["count"] == depth
    assert line["by_span"]["ctl.intersect"]["count"] == 2 * depth
    if cell.config["scene"] == "plume":
        assert line["by_span"]["ctl.media.track"]["count"] == depth
        assert c["media.track_calls"] == depth and c["media.trips"] > 0
        assert c["host_reads.media.delta_track"] >= 2 * depth
    if name == "plume.grad-256":
        assert line["by_span"]["ctl.gather_bwd"]["count"] == c["gather_bwd.calls"] > 0
        assert res["metrics"]["host_reads_per_step.grad"]["value"] == sum(
            v for key, v in c.items() if key.startswith("host_reads."))
    else:
        t = cell.traffic
        spp = t.get("spp_by_config", {}).get(cell.config["name"], t["spp"])
        rays = sum(v for key, v in c.items() if key.startswith("intersect_") and key.endswith(".rays"))
        assert rays == 2 * depth * t["width"] * t["height"] * spp
        assert res["metrics"]["rays_per_sample.render"]["value"] == 2 * depth
    assert n == len(line["unit_walls_s"]) and line["checks"]["closure"]["trace_kernels"] == 0
