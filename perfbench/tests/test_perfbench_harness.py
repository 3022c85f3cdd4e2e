"""CPU tests of the benchmark harness: every part of a cell is found from
data by name, the clock and trace arithmetic, the import rules, the refusal
to run without a card, and the whole run driven at tiny sizes on the CPU:
sound runs come out correct, the control and each planted fault do not."""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from perfbench.core import compare, port, runner
from perfbench.core.cell import HERE, ROOT, load_cell
from perfbench.core.record import Record
from perfbench.core.stats import gaps, percentile, union_length
from perfbench.core.trace import Trace, reduce

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = {
    "bigscene": {"config": {"n_tris_target": 20000}},
    "render-1mp": {"traffic": {"width": 32, "height": 32, "trace_passes": 2,
                               "check": {"pass_from_first": 2, "pixels": 256, "block_lanes": 4096}}},
    "grad-256": {"traffic": {"width": 16, "height": 16, "spp": 2, "trace_steps": 2,
                             "check": {"block_lanes": 4096}}},
}


def small(cell_name):
    w = {x["name"]: x for x in BENCH["workloads"]}[cell_name]
    out = {"config": {}, "traffic": {}}
    for key in (w["config"], w["traffic"]):
        for part, upd in SMALL.get(key, {}).items():
            out[part].update(upd)
    return out


# ---- everything found from data ----

@pytest.mark.parametrize("name", CELLS)
def test_cell_parts_found_by_name(name):
    cell = load_cell(name)
    assert os.path.exists(os.path.join(HERE, "scenes", f"{cell.config['scene']}.py"))
    assert hasattr(cell.driver(), "run")
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m["name"]).read), m["name"]
    assert cell.limits, f"limits/{name}.json"
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)


def test_every_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS)), m["name"]


def test_a_cell_added_as_files_only_is_found(tmp_path):
    """A new traffic mix, metric, limits file and cell entry, added as files
    and entries alone, load and read without an edit to any file."""
    base = tmp_path / "perfbench"
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"][0]["file"] = "perfbench/configs/bigscene.json"
    bench["workloads"].append({"name": "plume.render-256", "config": "plume",
                               "traffic": "render-256", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "passes_seen", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "msamples_per_s", "workloads": ["plume.render-256"]})
    bench["end_to_end"][0]["workloads"].append("plume.render-256")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((base / "traffic" / "render-1mp.json").read_text())
    traffic.update(width=256, height=256)
    (base / "traffic" / "render-256.json").write_text(json.dumps(traffic))
    (base / "metrics" / "passes_seen.py").write_text("def read(run):\n    return run.units\n")
    (base / "limits" / "plume.render-256.json").write_text(
        (base / "limits" / "plume.render-1mp.json").read_text())
    cell = load_cell("plume.render-256", root=str(tmp_path), base=str(base))
    assert cell.traffic["width"] == 256 and cell.limits
    assert [m["name"] for m in cell.per_layer] == ["passes_seen"]
    assert cell.reader("passes_seen").read(Record(unit="pass", setup_s=1.0, unit_walls=[1, 2])) == 2


# ---- arithmetic ----

def test_union_gaps_and_percentile():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert union_length(iv) == 4
    assert gaps(iv, 0, 8) == [(3, 5), (6, 8)]
    assert percentile(list(range(1, 101)), 90) == 90
    assert percentile([3.0, 1.0, 2.0], 90) == 3.0


def test_readers_on_a_synthetic_run():
    rec = Record(unit="pass", setup_s=7.0, window_s=2.0, unit_walls=[0.1] * 9 + [0.5],
                 samples=4_000_000, peak_bytes=2 ** 31)
    cell = load_cell(CELLS[0])
    read = lambda n: cell.reader(n).read(rec)  # noqa: E731
    assert read("msamples_per_s") == 2.0
    assert abs(read("pass_ms_p90") - 100.0) < 1e-9
    assert read("peak_mem_gib") == 2.0 and read("setup_s") == 7.0
    assert read("grad_step_ms") is None and read("device_idle.render") is None
    rec.trace = Trace(kernels=[("void bvh_kernel(x)", 0.0, 1000.0), ("elementwise", 500.0, 3000.0)],
                      wall_s=0.01, busy_s=0.003)
    rec.unit_walls = [0.005, 0.005]
    assert abs(read("device_idle.render") - 0.7) < 1e-12
    assert read("launches_per_pass.render") == 1.0
    assert abs(read("bvh_kernel_ms.render") - 0.5) < 1e-12
    step = Record(unit="step", setup_s=1.0, window_s=3.0, unit_walls=[1.0] * 6,
                  spans={"backward": [0.2, 0.4]})
    assert cell.reader("grad_step_ms").read(step) == 500.0
    assert abs(cell.reader("backward_ms.grad").read(step) - 300.0) < 1e-9
    assert cell.reader("gather_bwd_ms.grad").read(step) is None


def test_trace_reduction_on_synthetic_events():
    from torch.autograd import DeviceType

    def ev(name, a, b, dev):
        return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b),
                               device_type=dev)

    events = [ev("k1", 0, 10, DeviceType.CUDA), ev("k2", 30, 40, DeviceType.CUDA),
              ev("k3", 35, 50, DeviceType.CUDA), ev("aten::mul", 0, 25, DeviceType.CPU),
              ev("aten::where", 26, 60, DeviceType.CPU), ev("aten::empty", 27, 28, DeviceType.CPU)]
    tr = reduce(SimpleNamespace(events=lambda: events), 1e-4)
    assert tr.busy_s == pytest.approx(30e-6)
    assert tr.idle_by_host_op == {"aten::mul": pytest.approx(20e-6)}
    assert tr.top_kernels()[0][0] in ("k2", "k3")


# ---- imports ----

FORBIDDEN = {"jax", "jaxlib", "flax", "cudatracerlib_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package_and_the_reference_no_program():
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
            if os.sep + "reference" + os.sep in path:
                assert "cudatracerlib_tpu_torch" not in tops, path


def test_a_run_loads_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from perfbench.core import runner, port\n"
            "from perfbench.drivers import render_passes, grad_steps\n"
            "print(runner.forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ---- refusals ----

def test_the_measurement_path_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


# ---- the whole run at tiny sizes on the CPU ----

SEED = 2 ** 31 + 977


def _measure(name, trace=False):
    return runner.measure(name, SEED, 0.5, trace, time.perf_counter(), device="cpu",
                          overrides=small(name))[0]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    res = _measure(name)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert "setup_s" in res["metrics"]


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_is_correct_and_reports_the_window(name):
    res = _measure(name, trace=True)
    assert res["correct"], res["checks"]
    assert res["device"]["window_s"] > 0 and "breakdown" in res


def _fault(monkeypatch, fault):
    """Plant a fault in the program's entry points (render, render_vol) or
    in its optimiser step."""
    if fault == "state_unchanged":
        # a pass returns the image of the pass before it; a step leaves the parameters
        for name in ("render", "render_vol"):
            fn, last = getattr(port, name), {}

            def stale(*a, _fn=fn, _last=last, **k):
                out = _fn(*a, **k)
                prev = _last.get("img", out)
                _last["img"] = out.detach()
                return prev if not out.requires_grad else out
            monkeypatch.setattr(port, name, stale)
        monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    elif fault == "half_batch":
        monkeypatch.setattr(port, "render", lambda sc, w, h, spp, s, c, _f=port.render:
                            _f(sc, w, h, max(1, spp // 2), s, c))
        monkeypatch.setattr(port, "render_vol", lambda sc, m, w, h, spp, s, c, _f=port.render_vol:
                            _f(sc, m, w, h, max(1, spp // 2), s, c))
    elif fault == "answer_altered":
        monkeypatch.setattr(port, "render", lambda *a, _f=port.render: _f(*a) * 1.01)
        monkeypatch.setattr(port, "render_vol", lambda *a, _f=port.render_vol: _f(*a) * 1.01)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct(name, fault, monkeypatch):
    _fault(monkeypatch, fault)
    res = _measure(name)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The reference in bfloat16 (a precision below the configuration's
    float32) in the program's place fails the cell's limits."""
    from perfbench.drivers import grad_steps as G
    from perfbench.drivers import render_passes as R

    cell = load_cell(name, overrides=small(name))
    data = cell.scene()
    if cell.traffic["driver"] == "grad_steps":
        med = port.media(data, "cpu")
        p0 = G.initial_params(cell, med, SEED, "cpu")
        nums = compare.train_numbers(G.reference_steps(cell, data, SEED, "cpu", p0, torch.bfloat16),
                                     G.reference_steps(cell, data, SEED, "cpu", p0))
    else:
        _, ids = R.plan(cell, SEED)
        nums = compare.image_numbers(
            R.reference_pass(cell, data, "cpu", SEED, ids, torch.bfloat16).float(),
            R.reference_pass(cell, data, "cpu", SEED, ids))
    ok, checks = compare.judge(nums, cell.limits)
    assert not ok, checks


# ---- on the card ----

@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card_is_correct(name, card):
    res, _ = runner.measure(name, SEED, 2.0, False, time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
