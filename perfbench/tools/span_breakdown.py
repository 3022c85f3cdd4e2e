"""One traced run of a cell, as `run.py --trace 1` makes it, broken down by
the program's spans (perfbench/core/spans.py) and counters:

    python3 perfbench/tools/span_breakdown.py --workload <cell> --seed <n> \\
        [--out spans.json]

Prints the run's result line, then one JSON line: the traced units; device
time and launches a unit by span name (self: launched directly under the
span; total: also under its children); idle a unit by the innermost span
holding each gap; the synchronizing runtime calls by span; the program's
counters of the window a unit; and the checks that tie the two together:
the program's launch counts of its kernels against the trace's counts of
those kernels, its host reads against the stream synchronizes under `ctl.`
spans,
and the device time under `ctl.pass` plus the kernels launched under no
span against the whole."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from perfbench.core import program_counters, runner, spans, window  # noqa: E402
from perfbench.core import trace as trace_mod  # noqa: E402

# the program's launch counters and the trace's kernel names they count
KERNELS = {"bvh_kernel": ["launches.intersect_bvh."], "dense_kernel": ["launches.intersect_dense."],
           "gather_bwd_": ["launches.shade_gather.gather_bwd_"]}


def breakdown(workload: str, seed: int, device=None, overrides=None):
    """(the run's result, the breakdown) of one traced run; `device` and
    `overrides` as in runner.measure (tests drive it on the CPU)."""
    kept = {}
    reduce, traced = trace_mod.reduce, window.traced

    def keep_reduce(prof, wall_s):
        kept["spans"] = spans.attribute(prof.events())
        return reduce(prof, wall_s)

    def keep_traced(unit, n, sync):
        walls, win, tr = traced(unit, n, sync)
        kept.update(units=len(walls), walls=walls, trace=tr)
        return walls, win, tr

    trace_mod.reduce, window.traced = keep_reduce, keep_traced
    try:
        result, _ = runner.measure(workload, seed, 0.0, True, T0, device=device,
                                   overrides=overrides)
    finally:
        trace_mod.reduce, window.traced = reduce, traced

    st, tr, n = kept["spans"], kept["trace"], kept["units"]
    counts = program_counters.traced(SimpleNamespace(trace=tr)) or {}
    by = st.by_span()
    per_unit = {name: {"count": v["count"] / n, "self_ms": v["self_s"] / n * 1e3,
                       "self_launches": v["self_launches"] / n,
                       "total_ms": v["total_s"] / n * 1e3, "total_launches": v["total_launches"] / n}
                for name, v in sorted(by.items())}
    device_s = sum((b - a) for _, a, b, _ in st.kernels) * 1e-6
    under_pass = st.device_seconds("ctl.pass")[1]
    outside = sorted(((k[0][:80], (k[2] - k[1]) * 1e-3) for k in st.kernels if k[3] is None),
                     key=lambda kv: -kv[1])
    out_by = {}
    for name, ms in outside:
        out_by[name] = out_by.get(name, 0.0) + ms
    syncs = st.syncs_by_span()
    under_ctl = {}
    for span_name, kinds in syncs.items():
        if span_name != spans.OUTSIDE:
            for k, v in kinds.items():
                under_ctl[k] = under_ctl.get(k, 0) + v
    checks = {
        "launches": {kname: {"trace": sum(1 for k in st.kernels if kname in k[0]),
                             "program": sum(v for c, v in counts.items()
                                            if any(c.startswith(p) for p in prefixes))}
                     for kname, prefixes in KERNELS.items()},
        "host_reads": {"program": program_counters.total(counts, "host_reads."),
                       "syncs_under_ctl": under_ctl,
                       "equal": program_counters.total(counts, "host_reads.")
                       == under_ctl.get("cudaStreamSynchronize", 0)},
        "closure": {"device_ms": device_s * 1e3, "under_ctl_pass_ms": under_pass * 1e3,
                    "no_span_ms": sum(ms for _, ms in outside),
                    "no_span_kernels": sorted(out_by.items(), key=lambda kv: -kv[1])[:8],
                    "trace_kernels": len(tr.kernels), "attributed_kernels": len(st.kernels)},
    }
    line = {"workload": workload, "seed": seed, "units": n,
            "unit_walls_s": kept["walls"], "window_s": tr.wall_s, "busy_s": tr.busy_s,
            "by_span": per_unit,
            "idle_ms_by_span": {k: v / n * 1e3 for k, v in sorted(st.idle_by_span().items())},
            "syncs_by_span": syncs,
            "counters_per_unit": {k: v / n for k, v in sorted(counts.items())},
            "checks": checks}
    return result, line


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    cache = os.path.join(ROOT, ".perfbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    result, line = breakdown(args.workload, args.seed)
    print(json.dumps(result), flush=True)
    print(json.dumps(line), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(line, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
