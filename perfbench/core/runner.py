"""One run of one cell: the card check, the cell's driver, its metrics by
their readers, the comparison's verdict, and the result line."""
from __future__ import annotations

import sys

import torch

from . import compare
from .cell import load_cell

FORBIDDEN = {"jax", "jaxlib", "flax", "cudatracerlib_tpu"}


class NoCard(RuntimeError):
    pass


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's, Flax's
    or the JAX package's (the program's own name only begins with the
    latter's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def check_card(chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: the benchmark measures the card and does not run without one")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} CUDA devices, {torch.cuda.device_count()} present")


def measure(workload: str, seed: int, seconds: float, trace: bool, t0: float,
            device=None, overrides=None):
    """(result dict, check lines). With `device` None the run needs the
    card; tests pass a device ("cpu") and small `overrides` to drive the
    rest of a run without one."""
    cell = load_cell(workload, overrides=overrides)
    if device is None:
        check_card(cell.chips)
        device = "cuda"
    rec = cell.driver().run(cell, seed, seconds, trace, device, t0)
    ok, checks = compare.judge(rec.numbers, cell.limits)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cell.reader(m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    on_card = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": rec.peak_bytes}
    result = {"correct": bool(ok and rec.failed == 0 and rec.attempted > 0),
              "attempted": rec.attempted, "failed": rec.failed, "metrics": metrics, "device": dev}
    if trace and rec.trace is not None:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.wall_s
        result["breakdown"] = {"device_ops": rec.trace.top_kernels(),
                               "idle_gaps": rec.trace.top_gaps()}
    result["checks"] = checks
    lines = [f"check {k}: {c['value']!r} (limit {c['limit']!r})" for k, c in checks.items()]
    return result, lines
