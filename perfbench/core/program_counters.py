"""The program's counters over the traced window, for the per-layer readers.

The program (cudatracerlib_tpu_torch/utils/timing.py) keeps, beside its
running totals, what it counted while a torch profiler recorded; a run's
only profiled stretch is the traced window (window.traced), so those are
the window's counts. They are looked up in the program that port.py
loaded, not imported: a program without such counters gives None, and so
does a run without a trace."""
from __future__ import annotations

import sys

TIMING = "cudatracerlib_tpu_torch.utils.timing"


def traced(run) -> dict | None:
    """name -> count over the traced window of `run`, or None."""
    if run.trace is None:
        return None
    read = getattr(sys.modules.get(TIMING), "counters", None)
    if read is None:
        return None
    counts = read(profiled=True)
    return counts or None


def total(counts: dict, prefix: str, suffix: str = "") -> int:
    """The sum of the counters whose names start with `prefix` and end
    with `suffix`."""
    return sum(v for k, v in counts.items() if k.startswith(prefix) and k.endswith(suffix))
