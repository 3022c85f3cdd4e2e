"""Reduction of a torch.profiler trace to what the per-layer readers need:
the device kernels (name, start, end), their busy union over the profiled
wall (the arithmetic of chip_smoke.py's `_profile`), and the host op that
was running in each idle gap of the device."""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

from .stats import gaps, union_length


@dataclass
class Trace:
    kernels: list            # (name, start_us, end_us) of every device kernel
    wall_s: float            # the profiled wall, host clock, ending in a synchronize
    busy_s: float            # the union of the kernels' intervals
    idle_by_host_op: dict = field(default_factory=dict)   # host op -> idle seconds

    def kernel_seconds(self, substring: str) -> tuple[int, float]:
        """(launches, device seconds) of the kernels whose name holds `substring`."""
        mine = [(b - a) for n, a, b in self.kernels if substring in n]
        return len(mine), sum(mine) * 1e-6

    def top_kernels(self, n: int = 10):
        by = defaultdict(float)
        for name, a, b in self.kernels:
            by[name[:120]] += (b - a) * 1e-6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def top_gaps(self, n: int = 10):
        return sorted(([k, v] for k, v in self.idle_by_host_op.items()), key=lambda kv: -kv[1])[:n]


def _host_op_at(starts, ends, names, t, depth=32):
    """The innermost host op whose interval holds t (latest start), or None."""
    i = int(np.searchsorted(starts, t, side="right"))
    for j in range(i - 1, max(-1, i - 1 - depth), -1):
        if ends[j] >= t:
            return names[j]
    return None


def reduce(prof, wall_s: float) -> Trace:
    """A Trace of a finished torch.profiler.profile."""
    from torch.autograd import DeviceType

    events = prof.events()
    kernels = [(e.name, e.time_range.start, e.time_range.end) for e in events
               if e.device_type == DeviceType.CUDA]
    busy_us = union_length([(a, b) for _, a, b in kernels])
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type == DeviceType.CPU)
    idle = defaultdict(float)
    if kernels and host:
        starts = np.array([h[0] for h in host])
        ends = np.array([h[1] for h in host])
        names = [h[2] for h in host]
        lo = min(a for _, a, _ in kernels)
        hi = max(b for _, _, b in kernels)
        for a, b in gaps([(x, y) for _, x, y in kernels], lo, hi):
            name = _host_op_at(starts, ends, names, 0.5 * (a + b)) or "(no host op)"
            idle[name] += (b - a) * 1e-6
    return Trace(kernels=kernels, wall_s=wall_s, busy_s=busy_us * 1e-6, idle_by_host_op=dict(idle))
