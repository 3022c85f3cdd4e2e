"""The measured window and the traced window: a closed loop of units (a
pass or a step), each ending in a synchronize, for `seconds` of host clock;
or, traced, a fixed number of units under torch.profiler."""
from __future__ import annotations

import time

import torch

from . import trace as trace_mod


def sync_of(device):
    """The synchronize that ends a unit on `device` (nothing on the CPU,
    where the tests drive the harness)."""
    return torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)


def timed(unit, seconds: float, sync, min_units: int = 1):
    """Run unit(i) for i = 0, 1, ... until `seconds` have passed and at
    least `min_units` have run (the unit in flight at the deadline completes
    and counts): (walls, window_s)."""
    walls = []
    sync()
    t_start = time.perf_counter()
    i = 0
    while True:
        t = time.perf_counter()
        unit(i)
        sync()
        now = time.perf_counter()
        walls.append(now - t)
        i += 1
        if now - t_start >= seconds and i >= min_units:
            return walls, now - t_start


def traced(unit, n: int, sync):
    """Run unit(0 .. n-1) under torch.profiler: (walls, window_s, Trace)."""
    from torch.profiler import ProfilerActivity, profile

    walls = []
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_start = time.perf_counter()
        for i in range(n):
            t = time.perf_counter()
            unit(i)
            sync()
            walls.append(time.perf_counter() - t)
        window = time.perf_counter() - t_start
    return walls, window, trace_mod.reduce(prof, window)
