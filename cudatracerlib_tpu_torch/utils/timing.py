"""Timers, spans and counters (port of cudatracerlib_tpu/utils/timing.py).

Counterpart of reference ``Base/Timer.h`` (InstructionTimer, PerformanceTimer
with RAII BlockMeasure and avg/stddev stats :36-127) and the per-pass
CUDA-event timing in Tracer<>::DoPass (Kernel/Tracer.h:213,239-247). PyTorch
returns before the card finishes, so a timed region that ends in tensors on
the card is closed by `torch.cuda.synchronize()` (`sync=True`), where the
JAX package calls `block_until_ready`.

Spans and counters mark the program's layers for a torch profiler:

- `span(name)` is a range in the profiler's trace while a torch profiler
  records, and does nothing otherwise. The ranges are host events of the
  profiler's own clock, so the trace ties each kernel to the innermost span
  whose time holds the runtime call that launched it (by correlation id).
  They are function-scope ranges: unlike `torch.profiler.record_function`,
  they add no event to the device's timeline, so the trace's kernels, their
  count and their busy time are those of the same run without spans. Names
  start with `ctl.`: `ctl.pass` (one render pass), `ctl.bounce` (one depth),
  `ctl.intersect`, `ctl.media.track`, `ctl.media.transmittance`,
  `ctl.gather_bwd`, `ctl.shard.allreduce` (one collective of
  parallel/shard.py: the film's inside a sharded pass, the gradients' after
  the backward; the collective's kernels are launched under it).
- `count(name, n)` adds to a counter, always; `counters()` reads them and
  `counters(profiled=True)` only what was counted while a profiler recorded.
  `CounterGroup` gives a module a view of some counters as a dict (the
  ops' `launches`). `count_device` keeps a count that lives in a device
  tensor, while a profiler records only; `counters` sums those afterwards,
  so a traced pass reads nothing back for them. `read_bool` and `upload`
  are the engines' two ways of making the host wait for the card's stream
  (a read of a device value; a copy from host memory, which PyTorch ends
  with a stream synchronize), each counted by site under
  `host_reads.<site>`.
"""
from __future__ import annotations

import functools
import math
import time
from collections import defaultdict
from collections.abc import MutableMapping
from contextlib import contextmanager, nullcontext
from typing import Dict

import torch
from torch.autograd import profiler as _profiler

from .._tree import tree_leaves_with_paths


class PerfBlock:
    """Accumulates wall-clock stats for a named block (avg ± stddev)."""

    def __init__(self):
        self.n = 0
        self.total = 0.0
        self.total_sq = 0.0
        self.last = 0.0

    def add(self, dt: float):
        self.n += 1
        self.total += dt
        self.total_sq += dt * dt
        self.last = dt

    @property
    def mean(self) -> float:
        return self.total / max(self.n, 1)

    @property
    def stddev(self) -> float:
        if self.n < 2:
            return 0.0
        m = self.mean
        return math.sqrt(max(self.total_sq / self.n - m * m, 0.0))


def block_until_ready(value) -> None:
    """Wait for the card's work behind `value` (a tensor or a tree of them):
    one `torch.cuda.synchronize()` per device its tensors lie on; CPU
    tensors are ready when they are returned."""
    devices = {leaf.device for _, leaf in tree_leaves_with_paths(value)
               if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


class PerformanceTimer:
    """Registry of named perf blocks (Base/Timer.h GET_PERF_BLOCKS)."""

    def __init__(self):
        self.blocks: Dict[str, PerfBlock] = defaultdict(PerfBlock)

    @contextmanager
    def measure(self, name: str, sync: bool = False, sync_value=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync and sync_value is not None:
                block_until_ready(sync_value)
            self.blocks[name].add(time.perf_counter() - t0)

    def report(self) -> str:
        lines = []
        for name, b in sorted(self.blocks.items()):
            lines.append(
                f"{name}: n={b.n} avg={b.mean*1e3:.2f}ms ± {b.stddev*1e3:.2f}ms"
                f" last={b.last*1e3:.2f}ms"
            )
        return "\n".join(lines)


# ---- spans ----

_NO_SPAN = nullcontext()


def span(name: str):
    """A context manager: the range `name` in the trace of a recording torch
    profiler, else nothing (one flag test). It records nothing else: no
    synchronize, no tensor, no kernel."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast(name)


def spanned(name: str):
    """Decorator: each call of the function runs inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


# ---- counters ----

_COUNTS: Dict[str, int] = defaultdict(int)     # since reset_counters()
_PROFILED: Dict[str, int] = defaultdict(int)   # the part counted while a profiler recorded
_DEVICE: list = []                             # (name, device tensor), kept while profiling


def count(name: str, n: int = 1) -> None:
    """Add `n` (a host integer) to the counter `name`."""
    _COUNTS[name] += n
    if _profiler._is_profiler_enabled:
        _PROFILED[name] += n


def count_device(name: str, x: torch.Tensor) -> None:
    """While a profiler records, keep `x` (an integer tensor, on any device)
    to add to the counter `name` when `counters` is read; otherwise nothing.
    Neither reads `x` back now."""
    if _profiler._is_profiler_enabled:
        _DEVICE.append((name, x))


def read_bool(site: str, x: torch.Tensor) -> bool:
    """bool(x), read on the host (on the card: a copy back and a stream
    synchronize), counted under `host_reads.<site>`."""
    count("host_reads." + site)
    return bool(x)


def upload(site: str, data, device, dtype=None) -> torch.Tensor:
    """torch.as_tensor(data, dtype, device): on the card, a copy from
    pageable host memory, after which PyTorch synchronizes the stream;
    counted under `host_reads.<site>`."""
    count("host_reads." + site)
    return torch.as_tensor(data, dtype=dtype, device=device)


def counters(profiled: bool = False) -> Dict[str, int]:
    """The counters since `reset_counters()` (with `profiled`, only what was
    counted while a profiler recorded), plus the `count_device` counts, all
    kept while profiling, summed here with one read back."""
    out = dict(_PROFILED if profiled else _COUNTS)
    if _DEVICE:
        names = sorted({n for n, _ in _DEVICE})
        sums = torch.stack([torch.stack([x.detach().reshape(()).long() for m, x in _DEVICE
                                         if m == name]).sum() for name in names]).tolist()
        for name, n in zip(names, sums):
            out[name] = out.get(name, 0) + n
    return out


def reset_counters() -> None:
    """Zero every counter and drop the kept device counts."""
    for k in _COUNTS:
        _COUNTS[k] = 0
    _PROFILED.clear()
    _DEVICE.clear()


class CounterGroup(MutableMapping):
    """The counters `<prefix>.<key>` for a fixed set of keys, read and set as
    a dict of key -> count (an ops module's `launches`); `add` counts."""

    def __init__(self, prefix: str, keys):
        self.prefix = prefix
        self._keys = tuple(keys)
        for k in self._keys:
            _COUNTS[f"{prefix}.{k}"] += 0

    def add(self, key: str, n: int = 1) -> None:
        if key not in self._keys:
            raise KeyError(key)
        count(f"{self.prefix}.{key}", n)

    def __getitem__(self, key: str) -> int:
        if key not in self._keys:
            raise KeyError(key)
        return _COUNTS[f"{self.prefix}.{key}"]

    def __setitem__(self, key: str, value: int) -> None:
        if key not in self._keys:
            raise KeyError(key)
        _COUNTS[f"{self.prefix}.{key}"] = value

    def __delitem__(self, key):
        raise TypeError("a counter group's keys are fixed")

    def __iter__(self):
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)
