"""The program's spans in a finished torch.profiler trace: each device
kernel is attributed to the innermost `ctl.` span (the program's ranges,
cudatracerlib_tpu_torch/utils/timing.py) whose host interval, on the thread
that launched it, holds the runtime call that launched it. A kernel and its
runtime call share the profiler's correlation id (`FunctionEvent.id`).

From that: the device seconds and launches of the kernels launched under a
span, by span name, with or without its child spans; the device's idle
gaps named after the innermost span that holds them; and the synchronizing
runtime calls (stream synchronizes, device-to-host copies) made under a
span, which the program counts as its host reads.

Device events that are user annotations (a `record_function` range drawn on
the device's timeline, such as Adam's) are no kernels and are left out."""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

from .stats import gaps

PREFIX = "ctl."
OUTSIDE = "(no span)"


@dataclass
class Span:
    name: str
    start: float          # us, the profiler's clock
    end: float
    thread: int
    parent: int | None    # index of the enclosing span on the same thread


@dataclass
class SpanTrace:
    spans: list                                   # Span, sorted by start
    kernels: list                                 # (name, start_us, end_us, owner span or None)
    syncs: list = field(default_factory=list)     # (kind, owner span or None)

    def name_of(self, i) -> str:
        return OUTSIDE if i is None else self.spans[i].name

    def ancestors(self, i):
        """i and every span enclosing it."""
        while i is not None:
            yield i
            i = self.spans[i].parent

    def by_span(self) -> dict:
        """span name -> {"count", "self_s", "self_launches", "total_s",
        "total_launches"}: device seconds and launches of the kernels
        launched directly under spans of that name (self) or under them or
        their children (total); OUTSIDE for kernels launched under none."""
        out = defaultdict(lambda: dict(count=0, self_s=0.0, self_launches=0, total_s=0.0,
                                       total_launches=0))
        for s in self.spans:
            out[s.name]["count"] += 1
        for _, a, b, owner in self.kernels:
            dt = (b - a) * 1e-6
            out[self.name_of(owner)]["self_s"] += dt
            out[self.name_of(owner)]["self_launches"] += 1
            names = {OUTSIDE} if owner is None else {self.spans[j].name
                                                     for j in self.ancestors(owner)}
            for n in names:          # a name counted once even where spans of it nest
                out[n]["total_s"] += dt
                out[n]["total_launches"] += 1
        return dict(out)

    def device_seconds(self, names, children: bool = True) -> tuple[int, float]:
        """(launches, device seconds) of the kernels launched under spans
        named in `names` (with `children`, also under their child spans)."""
        names = {names} if isinstance(names, str) else set(names)
        n, s = 0, 0.0
        for _, a, b, owner in self.kernels:
            if owner is None:
                continue
            held = self.ancestors(owner) if children else (owner,)
            if any(self.spans[j].name in names for j in held):
                n += 1
                s += (b - a) * 1e-6
        return n, s

    def idle_by_span(self) -> dict:
        """Idle seconds of the device between its first and last kernel, by
        the innermost span of any thread whose interval holds each gap's
        midpoint (OUTSIDE where none does)."""
        if not self.kernels:
            return {}
        iv = [(a, b) for _, a, b, _ in self.kernels]
        lo, hi = min(a for a, _ in iv), max(b for _, b in iv)
        out = defaultdict(float)
        for a, b in gaps(iv, lo, hi):
            t = 0.5 * (a + b)
            inner = None
            for i, s in enumerate(self.spans):       # sorted by start: the last holder is innermost
                if s.start > t:
                    break
                if s.end >= t:
                    inner = i
            out[self.name_of(inner)] += (b - a) * 1e-6
        return dict(out)

    def syncs_by_span(self) -> dict:
        """span name -> {kind: count} of the synchronizing runtime calls made
        directly under spans of that name: the synchronize calls by name,
        and "Memcpy DtoH" for copies to the host. A read of one device value
        (`bool(x)`) makes one copy and one stream synchronize."""
        out = defaultdict(lambda: defaultdict(int))
        for kind, owner in self.syncs:
            out[self.name_of(owner)][kind] += 1
        return {k: dict(v) for k, v in out.items()}


def _innermost(spans, calls):
    """For each (time, thread) in `calls`, the index of the innermost span
    of that thread whose interval holds the time, or None (one sweep)."""
    marks = []
    for i, s in enumerate(spans):
        marks.append((s.start, 0, i))
        marks.append((s.end, 2, i))
    for k, (t, _) in enumerate(calls):
        marks.append((t, 1, k))
    marks.sort(key=lambda m: (m[0], m[1]))
    open_by_thread = defaultdict(list)
    out = [None] * len(calls)
    for _, kind, i in marks:
        if kind == 0:
            open_by_thread[spans[i].thread].append(i)
        elif kind == 2:
            stack = open_by_thread[spans[i].thread]
            stack.remove(i)
        else:
            stack = open_by_thread[calls[i][1]]
            out[i] = stack[-1] if stack else None
    return out


def _sync_kind(name: str, device_name: str | None) -> str | None:
    """The kind of a runtime call that waits for the device (a stream,
    event or device synchronize; a copy whose device side moves data to the
    host), or None."""
    if "Synchronize" in name:
        return name
    if "Memcpy" in name and device_name is not None and "DtoH" in device_name:
        return "Memcpy DtoH"
    return None


def attribute(events) -> SpanTrace:
    """The SpanTrace of a profiler's events (`prof.events()`)."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    raw = sorted(((e.time_range.start, e.time_range.end, e.name, e.thread) for e in cpu
                  if e.name.startswith(PREFIX)), key=lambda r: (r[0], -r[1]))
    spans = []
    open_by_thread = defaultdict(list)
    for a, b, name, thread in raw:
        stack = open_by_thread[thread]
        while stack and spans[stack[-1]].end < a:
            stack.pop()
        spans.append(Span(name=name, start=a, end=b, thread=thread,
                          parent=stack[-1] if stack else None))
        stack.append(len(spans) - 1)

    # a range's device-side copy shares the name and id of its host event
    host_keys = {(e.name, e.id) for e in cpu}
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False) and (e.name, e.id) not in host_keys]
    device_by_id = {e.id: e for e in device}
    runtime = [e for e in cpu if e.name.startswith("cu") and not e.name.startswith(PREFIX)]
    runtime_by_id = {e.id: e for e in runtime if e.id in device_by_id}
    launched = [runtime_by_id.get(e.id) for e in device]
    owners = _innermost(spans, [(r.time_range.start, r.thread) if r is not None else (0.0, None)
                                for r in launched])
    kernels = [(e.name, e.time_range.start, e.time_range.end, owner)
               for e, owner in zip(device, owners)]
    kinds = [(r, _sync_kind(r.name, getattr(device_by_id.get(r.id), "name", None)))
             for r in runtime]
    kinds = [(r, k) for r, k in kinds if k is not None]
    sync_owners = _innermost(spans, [(r.time_range.start, r.thread) for r, _ in kinds])
    return SpanTrace(spans=spans, kernels=kernels,
                     syncs=[(k, o) for (_, k), o in zip(kinds, sync_owners)])
