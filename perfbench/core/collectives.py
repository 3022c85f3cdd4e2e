"""The collectives of a sharded cell's traced window, for its per-layer
readers: each rank's collective kernels in launch order (the ranks launch
the same collectives in the same order, so the i-th kernel of every rank is
one collective), and the buffer bytes of one step's collectives.

A collective kernel runs from its launch until every rank has joined and the
data has moved: on the rank that arrives last it is (nearly) the transfer
alone, on the others it also holds the wait for that rank. So the least time
of a collective over the ranks is its transfer, and the most minus the least
is the time the fastest rank waited for the slowest."""
from __future__ import annotations

from dataclasses import dataclass, field

from .record import Record

NCCL_KERNELS = ("ncclKernel", "ncclDevKernel")   # device kernels; NCCL's host ranges are "nccl:..."


@dataclass
class ShardedRecord(Record):
    """A sharded cell's record: rank 0's, with every rank's collectives."""
    collectives: list = field(default_factory=list)  # per rank: collective kernel seconds, in order
    collective_bytes: int = 0                         # a step's buffer bytes (step_bytes)
    link_bytes_per_s: float = 0.0                     # the configuration's link peak, per direction


def collective_seconds(kernels) -> list:
    """The durations (s) of the NCCL kernels among a trace's kernels
    ((name, start_us, end_us)), in launch order."""
    return [(b - a) * 1e-6 for name, a, b in sorted(kernels, key=lambda k: k[1])
            if name.startswith(NCCL_KERNELS)]


def step_bytes(cell) -> int:
    """The buffer bytes of one step's collectives, from the configuration and
    the traffic: the film's all-reduce (the whole image's W x H x 3 values
    in float64) and the gradients' (the optimised leaves' values in float32:
    the grid's rows, 3 of sigma_a and 3 of sigma_s)."""
    t = cell.traffic
    sizes = {"grid_data": cell.config["counts"]["grid_rows"], "sigma_a": 3, "sigma_s": 3}
    return t["width"] * t["height"] * 3 * 8 + 4 * sum(sizes[p] for p in t["params"])


def by_collective(run):
    """[(least s, most s)] over the ranks for each collective of the traced
    window, or None where the run has no such record (one rank's count
    differing from another's included)."""
    ranks = getattr(run, "collectives", None)
    if run.trace is None or not ranks or not ranks[0] or len({len(r) for r in ranks}) != 1:
        return None
    return [(min(c), max(c)) for c in zip(*ranks)]


def transfer_ms(run):
    """Per step, the sum over the collectives of the least kernel time."""
    cs = by_collective(run)
    return None if cs is None else sum(lo for lo, _ in cs) / run.units * 1e3


def wait_ms(run):
    """Per step, the sum over the collectives of the most minus the least."""
    cs = by_collective(run)
    return None if cs is None else sum(hi - lo for lo, hi in cs) / run.units * 1e3


def link_share(run):
    """A step's collective bytes over its transfer time, over the link's
    per-direction peak: every rank receives each reduced buffer over its
    link, whatever the algorithm, so this cannot pass 1."""
    ms = transfer_ms(run)
    peak = getattr(run, "link_bytes_per_s", None) or 0.0
    if ms is None or not ms > 0 or not peak > 0:
        return None
    return run.collective_bytes / (ms * 1e-3) / peak
