"""The clock and trace arithmetic the metric readers share."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) by nearest rank: the smallest
    value with at least q% of the values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


def union_length(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy


def gaps(intervals, lo: float, hi: float):
    """The (start, end) gaps in [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]
