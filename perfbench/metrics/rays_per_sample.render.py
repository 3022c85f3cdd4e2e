"""Rays launched into both intersectors (intersect_dense, intersect_bvh),
closest-hit and any-hit, over the camera samples of the traced passes: the
program's `<intersector>.<mode>.rays` counters."""
from perfbench.core import program_counters


def read(run):
    c = program_counters.traced(run)
    if run.unit != "pass" or c is None or run.samples <= 0:
        return None
    return program_counters.total(c, "intersect_", ".rays") / run.samples
