"""The 90th percentile (nearest rank) of the walls of every pass of the
window, each ending in a synchronize, in ms."""
from perfbench.core.stats import percentile


def read(run):
    if run.unit != "pass" or run.trace is not None or not run.unit_walls:
        return None
    return percentile(run.unit_walls, 90) * 1e3
