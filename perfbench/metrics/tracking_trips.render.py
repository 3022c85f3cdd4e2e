"""Delta-tracking trips a bounce over the traced passes: the program's
`media.trips` (each tracking call's trip count T, kept on the device while
profiling and read after the window) over its `media.track_calls`."""
from perfbench.core import program_counters


def read(run):
    c = program_counters.traced(run)
    if run.unit != "pass" or c is None or not c.get("media.track_calls"):
        return None
    return c.get("media.trips", 0) / c["media.track_calls"]
