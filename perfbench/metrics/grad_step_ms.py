"""The window's wall time over the steps completed in it, in ms: a step is
the forward, the backward, the Adam update and the loss read on the host."""


def read(run):
    if run.unit != "step" or run.trace is not None or not run.unit_walls:
        return None
    return run.window_s / run.units * 1e3
