"""1 - (the union of the device kernels' intervals) / (the profiled wall)
over the traced steps."""


def read(run):
    if run.unit != "step" or run.trace is None or not run.trace.kernels:
        return None
    return 1.0 - run.trace.busy_s / run.trace.wall_s
