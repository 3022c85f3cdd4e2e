"""Device kernel launches in the trace over the traced steps."""


def read(run):
    if run.unit != "step" or run.trace is None or not run.trace.kernels:
        return None
    return len(run.trace.kernels) / run.units
