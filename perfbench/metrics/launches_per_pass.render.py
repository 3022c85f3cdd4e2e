"""Device kernel launches in the trace over the traced passes."""


def read(run):
    if run.unit != "pass" or run.trace is None or not run.trace.kernels:
        return None
    return len(run.trace.kernels) / run.units
