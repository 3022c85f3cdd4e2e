"""Device time of the gather backward's kernels (csrc/shade_gather_bwd.cu,
the kernels named gather_bwd_*) a traced step, in ms."""


def read(run):
    if run.unit != "step" or run.trace is None:
        return None
    n, s = run.trace.kernel_seconds("gather_bwd_")
    return s / run.units * 1e3 if n else None
