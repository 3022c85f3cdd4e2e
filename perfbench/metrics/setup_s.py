"""Process start to the first timed unit: imports, the kernels' load from
the build cache, the scene build, the target render and the warm-up."""


def read(run):
    return run.setup_s
