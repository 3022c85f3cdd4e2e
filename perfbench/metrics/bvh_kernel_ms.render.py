"""Device time of the BVH traversal kernel (csrc/intersect_bvh.cu's
bvh_kernel) a traced pass, in ms."""


def read(run):
    if run.unit != "pass" or run.trace is None:
        return None
    n, s = run.trace.kernel_seconds("bvh_kernel")
    return s / run.units * 1e3 if n else None
