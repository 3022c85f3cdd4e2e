from . import intersect_bvh, intersect_dense, shade_gather  # noqa: F401
