from . import path_tracer, wavefront  # noqa: F401
