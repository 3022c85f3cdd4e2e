"""The C++ SBVH builder (native/bvh_builder.cpp, the port's own copy of the
JAX package's builder source), loaded with ctypes.

The source beside this module is compiled with g++ into the port's
`_build/` directory, with the same flags the JAX package uses; nothing of
the JAX package, its source or its `_native.so`, is read or built.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .._build_util import build_shared, load

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bvh_builder.cpp")
_FLAGS = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
_LOCK = threading.Lock()
_LIB = None


def get_lib() -> ctypes.CDLL:
    """Compile-on-first-use builder library."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = load(build_shared(SRC, "bvh_builder", _FLAGS))
            lib.bvh_build_ex.restype = ctypes.c_int
            lib.bvh_build_ex.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ]
            lib.bvh_n_nodes.restype = ctypes.c_int
            lib.bvh_n_nodes.argtypes = []
            lib.bvh_n_order.restype = ctypes.c_int
            lib.bvh_n_order.argtypes = []
            lib.bvh_copy.restype = None
            lib.bvh_copy.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
            ]
            lib.bvh_release.restype = None
            lib.bvh_release.argtypes = []
            _LIB = lib
        return _LIB


SPATIAL_SPLITS = 1   # SBVH spatial splits on, as the JAX package builds
SPLIT_ALPHA = 1e-5   # overlap gate, a fraction of the root surface area


def build_bvh_native(tris: np.ndarray, leaf_size: int, n_bins: int, max_depth: int):
    """Returns (nodes (M,16) f32, order (P,) i32, root)."""
    lib = get_lib()
    tris = np.ascontiguousarray(tris.reshape(-1, 9), np.float32)
    with _LOCK:
        root = lib.bvh_build_ex(
            tris.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            tris.shape[0], leaf_size, n_bins, max_depth,
            SPATIAL_SPLITS, SPLIT_ALPHA,
        )
        nodes = np.empty((lib.bvh_n_nodes(), 16), np.float32)
        order = np.empty((lib.bvh_n_order(),), np.int32)
        lib.bvh_copy(
            nodes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            order.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        )
        lib.bvh_release()
    return nodes, order, int(root)
