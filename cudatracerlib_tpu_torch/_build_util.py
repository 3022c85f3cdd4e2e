"""Build-at-first-use for the port's native libraries.

Each shared library is compiled from one source file into `_build/` (listed
in .gitignore), under a name keyed on a hash of the source and the compiler
command, so an edited source is rebuilt and an unchanged one is reused.
Concurrent builders (test workers) each compile to a private temporary
name and atomically rename it into place. `CudaKernel` is one CUDA source of
csrc/ built with nvcc for sm_90a and its plain C launch function.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def build_shared(src: str, name: str, cmd_prefix: list[str]) -> str:
    """Compile `src` into `_build/<name>-<hash>.so` with
    `cmd_prefix + [src, "-o", out]`; returns the library path. The hash
    covers the source, the headers it includes by quoted name from its own
    directory, and the command."""
    with open(src, "rb") as f:
        text = f.read()
    h = hashlib.sha256(text + " ".join(cmd_prefix).encode())
    for inc in re.findall(rb'#include "([^"]+)"', text):
        with open(os.path.join(os.path.dirname(src), inc.decode()), "rb") as f:
            h.update(f.read())
    key = h.hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"{name}-{key}.so")
    if not os.path.exists(so):
        tmp = f"{so}.{os.getpid()}.tmp"
        r = subprocess.run(cmd_prefix + [src, "-o", tmp], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"building {src} failed:\n{r.stdout}\n{r.stderr}")
        os.replace(tmp, so)
    return so


def load(so: str) -> ctypes.CDLL:
    return ctypes.CDLL(so)


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


class CudaKernel:
    """csrc/<name>.cu, built with nvcc at first use, and its C function
    `<name>_launch(...)`, which enqueues the kernel on the given stream and
    returns cudaGetLastError(). Pointers and the stream go as c_void_p."""

    def __init__(self, name: str, argtypes: list):
        self.name = name
        self.argtypes = argtypes
        self._fn = None
        self._lib = None
        self._lock = threading.Lock()

    def get(self):
        """Build (once per source hash) and load the launch function."""
        with self._lock:
            if self._fn is None:
                src = os.path.join(CSRC, f"{self.name}.cu")
                self._lib = load(build_shared(src, self.name, [nvcc_path()] + NVCC_FLAGS))
                self._fn = self._bind("launch", self.argtypes)
            return self._fn

    def function(self, suffix: str, argtypes: list):
        """Another C function `<name>_<suffix>` of the same library."""
        self.get()
        return self._bind(suffix, argtypes)

    def _bind(self, suffix, argtypes):
        fn = getattr(self._lib, f"{self.name}_{suffix}")
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        return fn

    def launch(self, *args) -> None:
        err = self.get()(*args)
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: cudaError {err}")
