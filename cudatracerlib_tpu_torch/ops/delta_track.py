"""Delta tracking's trips: the CUDA kernel.

The loop of scene/media.py `delta_track` for volumes whose modes are all
'scalar' or 'const': one thread a lane runs the lane's trips in registers,
each trip drawing at the lane's start state + (2k + 1) G and + (2k + 2) G, as
the batch loop's trip k does, and T, the largest count of trips a lane began
while tracking, is reduced on the device. It replaces no TPU kernel (the
JAX package runs the trips as a while loop in XLA); csrc/delta_track.cu says
what bounds it on the H100 and what its design does about it.

`delta_track(vols, o, d, u_near, u_far, maj, in_vol, state)` returns (t
float32, real bool, T an int64 0-dim tensor), equal bit for bit to the eager
loop's. It takes CUDA tensors only: scene/media.py runs the eager loop for
CPU tensors (the plain version), as for other modes, and no wrapper falls
back from one to the other.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .._build_util import CudaKernel
from ..utils.timing import CounterGroup
from .transmittance import qmax

KINDS = ("scalar", "const")  # the modes the kernel computes
MAX_VOLUMES = 16             # scene/media.py MAX_VOLUMES

# Each launch of the kernel adds one here, the counter launches.delta_track.fwd.
launches = CounterGroup("launches.delta_track", ("fwd",))

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_IA, _FA = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
_LANES = [_P] * 7 + [_L, _F]                 # o, d, u_near, u_far, maj, in_vol, state, n, factor
_FIELDS = [_P] * 6                           # box_min, box_max, active, sigma_a, sigma_s, grid
_TABLE = [_I, _IA, _IA, _IA, _FA, _I, _I]    # volumes, scalar, off, res, qmax, staged rows
_KERNEL = CudaKernel("delta_track", _LANES + _FIELDS + _TABLE + [_P, _P, _P, _P])


class Volumes(NamedTuple):
    """The volume table as the kernel reads it: scene/media.Media's box rows,
    active flags and base sigmas, its flat grid buffer, and the host's mode
    tuple (one ('scalar' | 'const', grid offset, le offset, res) a volume)."""
    box_min: torch.Tensor   # (V, 3)
    box_max: torch.Tensor   # (V, 3)
    active: torch.Tensor    # (V,) int32
    sigma_a: torch.Tensor   # (V, 3)
    sigma_s: torch.Tensor   # (V, 3)
    grid: torch.Tensor      # (TOTAL,) float32
    modes: tuple


def get_lib():
    """Build (once per source hash) and load the launch function."""
    return _KERNEL.get()


def mean_factor(n: int) -> float:
    """The factor PyTorch's CUDA `mean(-1)` scales a (n, 3) tensor's row sums
    by: float(n) / float(3 n), each rounded to float32."""
    return float(np.float32(n) / np.float32(3 * n))


@functools.lru_cache(maxsize=64)
def _table(modes: tuple):
    """The mode tuple as the kernel's host arrays: (volumes, scalar flags,
    grid offsets, resolutions, qmax, first staged row, staged rows). The
    staged rows span every 'scalar' grid."""
    n = len(modes)
    if n > MAX_VOLUMES:
        raise ValueError(f"{n} volumes; the kernel takes at most {MAX_VOLUMES}")
    scalar = [int(m[0] == "scalar") for m in modes]
    off = [m[1] if s else 0 for m, s in zip(modes, scalar)]
    res = [r for m, s in zip(modes, scalar) for r in (m[3] if s else (1, 1, 1))]
    qm = [q for m, s in zip(modes, scalar) for q in qmax(m[3] if s else (1, 1, 1))]
    spans = [(m[1], m[1] + int(np.prod(m[3]))) for m, s in zip(modes, scalar) if s]
    lo = min((a for a, _ in spans), default=0)
    hi = max((b for _, b in spans), default=0)
    arr = lambda t, xs: (t * max(len(xs), 1))(*xs)  # noqa: E731
    return (n, arr(ctypes.c_int, scalar), arr(ctypes.c_int, off), arr(ctypes.c_int, res),
            arr(ctypes.c_float, qm), lo, hi - lo)


def _check(vols: Volumes, o, d, lanes, in_vol, state):
    if o.device.type != "cuda":
        raise ValueError(f"the tracking kernel runs on cuda tensors, not {o.device}")
    if any(m[0] not in KINDS for m in vols.modes):
        raise ValueError(f"the tracking kernel computes the modes {KINDS}, not {vols.modes}")
    if o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"o, d must be (B, 3), got {tuple(o.shape)}, {tuple(d.shape)}")
    floats = dict(o=o, d=d, box_min=vols.box_min, box_max=vols.box_max, sigma_a=vols.sigma_a,
                  sigma_s=vols.sigma_s, grid=vols.grid, **lanes)
    for name, x in floats.items():
        if x.dtype != torch.float32 or x.device != o.device:
            raise TypeError(f"{name} must be float32 on {o.device}, got {x.dtype} on {x.device}")
    for name, x, dtype in (("in_vol", in_vol, torch.bool), ("state", state, torch.int64),
                           ("active", vols.active, torch.int32)):
        if x.dtype != dtype or x.device != o.device:
            raise TypeError(f"{name} must be {dtype} on {o.device}, got {x.dtype} on {x.device}")
    if vols.active.numel() != len(vols.modes):
        raise ValueError(f"{vols.active.numel()} volumes but {len(vols.modes)} modes")
    if vols.grid.dim() != 1 or vols.grid.numel() >= 1 << 31:
        raise ValueError(f"grid must be a flat buffer of < 2^31 rows, got {tuple(vols.grid.shape)}")


def _stream(x):
    with torch.cuda.device(x.device):
        return torch.cuda.current_stream().cuda_stream


def delta_track(vols: Volumes, o, d, u_near, u_far, maj, in_vol, state):
    """The tracking trips of o, d (..., 3) from u_near, ending past u_far, under
    the per-lane majorant maj, for the lanes in_vol, from the sampler's state
    words (int64): (t (...,) float32, real (...,) bool, T int64 0-dim), each
    equal to the eager loop's. One launch."""
    batch = o.shape[:-1]
    o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
    lanes = {k: x.reshape(-1).contiguous() for k, x in
             (("u_near", u_near), ("u_far", u_far), ("maj", maj))}
    in_vol, state = in_vol.reshape(-1).contiguous(), state.reshape(-1).contiguous()
    _check(vols, o, d, lanes, in_vol, state)
    fields = [x.contiguous() for x in (vols.box_min, vols.box_max, vols.active, vols.sigma_a,
                                       vols.sigma_s, vols.grid)]
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    real = torch.empty(n, dtype=torch.bool, device=o.device)
    trips = torch.empty((), dtype=torch.int64, device=o.device)
    _KERNEL.launch(o.data_ptr(), d.data_ptr(), lanes["u_near"].data_ptr(),
                   lanes["u_far"].data_ptr(), lanes["maj"].data_ptr(), in_vol.data_ptr(),
                   state.data_ptr(), n, mean_factor(n) if n else 0.0,
                   *(x.data_ptr() for x in fields), *_table(vols.modes), t.data_ptr(),
                   real.data_ptr(), trips.data_ptr(), _stream(o))
    launches.add("fwd")
    return t.reshape(batch), real.reshape(batch), trips
