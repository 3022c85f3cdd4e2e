"""A grid volume's 32-step transmittance and its backward: the CUDA kernels
and their plain versions.

The 'scalar' mode of scene/media.py `transmittance`: one shared scalar
density grid, scaled by the volume's base sigma_t = sigma_a + sigma_s per
channel, integrated over a ray segment's TAU_STEPS midpoints. It replaces
no TPU kernel (the JAX package scans the steps in XLA); csrc/transmittance.cu
says what bounds it on the H100 and what its design does about it.

`transmittance(vol, grid, st, o, d, t_min, t_max)` returns the volume's
factor where(act, exp(-tau), 1), (..., 3): CUDA tensors launch the kernel,
CPU tensors run the plain version; no wrapper falls back from one to the
other. Both equal the eager path's arithmetic bit for bit. Where the grid or
st needs a gradient the call is an autograd Function that saves o, d, the
range, the output and the step sum `acc` (B floats), and whose backward
recomputes each step's corners: the grid's cotangent goes through
ops/shade_gather `packed_gather_bwd` (deterministic, no atomics), st's is a
torch sum over the lanes. o, d, t_min and t_max take no gradient: the
caller sends rays that carry one to the eager path.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .._build_util import CudaKernel
from ..utils.timing import CounterGroup
from . import shade_gather
from .intersect_dense import range_arg

TAU_STEPS = 32  # fixed quadrature steps along a segment

# Each launch of a CUDA kernel adds one here, the counters
# launches.transmittance.<kernel> (plain-version calls do not).
launches = CounterGroup("launches.transmittance", ("fwd", "bwd"))

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_RAYS = [_P, _P, _P, _F, _P, _F]                     # o, d, t_min, its value, t_max, its value
_VOLUME = [_P, _P, _P, _P]                           # box_min, box_max, active, st
_CELLS = [_I, _I, _I, _I, _F, _F, _F, _L]            # off, res, qmax, lanes
_KERNEL = CudaKernel("transmittance", _RAYS + _VOLUME + [_P] + _CELLS + [_P, _P, _P])
_BWD_ARGS = _RAYS + _VOLUME + _CELLS + [_P, _P, _P, _P, _P, _P, _P]


class Grid(NamedTuple):
    """One 'scalar' volume as the kernels read it: its box rows (3,), its
    active flag (a 0-dim int32 view) and, from the host's mode tuple, its
    grid's first row in the flat buffer and its resolution."""
    box_min: torch.Tensor
    box_max: torch.Tensor
    active: torch.Tensor
    off: int
    res: tuple


def get_lib():
    """Build (once per source hash) and load the forward's launch function."""
    return _KERNEL.get()


def qmax(res) -> list[float]:
    """The largest grid coordinate a lookup takes on each axis,
    max(r - 1, 0) * (1 - 1e-6) rounded to float32 as `_trilinear` rounds it."""
    return [float(np.float32(max(r - 1, 0)) * np.float32(1 - 1e-6)) for r in res]


# ---- the plain versions ----

def _clip(vol: Grid, o, d, t_min, t_max):
    """`_ray_box` and the segment's step: (near, dt, act), each (B,)."""
    inv = 1.0 / torch.where(d.abs() < 1e-12, 1e-12, d)
    t0 = (vol.box_min - o) * inv
    t1 = (vol.box_max - o) * inv
    near, far = torch.minimum(t0, t1).amax(-1), torch.maximum(t0, t1).amin(-1)
    tensor = lambda t: isinstance(t, torch.Tensor)  # noqa: E731
    near = torch.maximum(near, t_min) if tensor(t_min) else torch.clamp(near, min=t_min)
    far = torch.minimum(far, t_max) if tensor(t_max) else torch.clamp(far, max=t_max)
    dt = torch.clamp(far - near, min=0.0) / TAU_STEPS
    return near, dt, (near < far) & (vol.active > 0)


def _cells(vol: Grid, o, d, near, dt):
    """Each step's trilinear cell: the corner rows (B, TAU_STEPS, 2, 2, 2)
    int32 in x, y, z order and the fractions (B, TAU_STEPS, 3)."""
    i = torch.arange(TAU_STEPS, dtype=torch.float32, device=o.device)
    t = near[:, None] + (i + 0.5) * dt[:, None]
    p = o[:, None, :] + d[:, None, :] * t[..., None]
    r = torch.tensor(vol.res, dtype=torch.int32, device=o.device)
    rf = r.float()
    q = (p - vol.box_min) / torch.clamp(vol.box_max - vol.box_min, min=1e-9) * (rf - 1)
    q = torch.minimum(torch.clamp(q, min=0.0), torch.clamp(rf - 1, min=0.0) * (1 - 1e-6))
    fl = torch.floor(q)
    i0 = fl.to(torch.int32)
    i1 = torch.minimum(i0 + 1, r - 1)
    ix, iy, iz = (torch.stack([i0[..., c], i1[..., c]], -1) for c in range(3))
    rows = (vol.off + (ix[..., :, None, None] * vol.res[1] + iy[..., None, :, None]) * vol.res[2]
            + iz[..., None, None, :])
    return rows, q - fl


def _lerp(a, axis, t):
    t = t.reshape(t.shape + (1,) * (-1 - axis))
    return a.select(axis, 0) * (1 - t) + a.select(axis, 1) * t


def transmittance_plain(vol: Grid, grid, st, o, d, t_min, t_max):
    """The eager path's arithmetic in plain PyTorch, o, d (B, 3): (the
    factor (B, 3), acc (B,))."""
    near, dt, act = _clip(vol, o, d, t_min, t_max)
    rows, f = _cells(vol, o, d, near, dt)
    c = grid[rows.long()]
    c = _lerp(c, -3, f[..., 0])
    c = _lerp(c, -2, f[..., 1])
    vals = _lerp(c, -1, f[..., 2])                 # (B, TAU_STEPS)
    acc = torch.zeros_like(near)
    for col in vals.unbind(1):                     # left to right, `_scan_sum`'s order
        acc = acc + col
    tau = st * (acc * dt)[:, None]
    return torch.where(act[:, None], torch.exp(-tau), 1.0), acc


def transmittance_bwd_plain(vol: Grid, n_rows: int, st, o, d, t_min, t_max, g, out, acc):
    """The backward in plain PyTorch: (the grid's cotangent (n_rows,) summed by
    `packed_gather_bwd`, st's (3,))."""
    near, dt, act = _clip(vol, o, d, t_min, t_max)
    gtau = torch.where(act[:, None], -(g * out), 0.0)
    g_st = (gtau * (acc * dt)[:, None]).sum(0)
    g_acc = (gtau * st).sum(-1) * dt
    rows, f = _cells(vol, o, d, near, dt)
    w = [torch.stack([1 - f[..., c], f[..., c]], -1) for c in range(3)]   # (B, TAU_STEPS, 2)
    gc = ((g_acc[:, None, None, None, None] * w[2][..., None, None, :]) * w[1][..., None, :, None]
          * w[0][..., :, None, None])
    g_grid = shade_gather.packed_gather_bwd(gc.reshape(-1, 1), rows.reshape(-1), n_rows)
    return g_grid.reshape(n_rows), g_st


# ---- the kernels ----

def _check(vol: Grid, grid, st, o, d):
    if o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"o, d must be (B, 3), got {tuple(o.shape)}, {tuple(d.shape)}")
    for name, x in (("o", o), ("d", d), ("grid", grid), ("st", st), ("box_min", vol.box_min),
                    ("box_max", vol.box_max)):
        if x.dtype != torch.float32 or x.device != o.device:
            raise TypeError(f"{name} must be float32 on {o.device}, got {x.dtype} on {x.device}")
    if vol.active.dtype != torch.int32 or vol.active.numel() != 1:
        raise TypeError(f"active must be one int32 flag, got {vol.active.dtype}")
    if grid.dim() != 1 or grid.numel() >= 1 << 31:
        raise ValueError(f"grid must be a flat buffer of < 2^31 rows, got {tuple(grid.shape)}")


def _args(vol: Grid, st, o, d, t_min, t_max):
    """The arguments both kernels share, and the tensors behind them."""
    n = o.shape[0]
    (t0v, t0), (t1v, t1) = range_arg(t_min, n, o.device), range_arg(t_max, n, o.device)
    keep = [x.contiguous() for x in (o, d, vol.box_min, vol.box_max, vol.active, st)]
    o, d, bmin, bmax, active, st = keep
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    rays = (o.data_ptr(), d.data_ptr(), ptr(t0), t0v, ptr(t1), t1v)
    volume = (bmin.data_ptr(), bmax.data_ptr(), active.data_ptr(), st.data_ptr())
    cells = (vol.off, *vol.res, *qmax(vol.res), n)
    return rays, volume, cells, keep + [t0, t1]


def _stream(x):
    with torch.cuda.device(x.device):
        return torch.cuda.current_stream().cuda_stream


def _forward(vol: Grid, grid, st, o, d, t_min, t_max, keep_acc: bool):
    """(the factor (B, 3), acc (B,) or None): the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if o.device.type == "cpu":
        out, acc = transmittance_plain(vol, grid, st, o, d, t_min, t_max)
        return out, (acc if keep_acc else None)
    if o.device.type != "cuda":
        raise ValueError(f"transmittance runs on cuda or cpu tensors, not {o.device}")
    _check(vol, grid, st, o, d)
    grid = grid.contiguous()
    rays, volume, cells, _keep = _args(vol, st, o, d, t_min, t_max)
    out = torch.empty(o.shape[0], 3, dtype=torch.float32, device=o.device)
    acc = torch.empty(o.shape[0], dtype=torch.float32, device=o.device) if keep_acc else None
    _KERNEL.launch(*rays, *volume, grid.data_ptr(), *cells, out.data_ptr(),
                   None if acc is None else acc.data_ptr(), _stream(o))
    launches.add("fwd")
    return out, acc


def bwd_corners(vol: Grid, st, o, d, t_min, t_max, g, out, acc):
    """The backward kernel on CUDA tensors: (the corner cotangents (B * 32 * 8,)
    and their grid rows, int32, in the eager layout; each lane's share of
    st's cotangent (B, 3))."""
    n = o.shape[0]
    rays, volume, cells, _keep = _args(vol, st, o, d, t_min, t_max)
    g, out, acc = g.contiguous(), out.contiguous(), acc.contiguous()
    g_corner = torch.empty(n * TAU_STEPS * 8, dtype=torch.float32, device=o.device)
    rows = torch.empty(n * TAU_STEPS * 8, dtype=torch.int32, device=o.device)
    g_st = torch.empty(n, 3, dtype=torch.float32, device=o.device)
    err = _KERNEL.function("bwd", _BWD_ARGS)(
        *rays, *volume, *cells, g.data_ptr(), out.data_ptr(), acc.data_ptr(), g_corner.data_ptr(),
        rows.data_ptr(), g_st.data_ptr(), _stream(o))
    if err != 0:
        raise RuntimeError(f"transmittance backward kernel launch failed: cudaError {err}")
    launches.add("bwd")
    return g_corner, rows, g_st


def _backward(vol: Grid, n_rows: int, st, o, d, t_min, t_max, g, out, acc):
    """(the grid's cotangent, st's): the kernel, then the gather backward and
    a torch sum, for CUDA tensors; the plain version for CPU tensors."""
    if o.device.type == "cpu":
        return transmittance_bwd_plain(vol, n_rows, st, o, d, t_min, t_max, g, out, acc)
    g_corner, rows, g_st = bwd_corners(vol, st, o, d, t_min, t_max, g, out, acc)
    g_grid = shade_gather.packed_gather_bwd(g_corner.view(-1, 1), rows, n_rows)
    return g_grid.view(n_rows), g_st.sum(0)


class _Transmittance(torch.autograd.Function):
    """The factor, differentiable in the grid and st."""

    @staticmethod
    def forward(ctx, grid, st, vol, o, d, t_min, t_max):
        out, acc = _forward(vol, grid, st, o, d, t_min, t_max, keep_acc=True)
        ctx.vol, ctx.n_rows = vol, grid.shape[0]
        ctx.ranges = [None if isinstance(t, torch.Tensor) else t for t in (t_min, t_max)]
        tensors = [t for t in (t_min, t_max) if isinstance(t, torch.Tensor)]
        ctx.save_for_backward(st, o, d, out, acc, *tensors)
        return out

    @staticmethod
    def backward(ctx, g):
        st, o, d, out, acc, *tensors = ctx.saved_tensors
        t_min, t_max = (tensors.pop(0) if r is None else r for r in ctx.ranges)
        g_grid, g_st = _backward(ctx.vol, ctx.n_rows, st, o, d, t_min, t_max, g, out, acc)
        need = ctx.needs_input_grad
        return (g_grid if need[0] else None, g_st if need[1] else None) + (None,) * 5


def _lanes(t, batch):
    """A range bound over the flattened lanes: a scalar as it is, a tensor
    broadcast to the lanes' shape and flattened."""
    if isinstance(t, torch.Tensor) and t.dim() > 0:
        return t.expand(batch).reshape(-1)
    return t


def transmittance(vol: Grid, grid, st, o, d, t_min, t_max):
    """The volume's factor where(act, exp(-tau), 1) along [t_min, t_max],
    (..., 3) for o, d (..., 3); t_min / t_max scalars or tensors that
    broadcast to the lanes. `grid`: the flat grid buffer; st (3,): the
    volume's sigma_a + sigma_s. Differentiable in `grid` and `st`."""
    batch = o.shape[:-1]
    args = (vol, o.reshape(-1, 3), d.reshape(-1, 3), _lanes(t_min, batch), _lanes(t_max, batch))
    if torch.is_grad_enabled() and (grid.requires_grad or st.requires_grad):
        out = _Transmittance.apply(grid, st, *args)
    else:
        out = _forward(args[0], grid, st, *args[1:], keep_acc=False)[0]
    return out.reshape(batch + (3,))
