"""Dense ray / Woop-triangle intersection: the CUDA kernel and its plain version.

Port of the Pallas TPU kernel cudatracerlib_tpu/ops/intersect_pallas.py:89
(`intersect_dense`). The kernel lives in csrc/intersect_dense.cu (its header
note says what bounds it on the H100 and what the design does about it); it
is compiled with nvcc for sm_90a at first use into `_build/` and called
through a plain C interface with ctypes.

`intersect_dense` is the wrapper: it launches the kernel for CUDA tensors
and runs the plain PyTorch version for CPU tensors; it never falls back
from one to the other. `intersect_dense_plain` is the plain version of the
same contract (accel/traversal.py's brute force, with t_max clamped to 1e30
as the kernel's caller does), used by the CPU path and by the checks that
hold the kernel against it.
"""
from __future__ import annotations

import ctypes

import torch

from .._build_util import CudaKernel
from ..accel.traversal import Hit, intersect_brute_force

T_MAX_CLAMP = 1e30

# Kernel launches by mode; each launch of the CUDA kernel adds one here
# (plain-version calls do not).
launches = {"closest": 0, "any_hit": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_KERNEL = CudaKernel("intersect_dense", [_P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P])


def get_lib():
    """Build (once per source hash) and load the kernel's launch function."""
    return _KERNEL.get()


def _per_ray(x, n: int, device) -> torch.Tensor:
    """Scalar or (n,) range bound -> contiguous (n,) float32 on `device`."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if x.dim() > 1 or (x.dim() == 1 and x.shape[0] != n):
        raise ValueError(f"range bound of shape {tuple(x.shape)} for {n} rays")
    return x.expand(n).contiguous()


def _check(woop, o, d):
    if woop.dim() != 2 or woop.shape[1] != 12:
        raise ValueError(f"woop must be (T, 12), got {tuple(woop.shape)}")
    if o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"o, d must be (B, 3), got {tuple(o.shape)}, {tuple(d.shape)}")
    for name, x in (("woop", woop), ("o", o), ("d", d)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != o.device:
            raise ValueError(f"{name} is on {x.device}, rays on {o.device}")


def intersect_dense_plain(woop, o, d, t_min=1e-4, t_max=T_MAX_CLAMP) -> Hit:
    """Plain PyTorch version of the kernel's contract (closest hit; any-hit
    callers read only `.valid`, which a closest-hit sweep gives as well)."""
    _check(woop, o, d)
    t_max = torch.clamp(torch.as_tensor(t_max, dtype=torch.float32, device=o.device),
                        max=T_MAX_CLAMP)
    return intersect_brute_force(woop, o, d, t_min, t_max)


def intersect_dense(woop, o, d, t_min=1e-4, t_max=T_MAX_CLAMP, any_hit: bool = False) -> Hit:
    """Closest (or, with `any_hit`, some) hit of each ray over all triangles.

    woop (T, 12) float32; o, d (B, 3) float32; t_min / t_max scalars or (B,).
    Returns a Hit with t = t_max (clamped to 1e30) and prim = -1 on a miss.
    CUDA tensors go to the kernel, CPU tensors to the plain version."""
    if o.device.type == "cpu":
        return intersect_dense_plain(woop, o, d, t_min, t_max)
    if o.device.type != "cuda":
        raise ValueError(f"intersect_dense runs on cuda or cpu tensors, not {o.device}")
    _check(woop, o, d)
    woop, o, d = woop.contiguous(), o.contiguous(), d.contiguous()
    if woop.data_ptr() % 16:
        woop = woop.clone()  # the kernel stages rows as 16-byte loads
    B, T = o.shape[0], woop.shape[0]
    tmin = _per_ray(t_min, B, o.device)
    tmax = torch.clamp(_per_ray(t_max, B, o.device), max=T_MAX_CLAMP)
    t = torch.empty(B, dtype=torch.float32, device=o.device)
    prim = torch.empty(B, dtype=torch.int32, device=o.device)
    bary = torch.empty(B, 2, dtype=torch.float32, device=o.device)
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
    _KERNEL.launch(woop.data_ptr(), T, o.data_ptr(), d.data_ptr(), tmin.data_ptr(),
                   tmax.data_ptr(), B, int(bool(any_hit)), t.data_ptr(), prim.data_ptr(),
                   bary.data_ptr(), stream)
    launches["any_hit" if any_hit else "closest"] += 1
    return Hit(t=t, prim=prim, bary=bary, valid=prim >= 0)


def compare_hits(a: Hit, b: Hit, woop, t_min, t_max, any_hit: bool = False,
                 edge_eps: float = 1e-4) -> dict:
    """Where two intersectors disagree on the same rays, and whether each
    disagreement is edge-grazing.

    A ray that one side hits and the other misses is grazing when the hit
    lies within `edge_eps` of a triangle edge in barycentrics, or within
    `edge_eps` (relative) of t_min or t_max. Two hits at distinct Woop rows
    (equal rows are duplicates from leaf padding) are grazing when their t
    agree to `edge_eps` and either lies on an edge: a shared edge or a
    coincident triangle. With `any_hit` only `valid` is compared. Errors in
    t and the barycentrics are measured on rays both sides hit at equal rows.
    """
    B = a.valid.shape[0]
    t_min = torch.as_tensor(t_min, dtype=torch.float32, device=a.t.device).expand(B)
    t_max = torch.clamp(torch.as_tensor(t_max, dtype=torch.float32, device=a.t.device),
                        max=T_MAX_CLAMP).expand(B)

    def grazing(h: Hit):
        u, v = h.bary[:, 0], h.bary[:, 1]
        edge = torch.minimum(torch.minimum(u, v), 1.0 - u - v) <= edge_eps
        scale = torch.clamp(h.t.abs(), min=1.0) * edge_eps
        return edge | ((h.t - t_min).abs() <= scale) | ((h.t - t_max).abs() <= scale)

    one = a.valid ^ b.valid
    one_grazing = torch.where(a.valid, grazing(a), grazing(b))
    out = dict(rays=B, hits=int(a.valid.sum()), valid_mismatch=int(one.sum()),
               valid_mismatch_not_grazing=int((one & ~one_grazing).sum()))
    if any_hit:
        return out
    both = a.valid & b.valid
    rows_a = woop[torch.clamp(a.prim, min=0).long()]
    rows_b = woop[torch.clamp(b.prim, min=0).long()]
    same = both & (rows_a == rows_b).all(-1)
    prim_diff = both & ~same
    t_close = (a.t - b.t).abs() <= torch.clamp(a.t.abs(), min=1.0) * edge_eps
    prim_grazing = t_close & (grazing(a) | grazing(b))
    out.update(
        prim_mismatch=int(prim_diff.sum()),
        prim_mismatch_not_grazing=int((prim_diff & ~prim_grazing).sum()),
        max_abs_err_t=float((a.t - b.t)[same].abs().max()) if same.any() else 0.0,
        max_abs_err_bary=float((a.bary - b.bary)[same].abs().max()) if same.any() else 0.0,
    )
    return out
