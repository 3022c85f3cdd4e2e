"""BVH ray / Woop-triangle intersection: the CUDA kernel (a persistent
while-while traversal) and its plain version.

Port of the Pallas TPU kernel cudatracerlib_tpu/ops/cluster_trace.py:411
(`intersect_clusters`), which serves scenes above the dense band. The kernel
lives in csrc/intersect_bvh.cu (its header note says what bounds it on the
H100 and what the design does about it). It walks the port's own BVH
(accel/bvh.py) rather than the TPU kernel's cluster decomposition, which was
laid out for the MXU and for DMA streams.

`intersect_bvh` is the wrapper: CUDA tensors launch the kernel, CPU tensors
run the plain version, accel/traversal.py `intersect` (the JAX package's
lockstep oracle); it never falls back from one to the other. Misses return
t = t_max (unclamped) and prim = -1, as the oracle does.
"""
from __future__ import annotations

import ctypes

import torch

from .._build_util import CudaKernel
from ..accel.traversal import Hit, intersect
from ..utils.timing import CounterGroup
from .intersect_dense import aligned, count_call, range_arg

MAX_STEPS = 100_000

# Kernel launches by mode, the counters launches.intersect_bvh.<mode>; each
# launch of the CUDA kernel adds one here (plain-version calls do not).
launches = CounterGroup("launches.intersect_bvh", ("closest", "any_hit"))

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_KERNEL = CudaKernel("intersect_bvh",
                     [_P, _P, _P, _I, _I, _P, _P, _F, _P, _F, _P, _I, _I, _I, _P, _P, _P, _P, _P])


def get_lib():
    """Build (once per source hash) and load the kernel's launch function."""
    return _KERNEL.get()


def _check(bvh, o, d):
    if bvh.nodes.dim() != 2 or bvh.nodes.shape[1] != 16:
        raise ValueError(f"nodes must be (M, 16), got {tuple(bvh.nodes.shape)}")
    if bvh.woop.dim() != 2 or bvh.woop.shape[1] != 12:
        raise ValueError(f"woop must be (T, 12), got {tuple(bvh.woop.shape)}")
    if o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"o, d must be (B, 3), got {tuple(o.shape)}, {tuple(d.shape)}")
    if bvh.tri_verts is None or tuple(bvh.tri_verts.shape) != tuple(bvh.woop.shape):
        raise ValueError(f"tri_verts must be {tuple(bvh.woop.shape)}, got "
                         f"{None if bvh.tri_verts is None else tuple(bvh.tri_verts.shape)}")
    for name, x in (("nodes", bvh.nodes), ("woop", bvh.woop), ("tri_verts", bvh.tri_verts),
                    ("o", o), ("d", d)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != o.device:
            raise ValueError(f"{name} is on {x.device}, rays on {o.device}")


def intersect_bvh_plain(bvh, o, d, t_min=1e-4, t_max=torch.inf, any_hit: bool = False,
                        with_counts: bool = False, with_overflow: bool = False):
    """Plain PyTorch version of the kernel's contract (the lockstep oracle;
    its optional work and stack-overflow counts as `traversal.intersect`)."""
    _check(bvh, o, d)
    return intersect(bvh, o, d, t_min, t_max, any_hit=any_hit, max_steps=MAX_STEPS,
                     with_counts=with_counts, with_overflow=with_overflow)


def launch_args(bvh, o, d, t_min=1e-4, t_max=torch.inf, any_hit: bool = False,
                next_ray=None):
    """(arguments of one kernel launch, its outputs t, prim, bary) for
    CUDA tensors: what `intersect_bvh` launches, also for timing the kernel
    alone. `next_ray` is the zeroed int32 ray counter (a new one if None)."""
    _check(bvh, o, d)
    nodes, woop, verts = aligned(bvh.nodes), aligned(bvh.woop), aligned(bvh.tri_verts)
    o, d = o.contiguous(), d.contiguous()
    B = o.shape[0]
    tmin_v, tmin = range_arg(t_min, B, o.device)
    tmax_v, tmax = range_arg(t_max, B, o.device)
    if next_ray is None:
        next_ray = torch.zeros(1, dtype=torch.int32, device=o.device)
    t = torch.empty(B, dtype=torch.float32, device=o.device)
    prim = torch.empty(B, dtype=torch.int32, device=o.device)
    bary = torch.empty(B, 2, dtype=torch.float32, device=o.device)
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
    args = (nodes.data_ptr(), woop.data_ptr(), verts.data_ptr(), woop.shape[0], int(bvh.root_code), o.data_ptr(),
            d.data_ptr(), tmin_v, None if tmin is None else tmin.data_ptr(), tmax_v,
            None if tmax is None else tmax.data_ptr(), B, int(bool(any_hit)), MAX_STEPS,
            next_ray.data_ptr(), t.data_ptr(), prim.data_ptr(), bary.data_ptr(), stream)
    keep = (nodes, woop, verts, o, d, tmin, tmax, next_ray)  # outlive the launch
    return (args, keep, o.device), (t, prim, bary)


def launch(prepared) -> None:
    """Launch the kernel with `launch_args`' arguments (not counted)."""
    args, _, device = prepared
    with torch.cuda.device(device):  # the launch sizes its grid for this card
        _KERNEL.launch(*args)


def intersect_bvh(bvh, o, d, t_min=1e-4, t_max=torch.inf, any_hit: bool = False) -> Hit:
    """Closest (or, with `any_hit`, some) hit of each ray over the BVH.

    bvh: a BVH (nodes (M, 16), woop (T, 12) and tri_verts (T, 12) float32);
    o, d (B, 3) float32;
    t_min / t_max scalars or (B,). CUDA tensors go to the kernel, CPU
    tensors to the plain version."""
    count_call("intersect_bvh", any_hit, o.shape[0], bvh.woop.shape[0])
    if o.device.type == "cpu":
        return intersect_bvh_plain(bvh, o, d, t_min, t_max, any_hit=any_hit)
    if o.device.type != "cuda":
        raise ValueError(f"intersect_bvh runs on cuda or cpu tensors, not {o.device}")
    prepared, (t, prim, bary) = launch_args(bvh, o, d, t_min, t_max, any_hit)
    launch(prepared)
    launches.add("any_hit" if any_hit else "closest")
    return Hit(t=t, prim=prim, bary=bary, valid=prim >= 0)
