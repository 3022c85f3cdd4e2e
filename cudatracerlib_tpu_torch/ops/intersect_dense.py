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
hold the kernel against it. The kernel sweeps only the chunks of
CHUNK_ROWS rows whose padded box (accel/bvh.py `chunk_boxes`) some lane of
its warp enters; `cull_sweep` is that per-lane cull in plain PyTorch, which
also counts the rows a ray's cull cannot skip (the work the bound charges).
"""
from __future__ import annotations

import ctypes

import torch

from .._build_util import CudaKernel
from ..accel.bvh import CHUNK_ROWS, chunk_boxes_from_woop
from ..accel.traversal import Hit, _slab_test, intersect_brute_force, intersect_woop
from ..utils.timing import CounterGroup, count

T_MAX_CLAMP = 1e30

# Kernel launches by mode, the counters launches.intersect_dense.<mode>;
# each launch of the CUDA kernel adds one here (plain-version calls do not).
launches = CounterGroup("launches.intersect_dense", ("closest", "any_hit"))

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_KERNEL = CudaKernel("intersect_dense",
                     [_P, _P, _I, _P, _P, _P, _F, _P, _F, _P, _I, _I, _P, _P, _P, _P])


def get_lib():
    """Build (once per source hash) and load the kernel's launch function."""
    return _KERNEL.get()


def range_arg(x, n: int, device):
    """A t_min / t_max bound as the kernels take it: (value, None) for a
    scalar, (0.0, contiguous (n,) float32 tensor on `device`) per ray. A
    0-dim tensor on the card is expanded, not read back (that would sync)."""
    if isinstance(x, torch.Tensor):
        if x.dim() == 0 and x.device.type == "cpu":
            return float(x), None
        x = x.to(device=device, dtype=torch.float32)
        if x.dim() > 1 or (x.dim() == 1 and x.shape[0] != n):
            raise ValueError(f"range bound of shape {tuple(x.shape)} for {n} rays")
        return 0.0, x.expand(n).contiguous()
    return float(x), None


def count_call(op: str, any_hit: bool, rays: int, rows: int) -> None:
    """Count one intersector call (a kernel launch on the card, the plain
    version on the CPU) and its size: `<op>.<mode>.calls`, `.rays` and
    `.rows`."""
    key = f"{op}.{'any_hit' if any_hit else 'closest'}"
    count(key + ".calls")
    count(key + ".rays", rays)
    count(key + ".rows", rows)


def aligned(x):
    """Contiguous, 16-byte aligned: the kernels read rows as float4."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _check(woop, o, d, verts):
    if woop.dim() != 2 or woop.shape[1] != 12:
        raise ValueError(f"woop must be (T, 12), got {tuple(woop.shape)}")
    if tuple(verts.shape) != tuple(woop.shape):
        raise ValueError(f"verts must be {tuple(woop.shape)}, got {tuple(verts.shape)}")
    if o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"o, d must be (B, 3), got {tuple(o.shape)}, {tuple(d.shape)}")
    for name, x in (("woop", woop), ("verts", verts), ("o", o), ("d", d)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != o.device:
            raise ValueError(f"{name} is on {x.device}, rays on {o.device}")


def intersect_dense_plain(woop, o, d, t_min=1e-4, t_max=T_MAX_CLAMP, *, verts) -> Hit:
    """Plain PyTorch version of the kernel's contract (closest hit; any-hit
    callers read only `.valid`, which a closest-hit sweep gives as well)."""
    _check(woop, o, d, verts)
    t_max = torch.clamp(torch.as_tensor(t_max, dtype=torch.float32, device=o.device),
                        max=T_MAX_CLAMP)
    return intersect_brute_force(woop, o, d, t_min, t_max, verts=verts)


def launch_args(woop, o, d, t_min=1e-4, t_max=T_MAX_CLAMP, any_hit: bool = False,
                boxes=None, *, verts):
    """(arguments of one kernel launch, its outputs t, prim, bary) for
    CUDA tensors: what `intersect_dense` launches, also for timing the
    kernel alone. `boxes` are the table's chunk boxes (BVH.chunk_boxes,
    derived from the Woop rows when None) and `verts` its vertex rows
    (BVH.tri_verts)."""
    _check(woop, o, d, verts)
    if boxes is None:
        boxes = chunk_boxes_from_woop(woop)
    n_chunk = -(-woop.shape[0] // CHUNK_ROWS)
    if tuple(boxes.shape) != (n_chunk, 8) or boxes.dtype != torch.float32 \
            or boxes.device != o.device:
        raise ValueError(f"boxes must be ({n_chunk}, 8) float32 on {o.device}, got "
                         f"{tuple(boxes.shape)} {boxes.dtype} on {boxes.device}")
    woop, verts, boxes = aligned(woop), aligned(verts), aligned(boxes)
    o, d = o.contiguous(), d.contiguous()
    B = o.shape[0]
    tmin_v, tmin = range_arg(t_min, B, o.device)
    tmax_v, tmax = range_arg(t_max, B, o.device)
    t = torch.empty(B, dtype=torch.float32, device=o.device)
    prim = torch.empty(B, dtype=torch.int32, device=o.device)
    bary = torch.empty(B, 2, dtype=torch.float32, device=o.device)
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
    args = (woop.data_ptr(), verts.data_ptr(), woop.shape[0], boxes.data_ptr(), o.data_ptr(),
            d.data_ptr(),
            tmin_v, None if tmin is None else tmin.data_ptr(), tmax_v,
            None if tmax is None else tmax.data_ptr(), B, int(bool(any_hit)), t.data_ptr(),
            prim.data_ptr(), bary.data_ptr(), stream)
    keep = (woop, verts, boxes, o, d, tmin, tmax)  # outlive the launch
    return (args, keep, o.device), (t, prim, bary)


def launch(prepared) -> None:
    """Launch the kernel with `launch_args`' arguments (not counted)."""
    args, _, device = prepared
    with torch.cuda.device(device):
        _KERNEL.launch(*args)


def intersect_dense(woop, o, d, t_min=1e-4, t_max=T_MAX_CLAMP, any_hit: bool = False,
                    boxes=None, *, verts) -> Hit:
    """Closest (or, with `any_hit`, some) hit of each ray over all triangles.

    woop (T, 12) float32; o, d (B, 3) float32; t_min / t_max scalars or (B,);
    boxes: the table's (ceil(T / CHUNK_ROWS), 8) chunk boxes, derived from
    `woop` when None; verts: its (T, 12) vertex rows (the BVH carries both). Returns a Hit with t = t_max (clamped to 1e30) and prim = -1 on a
    miss. CUDA tensors go to the kernel, CPU tensors to the plain version."""
    count_call("intersect_dense", any_hit, o.shape[0], woop.shape[0])
    if o.device.type == "cpu":
        return intersect_dense_plain(woop, o, d, t_min, t_max, verts=verts)
    if o.device.type != "cuda":
        raise ValueError(f"intersect_dense runs on cuda or cpu tensors, not {o.device}")
    prepared, (t, prim, bary) = launch_args(woop, o, d, t_min, t_max, any_hit, boxes,
                                            verts=verts)
    launch(prepared)
    launches.add("any_hit" if any_hit else "closest")
    return Hit(t=t, prim=prim, bary=bary, valid=prim >= 0)


def cull_sweep(woop, boxes, o, d, t_min=1e-4, t_max=T_MAX_CLAMP, ray_chunk: int = 1 << 16, *,
               verts):
    """The kernel's cull in plain PyTorch: chunks in ascending order, each
    swept for the rays whose range (t_min, best t so far) enters its box,
    rows in ascending order with a strict `<`. Returns (Hit, chunks, rows):
    per ray, the chunks whose box the ray enters over (t_min, its final t)
    and their rows, int64; no culled sweep can test fewer rows (the dense
    bound charges these). The Hit equals the all-rows sweep's bit for bit
    when no hit lies outside its row's box. `verts` are the rows' vertex
    rows."""
    _check(woop, o, d, verts)
    B, T, dev = o.shape[0], woop.shape[0], o.device
    t_min = torch.as_tensor(t_min, dtype=torch.float32, device=dev).expand(B)
    best_t = torch.clamp(torch.as_tensor(t_max, dtype=torch.float32, device=dev),
                         max=T_MAX_CLAMP).expand(B).clone()
    prim = torch.full((B,), -1, dtype=torch.int32, device=dev)
    bary = torch.zeros(B, 2, device=dev)
    inv_d = 1.0 / torch.where(d.abs() < 1e-20, torch.where(d < 0, -1e-20, 1e-20), d)
    lo, hi = boxes[:, 0:3], boxes[:, 4:7]
    for c in range(boxes.shape[0]):
        enter, _ = _slab_test(lo[c:c + 1], hi[c:c + 1], o, inv_d, t_min, best_t)
        sel = (enter & (t_min < best_t)).nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        rows = slice(c * CHUNK_ROWS, (c + 1) * CHUNK_ROWS)
        t, u, v, h = intersect_woop(woop[None, rows], o[sel, None], d[sel, None],
                                    t_min[sel, None], best_t[sel, None], verts=verts[None, rows])
        best = torch.where(h, t, torch.inf).argmin(-1, keepdim=True)
        won = h.any(-1)
        w = sel[won]
        best_t[w] = t.gather(-1, best)[won, 0]
        prim[w] = (c * CHUNK_ROWS + best[won, 0]).to(torch.int32)
        bary[w] = torch.cat([u.gather(-1, best), v.gather(-1, best)], -1)[won]
    rows_per_chunk = torch.clamp(T - CHUNK_ROWS * torch.arange(boxes.shape[0], device=dev),
                                 max=CHUNK_ROWS)
    n_chunks = torch.zeros(B, dtype=torch.int64, device=dev)
    n_rows = torch.zeros(B, dtype=torch.int64, device=dev)
    for s in range(0, B, ray_chunk):
        sl = slice(s, s + ray_chunk)
        enter, _ = _slab_test(lo[None], hi[None], o[sl, None], inv_d[sl, None],
                              t_min[sl, None], best_t[sl, None])
        enter = enter & (t_min[sl, None] < best_t[sl, None])
        n_chunks[sl] = enter.sum(-1)
        n_rows[sl] = (enter * rows_per_chunk).sum(-1)
    return Hit(t=best_t, prim=prim, bary=bary, valid=prim >= 0), n_chunks, n_rows


def _on_triangle(rows_a, bary_a, rows_b, t, edge_eps: float):
    """Whether the hit point of Woop rows `rows_a` at barycentrics `bary_a`
    lies on the triangles of `rows_b`: within edge_eps * max(1, |t|) of its
    plane and inside it to edge_eps in barycentrics (float64; the triangles
    are recovered from the rows, `woop_vertices`)."""
    from ..accel.bvh import woop_vertices

    va, ok_a = woop_vertices(rows_a)
    vb, ok_b = woop_vertices(rows_b)
    u, v = bary_a[:, 0:1].double(), bary_a[:, 1:2].double()
    p = va[:, 0] + u * (va[:, 1] - va[:, 0]) + v * (va[:, 2] - va[:, 0])
    r = rows_b.double().reshape(-1, 3, 4)
    q = (r[:, :, :3] * p[:, None, :]).sum(-1) + r[:, :, 3]   # u, v, w of p in triangle b
    n_len = torch.linalg.norm(torch.linalg.cross(vb[:, 1] - vb[:, 0], vb[:, 2] - vb[:, 0]), dim=-1)
    inside = (q[:, 0] >= -edge_eps) & (q[:, 1] >= -edge_eps) & (q[:, 0] + q[:, 1] <= 1 + edge_eps)
    near = q[:, 2].abs() * n_len <= edge_eps * torch.clamp(t.double().abs(), min=1.0)
    return ok_a & ok_b & inside & near


def compare_hits(a: Hit, b: Hit, woop, t_min, t_max, any_hit: bool = False,
                 edge_eps: float = 1e-4) -> dict:
    """Where two intersectors disagree on the same rays, and whether each
    disagreement is edge-grazing.

    A ray that one side hits and the other misses is grazing when the hit
    lies within `edge_eps` of a triangle edge in barycentrics, or within
    `edge_eps` (relative) of t_min or t_max. Two hits at distinct Woop rows
    (equal rows are duplicates from leaf padding or spatial splits) are
    grazing when their t agree to `edge_eps` and either lies on an edge (a
    shared edge); they are coincident when their t agree and either hit
    point lies on the other's triangle (coplanar, overlapping triangles,
    such as the bigscene's box bottoms at z = 0: a tie that the order of
    the walk breaks). `prim_mismatch_coincident` counts the coincident
    ones, and `prim_mismatch_not_grazing` leaves out both kinds. With
    `any_hit` only `valid` is compared. Errors in t and the barycentrics
    are measured on rays both sides hit at equal rows.
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
    coincident = torch.zeros_like(prim_diff)
    tie = prim_diff & t_close & ~prim_grazing
    if bool(tie.any()):
        ra, rb, ba, bb, ta = rows_a[tie], rows_b[tie], a.bary[tie], b.bary[tie], a.t[tie]
        coincident[tie] = (_on_triangle(ra, ba, rb, ta, edge_eps)
                           | _on_triangle(rb, bb, ra, ta, edge_eps))
    out.update(
        prim_mismatch=int(prim_diff.sum()),
        prim_mismatch_coincident=int(coincident.sum()),
        prim_mismatch_not_grazing=int((prim_diff & ~prim_grazing & ~coincident).sum()),
        max_abs_err_t=float((a.t - b.t)[same].abs().max()) if same.any() else 0.0,
        max_abs_err_bary=float((a.bary - b.bary)[same].abs().max()) if same.any() else 0.0,
    )
    return out
