"""Adaptive 1-D function approximation by knot merging (port of
cudatracerlib_tpu/math/function_model.py; reference Math/FunctionModel.h
`MergingModel`).

An on-line piecewise-linear approximation of a 1-D function that keeps a
fixed number of knots by merging away the interior knot whose removal
changes the curve least. The knot table is a fixed-size sorted SoA tensor
with any batch shape (e.g. one model per pixel); an insert is a masked
shift and a merge collapses the cheapest knot.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class MergingModel(NamedTuple):
    xs: torch.Tensor   # (..., K) knot positions, ascending among the valid ones
    ys: torch.Tensor   # (..., K) knot values
    n: torch.Tensor    # (...,) int32 number of valid knots


def merging_init(n_knots: int, batch_shape=(), device="cuda") -> MergingModel:
    """Empty models of capacity n_knots on `device`; one spare slot holds
    the transient (n_knots + 1)-th knot between an insert and its merge."""
    shape = tuple(batch_shape) + (n_knots + 1,)
    return MergingModel(
        xs=torch.full(shape, torch.inf, dtype=torch.float32, device=device),
        ys=torch.zeros(shape, dtype=torch.float32, device=device),
        n=torch.zeros(tuple(batch_shape), dtype=torch.int32, device=device),
    )


def _merge_cost(xs, ys, n):
    """Cost of removing interior knot i (replacing it by the line through
    its neighbours): |error| * covered width; inf off the interior (the
    mask also hides the NaN of the +inf slots, so argmin never sees one)."""
    x_prev, x_next = torch.roll(xs, 1, -1), torch.roll(xs, -1, -1)
    y_prev, y_next = torch.roll(ys, 1, -1), torch.roll(ys, -1, -1)
    t = (xs - x_prev) / torch.clamp(x_next - x_prev, min=1e-12)
    y_lin = y_prev + t * (y_next - y_prev)
    cost = (ys - y_lin).abs() * (x_next - x_prev)
    idx = torch.arange(xs.shape[-1], device=xs.device)
    interior = (idx >= 1) & (idx < (n[..., None] - 1))
    return torch.where(interior, cost, torch.inf)


def merging_insert(m: MergingModel, x, y) -> MergingModel:
    """Insert (x, y), scalars broadcast over the batch (one insert per
    model); if the table is then over capacity, merge the cheapest interior
    knot."""
    K = m.xs.shape[-1]          # physical slots = capacity + 1
    cap = K - 1
    dev = m.xs.device
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, dtype=torch.float32, device=dev)

    # 1. shift-insert keeping xs sorted (invalid slots hold +inf, last)
    pos = (m.xs < x[..., None]).sum(-1)
    idx = torch.arange(K, device=dev)
    after = idx >= pos[..., None]
    xs2 = torch.where(after, torch.roll(m.xs, 1, -1), m.xs)
    ys2 = torch.where(after, torch.roll(m.ys, 1, -1), m.ys)
    at = idx == pos[..., None]
    xs2 = torch.where(at, x[..., None], xs2)
    ys2 = torch.where(at, y[..., None], ys2)
    n2 = m.n + 1                # <= K physically

    # 2. over capacity: merge the cheapest interior knot (argmin: the first)
    overfull = n2 > cap
    kill = torch.argmin(_merge_cost(xs2, ys2, n2), -1)
    keep_shift = idx >= kill[..., None]
    xs3 = torch.where(keep_shift, torch.roll(xs2, -1, -1), xs2)
    ys3 = torch.where(keep_shift, torch.roll(ys2, -1, -1), ys2)
    last = idx == K - 1
    xs3 = torch.where(last, torch.inf, xs3)
    ys3 = torch.where(last, 0.0, ys3)

    ov = overfull[..., None]
    return MergingModel(
        xs=torch.where(ov, xs3, xs2),
        ys=torch.where(ov, ys3, ys2),
        n=torch.where(overfull, cap, n2).to(torch.int32),
    )


def merging_eval(m: MergingModel, x):
    """Piecewise-linear evaluation at x (a scalar per model), clamped to the
    knot range."""
    K = m.xs.shape[-1]
    x = torch.as_tensor(x, dtype=torch.float32, device=m.xs.device)
    valid = torch.arange(K, device=m.xs.device) < m.n[..., None]
    xs = torch.where(valid, m.xs, torch.inf)
    hi = (xs <= x[..., None]).sum(-1)
    hi = torch.minimum(torch.clamp(hi, min=1), torch.clamp(m.n.to(torch.int64) - 1, min=1))
    lo = hi - 1
    pick = lambda a, i: torch.gather(a, -1, i[..., None])[..., 0]  # noqa: E731
    x0, x1 = pick(m.xs, lo), pick(m.xs, hi)
    y0, y1 = pick(m.ys, lo), pick(m.ys, hi)
    t = torch.clamp((x - x0) / torch.clamp(x1 - x0, min=1e-12), 0.0, 1.0)
    return torch.where(m.n <= 1, y0, y0 + t * (y1 - y0))
