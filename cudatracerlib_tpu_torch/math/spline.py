"""Catmull-Rom cubic spline interpolation, integration and sampling (port
of cudatracerlib_tpu/math/spline.py; reference Math/Spline.h, Mitsuba's
evalCubicInterp1D/2D/3D, integrateCubicInterp1D, sampleCubicInterp1D).

Uniform grids only. Positions may have any batch shape; lookups are
gathers, and `sample_1d` inverts the spline CDF with a fixed number of
bisection-safeguarded Newton steps, as the JAX package does, so its x and
pdf follow the same float32 iteration.
"""
from __future__ import annotations

import torch


def _catmull_rom_weights(t):
    """Hermite basis weights for the value pair and the derivative pair at
    local t."""
    t2 = t * t
    t3 = t2 * t
    w_v0 = 2.0 * t3 - 3.0 * t2 + 1.0
    w_v1 = -2.0 * t3 + 3.0 * t2
    w_d0 = t3 - 2.0 * t2 + t
    w_d1 = t3 - t2
    return w_v0, w_v1, w_d0, w_d1


def _segment(x, size, lo, hi):
    """x in [lo, hi] -> (segment index i int64, local parameter t in [0, 1])."""
    u = (x - lo) / (hi - lo) * (size - 1)
    i = torch.clamp(torch.floor(u).to(torch.int32), 0, size - 2).to(torch.int64)
    t = u - i.to(u.dtype)
    return i, torch.clamp(t, 0.0, 1.0)


def _gather_last(values, i):
    """Element-wise gather along the last axis; `values`' batch dims
    broadcast against i's shape (the 2D / 3D tensor-product paths)."""
    size = values.shape[-1]
    i = torch.clamp(i, 0, size - 1)
    if values.dim() == 1:
        return values[i]
    v = values.expand(i.shape + (size,))
    return torch.gather(v, -1, i[..., None])[..., 0]


def _derivs(values, i):
    """Values and Catmull-Rom derivatives at nodes i and i + 1: central
    differences inside, one-sided at the ends, in units of segments."""
    size = values.shape[-1]
    v_m1 = _gather_last(values, i - 1)
    v_0 = _gather_last(values, i)
    v_1 = _gather_last(values, i + 1)
    v_2 = _gather_last(values, i + 2)
    d0 = torch.where(i > 0, 0.5 * (v_1 - v_m1), v_1 - v_0)
    d1 = torch.where(i + 2 < size, 0.5 * (v_2 - v_0), v_1 - v_0)
    return v_0, v_1, d0, d1


def _hermite(t, v0, v1, d0, d1):
    w_v0, w_v1, w_d0, w_d1 = _catmull_rom_weights(t)
    return w_v0 * v0 + w_v1 * v1 + w_d0 * d0 + w_d1 * d1


def eval_1d(x, values, lo=0.0, hi=1.0, extrapolate: bool = False):
    """Catmull-Rom interpolation of `values` (a uniform grid on [lo, hi])
    at x. Batched over x; differentiable in x and values. Outside [lo, hi]
    it is 0 unless `extrapolate`."""
    values = torch.as_tensor(values, device=x.device)
    i, t = _segment(x, values.shape[-1], lo, hi)
    y = _hermite(t, *_derivs(values, i))
    if not extrapolate:
        y = torch.where((x >= lo) & (x <= hi), y, 0.0)
    return y


def integrate_1d(values, lo=0.0, hi=1.0):
    """Per-node cumulative integral of the interpolant: cdf[0] = 0,
    cdf[-1] = the total. Per segment (v0 + v1) / 2 + (d0 - d1) / 12, times
    the segment width."""
    values = torch.as_tensor(values)
    size = values.shape[-1]
    v0, v1, d0, d1 = _derivs(values, torch.arange(size - 1, device=values.device))
    width = (hi - lo) / (size - 1)
    seg = (0.5 * (v0 + v1) + (d0 - d1) / 12.0) * width
    # a running float32 sum, segment by segment (torch.cumsum accumulates
    # float32 in float64 on the CPU and in another order on the card)
    cdf = [torch.zeros_like(seg[..., 0])]
    for k in range(size - 1):
        cdf.append(cdf[-1] + seg[..., k])
    return torch.stack(cdf, -1)


def sample_1d(u, values, lo=0.0, hi=1.0, n_newton: int = 6):
    """Importance-sample x proportional to the interpolant of `values`.
    Returns (x, pdf(x)), batched over u: a searchsorted segment lookup on
    the CDF, then `n_newton` bisection-safeguarded Newton steps."""
    values = torch.as_tensor(values, device=u.device)
    size = values.shape[-1]
    cdf = integrate_1d(values, lo, hi)
    total = cdf[..., -1]
    target = u * total
    i = torch.clamp(torch.searchsorted(cdf, target, right=True) - 1, 0, size - 2)
    v0, v1, d0, d1 = _derivs(values, i)
    width = (hi - lo) / (size - 1)
    c0 = cdf[i]

    def seg_cdf(t):
        # the integral of the Hermite segment over [0, t], times the width
        t2 = t * t
        t3 = t2 * t
        t4 = t2 * t2
        iv0 = 0.5 * t4 - t3 + t
        iv1 = -0.5 * t4 + t3
        id0 = 0.25 * t4 - (2.0 / 3.0) * t3 + 0.5 * t2
        id1 = 0.25 * t4 - t3 / 3.0
        return (iv0 * v0 + iv1 * v1 + id0 * d0 + id1 * d1) * width

    t = torch.full_like(target, 0.5)
    t_lo = torch.zeros_like(t)
    t_hi = torch.ones_like(t)
    for _ in range(n_newton):
        err = c0 + seg_cdf(t) - target
        t_lo = torch.where(err < 0, t, t_lo)
        t_hi = torch.where(err > 0, t, t_hi)
        step = err / torch.clamp(_hermite(t, v0, v1, d0, d1) * width, min=1e-12)
        t_new = t - step
        bad = (t_new <= t_lo) | (t_new >= t_hi)
        t = torch.where(bad, 0.5 * (t_lo + t_hi), t_new)
    x = lo + (i.to(torch.float32) + t) * width
    pdf = _hermite(t, v0, v1, d0, d1) / torch.clamp(total, min=1e-12)
    return x, pdf


def eval_2d(p, values, lo=(0.0, 0.0), hi=(1.0, 1.0), extrapolate: bool = False):
    """Tensor-product Catmull-Rom on an (H, W) grid (or batched planes
    (..., H, W)) at p (..., 2) = (x, y): along x on the four bracketing
    rows, then along y."""
    values = torch.as_tensor(values, device=p.device)
    h, w = values.shape[-2], values.shape[-1]
    x, y = p[..., 0], p[..., 1]
    iy, ty = _segment(y, h, lo[1], hi[1])

    def row(r):
        r = torch.clamp(r, 0, h - 1)
        if values.dim() == 2:
            rows = values[r]
        else:  # batched planes from eval_3d: gather along the H axis
            v = values.expand(r.shape + values.shape[-2:])
            rows = torch.gather(v, -2, r[..., None, None].expand(r.shape + (1, w)))[..., 0, :]
        return eval_1d(x, rows, lo[0], hi[0], True)

    r_m1, r_0, r_1, r_2 = row(iy - 1), row(iy), row(iy + 1), row(iy + 2)
    d0 = torch.where(iy > 0, 0.5 * (r_1 - r_m1), r_1 - r_0)
    d1 = torch.where(iy + 2 < h, 0.5 * (r_2 - r_0), r_1 - r_0)
    out = _hermite(ty, r_0, r_1, d0, d1)
    if not extrapolate:
        inside = (x >= lo[0]) & (x <= hi[0]) & (y >= lo[1]) & (y <= hi[1])
        out = torch.where(inside, out, 0.0)
    return out


def eval_3d(p, values, lo=(0.0, 0.0, 0.0), hi=(1.0, 1.0, 1.0),
            extrapolate: bool = False):
    """Tensor-product Catmull-Rom on a (D, H, W) grid at p (..., 3) =
    (x, y, z)."""
    values = torch.as_tensor(values, device=p.device)
    d = values.shape[-3]
    z = p[..., 2]
    iz, tz = _segment(z, d, lo[2], hi[2])

    def plane(s):
        return eval_2d(p[..., :2], values[torch.clamp(s, 0, d - 1)], lo[:2], hi[:2], True)

    p_m1, p_0, p_1, p_2 = plane(iz - 1), plane(iz), plane(iz + 1), plane(iz + 2)
    d0 = torch.where(iz > 0, 0.5 * (p_1 - p_m1), p_1 - p_0)
    d1 = torch.where(iz + 2 < d, 0.5 * (p_2 - p_0), p_1 - p_0)
    out = _hermite(tz, p_0, p_1, d0, d1)
    if not extrapolate:
        inside = ((p[..., 0] >= lo[0]) & (p[..., 0] <= hi[0])
                  & (p[..., 1] >= lo[1]) & (p[..., 1] <= hi[1])
                  & (z >= lo[2]) & (z <= hi[2]))
        out = torch.where(inside, out, 0.0)
    return out
