"""Per-cell discretized (histogram) distributions (port of
cudatracerlib_tpu/models/discretized.py; reference
Kernel/ParametricModels/DiscretizedModel.h).

A fixed-bin histogram per cell, accumulated progressively, normalised
lazily, sampled by CDF inversion with the sample reused inside the bin.
The deposits (JAX's `segment_sum`) are summed by the deterministic row sum
of ops/shade_gather.py (`packed_gather_bwd`, one column): its kernels on
the card, its float64 plain version on the CPU, so a histogram is the same
on every run.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import shade_gather as sg_ops


class DiscretizedModel(NamedTuple):
    hist: torch.Tensor   # (C, B) accumulated mass per bin
    lo: float
    hi: float


def segment_sum(values, segment, n_segments: int):
    """(n_segments, ...) sums of `values` (N, ...) float32 by `segment` (N,)
    in [0, n_segments): the deterministic row sum, its rows cut into calls
    of at most MAX_BWD_COLS columns."""
    n = values.shape[0]
    flat = values.to(torch.float32).reshape(n, -1)
    seg = segment.to(torch.int32).reshape(-1)
    cols = sg_ops.MAX_BWD_COLS
    parts = [sg_ops.packed_gather_bwd(flat[:, k:k + cols].contiguous(), seg, n_segments)
             for k in range(0, flat.shape[1], cols)]
    return torch.cat(parts, 1).reshape((n_segments,) + tuple(values.shape[1:]))


def discretized_init(n_cells: int, n_bins: int, lo: float = 0.0, hi: float = 1.0,
                     device="cuda") -> DiscretizedModel:
    return DiscretizedModel(hist=torch.zeros(n_cells, n_bins, device=device), lo=lo, hi=hi)


def _bin(m: DiscretizedModel, x, n_bins: int):
    t = torch.clamp((x - m.lo) / (m.hi - m.lo), 0.0, 1.0 - 1e-6)
    return (t * n_bins).to(torch.int32)


def discretized_update(m: DiscretizedModel, cell_id, x, weight) -> DiscretizedModel:
    """Accumulate weighted samples x (N,) of cells cell_id (N,) into their
    bins."""
    C, B = m.hist.shape
    flat = cell_id.to(torch.int32) * B + _bin(m, x, B)
    return m._replace(hist=m.hist + segment_sum(weight, flat, C * B).reshape(C, B))


def histogram_density(samples, n_bins: int, lo: float = 0.0, hi: float = 1.0):
    """D-dimensional histogram density over [lo, hi]^D (reference
    Base/HistogramDensityEstimator.h): samples (N, D) -> (counts of shape
    (n_bins,) * D, the density normalised so a uniform distribution reads
    1 everywhere)."""
    N, D = samples.shape
    t = torch.clamp((samples - lo) / (hi - lo), 0.0, 1.0 - 1e-6)
    b = (t * n_bins).to(torch.int32)
    flat = torch.zeros(N, dtype=torch.int32, device=samples.device)
    for i in range(D):
        flat = flat * n_bins + b[:, i]
    counts = segment_sum(torch.ones(N, device=samples.device), flat, n_bins ** D)
    counts = counts.reshape((n_bins,) * D)
    return counts, counts / torch.clamp(counts.mean(), min=1e-12)


def discretized_pdf(m: DiscretizedModel, cell_id, x):
    C, B = m.hist.shape
    h = m.hist[cell_id.long()]
    tot = torch.clamp(h.sum(-1), min=1e-12)
    width = (m.hi - m.lo) / B
    return h.gather(-1, _bin(m, x, B).long()[..., None])[..., 0] / (tot * width)


def discretized_sample(m: DiscretizedModel, cell_id, u):
    """CDF inversion with the sample reused inside the bin (MonteCarlo.h
    sampleReuse): (x, pdf)."""
    C, B = m.hist.shape
    h = m.hist[cell_id.long()]
    tot = torch.clamp(h.sum(-1, keepdim=True), min=1e-12)
    cdf = torch.cumsum(h / tot, -1)
    b = torch.clamp((cdf < u[..., None]).sum(-1), max=B - 1)
    p_bin = h.gather(-1, b[..., None])[..., 0] / tot[..., 0]
    cdf_lo = torch.where(b > 0, cdf.gather(-1, torch.clamp(b - 1, min=0)[..., None])[..., 0], 0.0)
    frac = torch.clamp((u - cdf_lo) / torch.clamp(p_bin, min=1e-12), 0.0, 1.0)
    width = (m.hi - m.lo) / B
    return m.lo + (b.to(torch.float32) + frac) * width, p_bin / width
