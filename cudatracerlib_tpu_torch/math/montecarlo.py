"""Monte-Carlo helpers (port of cudatracerlib_tpu/math/montecarlo.py):
MIS heuristics, discrete CDFs and their sampling with sample reuse, Russian
roulette."""
from __future__ import annotations

import torch


def balance_heuristic(n_f, pdf_f, n_g, pdf_g):
    f = n_f * pdf_f
    g = n_g * pdf_g
    return f / torch.clamp(f + g, min=1e-20)


def power_heuristic(n_f, pdf_f, n_g, pdf_g):
    """Veach power heuristic with beta=2."""
    f = n_f * pdf_f
    g = n_g * pdf_g
    return (f * f) / torch.clamp(f * f + g * g, min=1e-20)


def mis_weight(pdf_a, pdf_b):
    """Power-heuristic weight for strategy a vs b with one sample each."""
    return power_heuristic(1.0, pdf_a, 1.0, pdf_b)


def build_cdf(weights, axis: int = -1):
    """Normalized inclusive CDF along `axis`; returns (cdf, total). A zero
    total maps to the uniform CDF."""
    w = torch.clamp(weights, min=0.0)
    total = w.sum(axis, keepdim=True)
    uniform = torch.cumsum(torch.ones_like(w), axis) / w.shape[axis]
    cdf = torch.where(total > 0.0, torch.cumsum(w, axis) / torch.clamp(total, min=1e-30), uniform)
    return cdf, total.squeeze(axis)


def sample_discrete(cdf, u):
    """Sample an index from an inclusive normalized CDF (last axis).

    Returns (index, pmf, u_reused); u_reused is the sample rescaled to [0,1)
    within the chosen bin (the reference's `sampleReuse`). The last entry
    never counts as "below", so u >= cdf[-1] still lands in the final bin.
    """
    n = cdf.shape[-1]
    cdf_b = cdf.expand(u.shape + (n,))
    below = (cdf_b < u[..., None]) & (torch.arange(n, device=u.device) < n - 1)
    idx = below.sum(-1)
    hi = torch.where(below, torch.inf, cdf_b).amin(-1)
    lo = torch.where(below, cdf_b, 0.0).amax(-1)
    pmf = torch.clamp(hi - lo, min=0.0)
    u_reused = torch.clamp((u - lo) / torch.clamp(pmf, min=1e-20), 0.0, 1.0 - 1e-7)
    return idx, pmf, u_reused


def russian_roulette_prob(throughput_max, depth, start_depth: int, cap: float = 0.95):
    """Continuation probability at bounce `depth` (an int, or a per-lane
    tensor in the wavefront pool): min(max throughput, cap) from start_depth
    on, else 1."""
    p = torch.clamp(throughput_max, max=cap)
    if isinstance(depth, torch.Tensor):
        return torch.where(depth >= start_depth, p, 1.0)
    return p if depth >= start_depth else torch.ones_like(p)
