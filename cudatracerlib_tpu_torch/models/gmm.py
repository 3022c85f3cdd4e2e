"""Batched on-line EM Gaussian mixture models (port of
cudatracerlib_tpu/models/gmm.py; reference
Kernel/ParametricModels/GaussianMixtureModel.h).

Every cell fits at once: the state is a struct of arrays over (C cells, K
components, D dims), the E-step a batched responsibility, the M-step
segment sums over the samples' cells blended with the stepwise-EM rate
eta = (t + 1)^-alpha. The segment sums are the deterministic row sum of
models/discretized.py. The covariances are at most 3x3, so their Cholesky
factor and the triangular solve are closed forms in plain tensor
arithmetic (`_cholesky`, `_solve_lower`), on the card and on the CPU alike,
rather than batched library solvers.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .discretized import segment_sum


class GMM(NamedTuple):
    weight: torch.Tensor   # (C, K) mixture weights (sum to 1 a cell)
    mean: torch.Tensor     # (C, K, D)
    cov: torch.Tensor      # (C, K, D, D)
    sw: torch.Tensor       # (C, K) accumulated responsibility mass
    t: torch.Tensor        # (C,) update counter


def gmm_init(n_cells: int, n_components: int, dim: int, spread: float = 0.25,
             domain: float = 1.0, device="cuda") -> GMM:
    """Means on a low-discrepancy lattice over [0, domain]^D, isotropic
    covariances (spread * domain)^2."""
    C, K, D = n_cells, n_components, dim
    idx = torch.arange(K, dtype=torch.float32, device=device) + 0.5
    base = torch.tensor([2, 3, 5, 7, 11, 13], dtype=torch.float32, device=device)
    cols = [torch.remainder(idx * torch.remainder(torch.sqrt(base[d % 6]), 1.0), 1.0)
            for d in range(D)]
    means = torch.stack(cols, -1) * domain
    cov = torch.eye(D, device=device) * (spread * domain) ** 2
    return GMM(weight=torch.full((C, K), 1.0 / K, device=device),
               mean=means.expand(C, K, D).contiguous(),
               cov=cov.expand(C, K, D, D).contiguous(),
               sw=torch.zeros(C, K, device=device), t=torch.zeros(C, device=device))


def _cholesky(a):
    """The lower Cholesky factor of SPD (..., D, D), D <= 3, in closed form."""
    D = a.shape[-1]
    if D > 3:
        raise NotImplementedError(f"closed-form Cholesky covers D <= 3, got {D}")
    L = [[None] * D for _ in range(D)]
    for i in range(D):
        for j in range(i + 1):
            s = a[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    zero = torch.zeros_like(a[..., 0, 0])
    return torch.stack([torch.stack([L[i][j] if j <= i else zero for j in range(D)], -1)
                        for i in range(D)], -2)


def _solve_lower(L, b):
    """x with L x = b for lower-triangular L (..., D, D), b (..., D)."""
    D = L.shape[-1]
    xs = []
    for i in range(D):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., i, k] * xs[k]
        xs.append(s / L[..., i, i])
    return torch.stack(xs, -1)


def _log_gauss(x, mean, cov):
    """log N(x | mean, cov), batched over leading axes."""
    D = x.shape[-1]
    chol = _cholesky(cov)
    sol = _solve_lower(chol, x - mean)
    maha = (sol * sol).sum(-1)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    return -0.5 * (maha + logdet + D * math.log(2.0 * math.pi))


def gmm_pdf(gmm: GMM, cell_id, x):
    """Mixture pdf at x (..., D) in cells cell_id (...,)."""
    c = cell_id.long()
    lg = _log_gauss(x[..., None, :], gmm.mean[c], gmm.cov[c])
    return (gmm.weight[c] * torch.exp(lg)).sum(-1)


def gmm_em_step(gmm: GMM, cell_id, x, sample_weight, alpha: float = 0.7,
                min_var: float = 1e-4) -> GMM:
    """One stepwise-EM mini-batch update: cell_id (N,), x (N, D),
    sample_weight (N,) >= 0. Cells that receive no samples keep their
    components."""
    C, K, D = gmm.mean.shape
    c = cell_id.long()

    # E-step: responsibilities under the current model
    lg = _log_gauss(x[:, None, :], gmm.mean[c], gmm.cov[c])
    logr = torch.log(torch.clamp(gmm.weight[c], min=1e-12)) + lg
    logr = logr - torch.logsumexp(logr, -1, keepdim=True)
    r = torch.exp(logr) * sample_weight[:, None]

    # M-step sufficient statistics a (cell, component)
    s0 = segment_sum(r, c, C)                                             # (C, K)
    s1 = segment_sum(r[..., None] * x[:, None, :], c, C)                  # (C, K, D)
    xxT = x[:, None, :, None] * x[:, None, None, :]
    s2 = segment_sum(r[..., None, None] * xxT, c, C)                      # (C, K, D, D)
    n_cell = segment_sum(sample_weight, c, C)

    got = n_cell > 0
    eta = torch.where(got, (gmm.t + 1.0) ** (-alpha), 0.0)
    tot = torch.clamp(s0.sum(-1, keepdim=True), min=1e-12)
    w_new = (1.0 - eta[:, None]) * gmm.weight + eta[:, None] * (s0 / tot)
    w_new = w_new / torch.clamp(w_new.sum(-1, keepdim=True), min=1e-12)

    upd = got[:, None] & (s0 > 1e-9)
    mean_batch = s1 / torch.clamp(s0[..., None], min=1e-12)
    mu_new = torch.where(upd[..., None],
                         (1.0 - eta[:, None, None]) * gmm.mean + eta[:, None, None] * mean_batch,
                         gmm.mean)
    cov_batch = (s2 / torch.clamp(s0[..., None, None], min=1e-12)
                 - mean_batch[..., :, None] * mean_batch[..., None, :])
    cov_new = torch.where(upd[..., None, None],
                          (1.0 - eta[:, None, None, None]) * gmm.cov
                          + eta[:, None, None, None] * cov_batch,
                          gmm.cov)
    cov_new = cov_new + torch.eye(D, device=x.device) * min_var
    return GMM(weight=w_new, mean=mu_new, cov=cov_new, sw=gmm.sw + s0,
               t=gmm.t + got.to(torch.float32))


def gmm_sample(gmm: GMM, cell_id, u_select, u_gauss):
    """One sample an entry: u_select (...,) picks the component by the
    weight CDF, u_gauss (..., D) standard normals map through its Cholesky
    factor."""
    c = cell_id.long()
    w = gmm.weight[c]
    cdf = torch.cumsum(w, -1)
    k = torch.clamp((cdf < u_select[..., None]).sum(-1), max=w.shape[-1] - 1)
    D = gmm.mean.shape[-1]
    mu = gmm.mean[c].gather(-2, k[..., None, None].expand(k.shape + (1, D)))[..., 0, :]
    cov = gmm.cov[c].gather(-3, k[..., None, None, None].expand(k.shape + (1, D, D)))[..., 0, :, :]
    chol = _cholesky(cov)
    return mu + torch.stack([(chol[..., i, :] * u_gauss).sum(-1) for i in range(D)], -1)
