"""Gauss-Legendre / Gauss-Lobatto quadrature (port of
cudatracerlib_tpu/math/quadrature.py; reference Math/Integrator.h:49-107).

`integrate` is the JAX package's fixed composite rule: `n_panels`
sub-intervals, each with the 7-point Gauss-Lobatto rule, vectorized over the
panels and any batch axes of the integrand (the reference's adaptive
recursion is replaced by a panel count).
"""
from __future__ import annotations

import numpy as np
import torch

# 7-point Gauss-Lobatto nodes / weights on [-1, 1] (degree-9 exactness); the
# nodes are the reference's m_alpha / m_beta / x1..x3 (Integrator.h:12-16)
_GL7_NODES = np.array(
    [-1.0, -np.sqrt(2.0 / 3.0), -1.0 / np.sqrt(5.0), 0.0,
     1.0 / np.sqrt(5.0), np.sqrt(2.0 / 3.0), 1.0],
    np.float64,
)
# the weights solve the Vandermonde system integrating x^0..x^6 exactly
_V = np.vander(_GL7_NODES, 7, increasing=True).T
_m = np.array([(1.0 - (-1.0) ** (k + 1)) / (k + 1) for k in range(7)])
_GL7_WEIGHTS = np.linalg.solve(_V, _m)


def _f32(x, device):
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


def gauss_legendre(n: int, device="cuda"):
    """Nodes and weights of the n-point Gauss-Legendre rule on [-1, 1],
    float32 tensors on `device`."""
    x, w = np.polynomial.legendre.leggauss(n)
    return _f32(x, device), _f32(w, device)


def gauss_lobatto(n: int, device="cuda"):
    """Nodes and weights of the n-point Gauss-Lobatto rule on [-1, 1],
    endpoints included: the interior nodes are the roots of P'_{n-1}, the
    weights 2 / (n (n - 1) P_{n-1}(x)^2)."""
    if n < 2:
        raise ValueError("Gauss-Lobatto needs n >= 2")
    c = np.zeros(n)
    c[-1] = 1.0
    xi = np.polynomial.legendre.legroots(np.polynomial.legendre.legder(c))
    x = np.concatenate([[-1.0], np.sort(xi), [1.0]])
    pn1 = np.polynomial.legendre.legval(x, c)
    w = 2.0 / (n * (n - 1) * pn1 ** 2)
    return _f32(x, device), _f32(w, device)


def integrate(f, a, b, n_panels: int = 8):
    """Composite 7-point Gauss-Lobatto integral of `f` over [a, b].

    `f` maps a tensor of sample positions (the broadcast batch shape of a
    and b, then panels and nodes) to integrand values. a, b are numbers or
    batched tensors; the result has their broadcast batch shape, on the
    device of the tensor among them (else the card). Differentiable in a,
    b and f's parameters."""
    dev = next((x.device for x in (a, b) if isinstance(x, torch.Tensor)), torch.device("cuda"))
    a = torch.as_tensor(a, dtype=torch.float32, device=dev)
    b = torch.as_tensor(b, dtype=torch.float32, device=dev)
    nodes = _f32(_GL7_NODES, dev)
    weights = _f32(_GL7_WEIGHTS, dev)
    t = torch.linspace(0.0, 1.0, n_panels + 1, dtype=torch.float32, device=dev)
    lo = a[..., None] + (b - a)[..., None] * t[:-1]          # (..., P)
    hi = a[..., None] + (b - a)[..., None] * t[1:]
    mid = 0.5 * (lo + hi)
    half = 0.5 * (hi - lo)
    x = mid[..., None] + half[..., None] * nodes               # (..., P, 7)
    panel = (f(x) * weights).sum(-1) * half
    return panel.sum(-1)
