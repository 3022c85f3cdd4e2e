"""Rough dielectric energy transmittance: a baked closed form and the
fit that bakes it (port of cudatracerlib_tpu/math/rough_transmittance.py).

T_rough(cos, alpha, eta) is the smooth Fresnel transmittance plus a fitted
tensor-polynomial correction in (alpha, cos, eta), and the rough internal
diffuse reflectance fdr_rough(alpha, eta) is the smooth closed form plus a
fitted correction. The coefficients below are the JAX package's, copied
verbatim. `generate_fits` regenerates them from scratch: a stratified
quadrature of the port's own rough-dielectric sampler weight over the
(eta, alpha, cos) grid on the given device (5,878,656 lanes at the default
72^2 strata, once at eta and once at 1 / eta), then the least squares on
the host in float64 numpy. It only checks the baked constants; nothing
reads its output at run time.

The monomial terms reach about 6e4 in float32 while their sum is of order
0.1, so the sum is taken in exactly the JAX loop order, and each power
x ** p by the same square-and-multiply sequence as XLA's integer_pow:
another order rounds to another result. The correction's gradient is its
closed-form derivative polynomial (`_Correction`), so autograd keeps three
tensors a call rather than every one of the 120 terms.
"""
from __future__ import annotations

import numpy as np
import torch

from .fresnel import fresnel_diffuse_reflectance, fresnel_dielectric

# fit grids (the practical domain; run-time inputs clamp to it)
_ETAS = np.linspace(1.25, 2.0, 7)
_ALPHAS = np.linspace(0.02, 0.6, 9)
_COSINES = np.linspace(0.15, 1.0, 18)
_NU = 72   # stratified u^2 grid per axis
_NPA, _NPC, _NPE = 5, 8, 3   # alpha / cos / eta polynomial degrees
_CLAMP = dict(eta=(1.25, 2.0), alpha=(0.0, 0.6), cos=(0.15, 1.0))

COEFS_T = np.asarray([6.0949405, -2.1397936, 1.4868319, -74.789174, 31.073717, -30.576052, 385.34324, -172.73287, 197.35033, -1083.2183, 501.50406, -622.25504, 1790.8203, -838.99377, 1095.5481, -1738.1475, 816.41247, -1102.7875, 916.39005, -429.80024, 594.4325, -202.49111, 94.68063, -133.20762, -10.394773, 10.790672, -10.985649, 325.26207, -166.37367, 105.0943, -2319.2734, 1104.2275, -714.05868, 7650.8016, -3695.9008, 2697.683, -13848.49, 6834.5195, -5505.1696, 14218.007, -7130.7115, 6162.1816, -7780.6099, 3943.7512, -3582.7301, 1764.6507, -900.39811, 848.14892, -39.179493, -3.3220059, 8.745975, -445.38736, 273.3439, 2.6627497, 5427.1418, -2652.7554, 523.2302, -21049.22, 10394.927, -3972.0207, 41222.312, -20902.674, 10677.612, -44315.17, 22951.15, -13779.14, 24984.036, -13130.19, 8720.4327, -5784.7272, 3069.6331, -2181.6651, 128.85878, -33.37572, 24.285898, -50.036205, -44.131889, -431.27973, -5195.2525, 2477.4771, 1410.7332, 25090.229, -12292.066, -78.840877, -53452.594, 27190.973, -6490.562, 60081.047, -31418.878, 11966.962, -34810.067, 18548.025, -8783.4576, 8208.1755, -4428.2519, 2382.1925, -99.259356, 34.267294, -29.506087, 336.2826, -141.45317, 429.89928, 1538.6064, -644.54025, -1775.4475, -10800.613, 5107.0087, 2808.1222, 25408.587, -12761.481, -825.04569, -29916.131, 15596.492, -2534.5775, 17803.599, -9506.9789, 2816.5317, -4271.2977, 2316.819, -889.92907], np.float32)

COEFS_FDR = np.asarray([0.015608102, 0.33848641, -0.90287497, 0.1117453, -0.57163148, 1.3338325], np.float32)

FIT_RESIDUAL = 0.013764


def _transmittance_grid(etas, alphas, cosines, nu: int = _NU, device="cuda"):
    """T_rough[e, a, c] (float64 numpy) by stratified quadrature of the
    port's GGX sampler over nu^2 strata: the transmit branch of the rough
    dielectric sample collapses to (1 - F) f_t / pdf once the u1 < F branch
    probability is applied analytically, and eta_it^2 turns radiance into
    energy."""
    from ..scene import bsdf as B
    from . import microfacet as mf

    k = (np.arange(nu) + 0.5) / nu
    u2 = np.stack(np.meshgrid(k, k, indexing="ij"), -1).reshape(-1, 2)
    NE, NA, NC, NU2 = len(etas), len(alphas), len(cosines), nu * nu
    eta, al, ci, uu = np.broadcast_arrays(
        etas[:, None, None, None], alphas[None, :, None, None],
        cosines[None, None, :, None], np.arange(NU2)[None, None, None, :])

    def dev32(x):
        return torch.from_numpy(np.ascontiguousarray(x.reshape(-1), np.float32)).to(device)

    eta, al, ci = dev32(eta), dev32(al), dev32(ci)
    u2b = torch.from_numpy(u2.astype(np.float32)).to(device)[
        torch.from_numpy(uu.reshape(-1)).to(device)]
    n = eta.shape[0]
    si = torch.sqrt(torch.clamp(1.0 - ci * ci, min=0.0))
    wo = torch.stack([si, torch.zeros_like(si), ci], -1)
    ones3 = torch.ones(n, 3, device=device)
    ggx = torch.ones(n, dtype=torch.int32, device=device)
    mp = B.MatParams(
        bsdf_type=torch.full((n,), B.ROUGHDIELECTRIC, dtype=torch.int32, device=device),
        dist_type=ggx, albedo=ones3, specular=ones3, transmittance=ones3, eta=eta,
        cond_eta=ones3, cond_k=ones3, alpha_u=al, alpha_v=al,
        exponent=torch.zeros(n, device=device), nonlinear=torch.zeros(n, device=device),
        blend_weight=torch.zeros(n, device=device))
    m, pdf_m = mf.sample(ggx, wo, al, al, u2b)
    wo_m = (wo * m).sum(-1)
    F, cos_t, eta_it, eta_ti = fresnel_dielectric(wo_m, eta)
    wi_t = m * (wo_m * eta_ti + cos_t)[..., None] - wo * eta_ti[..., None]
    f, pdf = B._roughdielectric_f_pdf(mp, wo, wi_t)
    ok = (pdf > 1e-12) & (pdf_m > 0) & (F < 1.0 - 1e-6)
    contrib = torch.where(ok, (1.0 - F) * f[..., 0] / torch.clamp(pdf, min=1e-12), 0.0)
    contrib = contrib * eta_it * eta_it
    T = contrib.reshape(NE, NA, NC, NU2).mean(-1).cpu().numpy()
    return T.astype(np.float64)


def _smooth_T(eta, ci, device="cuda"):
    F, _, _, _ = fresnel_dielectric(torch.as_tensor(np.asarray(ci, np.float32), device=device),
                                    torch.as_tensor(np.asarray(eta, np.float32), device=device))
    return (1.0 - F).cpu().numpy().astype(np.float64)


def _basis(eta, al, ci):
    e = np.asarray(eta) - 1.5
    a = np.asarray(al)
    c = np.asarray(ci)
    rows = []
    for pa in range(1, _NPA + 1):     # alpha factors (Delta(alpha = 0) = 0)
        for pc in range(_NPC):
            for pe in range(_NPE):
                rows.append((a ** pa) * (c ** pc) * (e ** pe))
    return np.stack(rows, -1)


def generate_fits(nu: int = _NU, device="cuda"):
    """Regenerate (coefs_T, coefs_fdr, (residual_T, residual_fdr)) from
    scratch: the quadrature on `device` at nu^2 strata (the baked constants
    came from nu = 72), the least squares in float64 numpy."""
    T = _transmittance_grid(_ETAS, _ALPHAS, _COSINES, nu, device)
    E, A, C = np.meshgrid(_ETAS, _ALPHAS, _COSINES, indexing="ij")
    Ts = _smooth_T(E.reshape(-1), C.reshape(-1), device).reshape(T.shape)
    X = _basis(E.reshape(-1), A.reshape(-1), C.reshape(-1))
    dT = (T - Ts).reshape(-1)
    coefs, *_ = np.linalg.lstsq(X, dT, rcond=None)
    resid = np.abs(X @ coefs - dT).max()

    # rough internal diffuse reflectance: fdr(alpha, eta) =
    # 1 - int 2 mu T_{1/eta}(mu, alpha) dmu (the table at the inverse eta)
    Tinv = _transmittance_grid(1.0 / _ETAS, _ALPHAS, _COSINES, nu, device)
    mu = _COSINES
    w = np.gradient(mu) * 2.0 * mu
    fdr = 1.0 - (Tinv * w[None, None, :]).sum(-1) / w.sum()
    # the smooth limit on the same mu grid and weights, so the domain
    # truncation cancels and the fit holds only the rough correction
    Tsm = _smooth_T(np.repeat(1.0 / _ETAS, len(mu)), np.tile(mu, len(_ETAS)),
                    device).reshape(len(_ETAS), len(mu))
    fdr_smooth_q = 1.0 - (Tsm * w[None, :]).sum(-1) / w.sum()
    dF = fdr - fdr_smooth_q[:, None]
    E2, A2 = np.meshgrid(_ETAS, _ALPHAS, indexing="ij")
    e = E2.reshape(-1) - 1.5
    a = A2.reshape(-1)
    Xf = np.stack([a, a * e, a * e * e, a * a, a * a * e, a * a * e * e], -1)
    cf, *_ = np.linalg.lstsq(Xf, dF.reshape(-1), rcond=None)
    residf = np.abs(Xf @ cf - dF.reshape(-1)).max()
    return coefs, cf, (float(resid), float(residf))


def _ipow(x, p: int):
    """x ** p for an integer p >= 0 by XLA's integer_pow sequence."""
    if p == 0:
        return torch.ones_like(x)
    acc = None
    while p > 0:
        if p & 1:
            acc = x if acc is None else acc * x
        p >>= 1
        if p > 0:
            x = x * x
    return acc


def _correction(a, c, e):
    """The fitted correction sum_i COEFS_T[i] a^pa c^pc e^pe, in the JAX
    loop order (pa 1.._NPA outermost, then pc, then pe)."""
    # each power is computed once and reused: the same values, fewer kernels
    pow_a = [_ipow(a, p) for p in range(_NPA + 1)]
    pow_c = [_ipow(c, p) for p in range(_NPC)]
    pow_e = [_ipow(e, p) for p in range(_NPE)]
    d = torch.zeros_like(c)
    i = 0
    for pa in range(1, _NPA + 1):
        for pc in range(_NPC):
            for pe in range(_NPE):
                d = d + float(COEFS_T[i]) * pow_a[pa] * pow_c[pc] * pow_e[pe]
                i += 1
    return d


def _powers(x, exps):
    """(..., len(exps)) of x^p and of its derivative p x^(p-1)."""
    pw = [_ipow(x, p) for p in exps]
    dpw = [p * _ipow(x, p - 1) if p else torch.zeros_like(x) for p in exps]
    return torch.stack(pw, -1), torch.stack(dpw, -1)


class _Correction(torch.autograd.Function):
    """`_correction` with its gradient from the derivative polynomials,
    evaluated in float64: in float32 their cancelling sums lose up to 0.6%
    of the largest derivative (up to 0.85% through autograd of the terms)."""

    @staticmethod
    def forward(ctx, a, c, e):
        ctx.save_for_backward(a, c, e)
        return _correction(a, c, e)

    @staticmethod
    def backward(ctx, g):
        a, c, e = (x.double() for x in ctx.saved_tensors)
        k = torch.from_numpy(COEFS_T).to(g.device, torch.float64).reshape(_NPA, _NPC, _NPE)
        pa, dpa = _powers(a, range(1, _NPA + 1))
        pc, dpc = _powers(c, range(_NPC))
        pe, dpe = _powers(e, range(_NPE))

        def poly(xa, xc, xe):
            return g * torch.einsum("...a,...c,...e,ace->...", xa, xc, xe, k).to(g.dtype)

        return poly(dpa, pc, pe), poly(pa, dpc, pe), poly(pa, pc, dpe)


def rough_transmittance(cos_i, alpha, eta):
    """Energy transmittance of a GGX rough dielectric interface, per lane
    (inputs clamp to the fitted domain)."""
    F, _, _, _ = fresnel_dielectric(cos_i, eta)
    e = torch.clamp(eta, *_CLAMP["eta"]) - 1.5
    a = torch.clamp(alpha, *_CLAMP["alpha"])
    c = torch.clamp(cos_i, *_CLAMP["cos"])
    return torch.clamp(1.0 - F + _Correction.apply(a, c, e), 0.0, 1.0)


def rough_fdr(alpha, eta):
    """Internal diffuse reflectance under a GGX rough interface (the
    plastic interreflection term)."""
    base = fresnel_diffuse_reflectance(eta)
    e = torch.clamp(eta, *_CLAMP["eta"]) - 1.5
    a = torch.clamp(alpha, *_CLAMP["alpha"])
    cf = [float(x) for x in COEFS_FDR]
    d = (cf[0] * a + cf[1] * a * e + cf[2] * a * e * e
         + cf[3] * a * a + cf[4] * a * a * e + cf[5] * a * a * e * e)
    return torch.clamp(base + d, 0.0, 1.0)
