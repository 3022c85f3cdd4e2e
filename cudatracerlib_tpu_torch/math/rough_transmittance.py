"""Rough dielectric energy transmittance: a baked closed form
(port of cudatracerlib_tpu/math/rough_transmittance.py:148-187).

T_rough(cos, alpha, eta) is the smooth Fresnel transmittance plus a fitted
tensor-polynomial correction in (alpha, cos, eta), and the rough internal
diffuse reflectance fdr_rough(alpha, eta) is the smooth closed form plus a
fitted correction. The coefficients below are the JAX package's, copied
verbatim; regenerating them (`generate_fits`) is not ported.

The monomial terms reach about 6e4 in float32 while their sum is of order
0.1, so the sum is taken in exactly the JAX loop order, and each power
x ** p by the same square-and-multiply sequence as XLA's integer_pow:
another order rounds to another result.
"""
from __future__ import annotations

import numpy as np
import torch

from .fresnel import fresnel_diffuse_reflectance, fresnel_dielectric

_NPA, _NPC, _NPE = 5, 8, 3   # alpha / cos / eta polynomial degrees
_CLAMP = dict(eta=(1.25, 2.0), alpha=(0.0, 0.6), cos=(0.15, 1.0))

COEFS_T = np.asarray([6.0949405, -2.1397936, 1.4868319, -74.789174, 31.073717, -30.576052, 385.34324, -172.73287, 197.35033, -1083.2183, 501.50406, -622.25504, 1790.8203, -838.99377, 1095.5481, -1738.1475, 816.41247, -1102.7875, 916.39005, -429.80024, 594.4325, -202.49111, 94.68063, -133.20762, -10.394773, 10.790672, -10.985649, 325.26207, -166.37367, 105.0943, -2319.2734, 1104.2275, -714.05868, 7650.8016, -3695.9008, 2697.683, -13848.49, 6834.5195, -5505.1696, 14218.007, -7130.7115, 6162.1816, -7780.6099, 3943.7512, -3582.7301, 1764.6507, -900.39811, 848.14892, -39.179493, -3.3220059, 8.745975, -445.38736, 273.3439, 2.6627497, 5427.1418, -2652.7554, 523.2302, -21049.22, 10394.927, -3972.0207, 41222.312, -20902.674, 10677.612, -44315.17, 22951.15, -13779.14, 24984.036, -13130.19, 8720.4327, -5784.7272, 3069.6331, -2181.6651, 128.85878, -33.37572, 24.285898, -50.036205, -44.131889, -431.27973, -5195.2525, 2477.4771, 1410.7332, 25090.229, -12292.066, -78.840877, -53452.594, 27190.973, -6490.562, 60081.047, -31418.878, 11966.962, -34810.067, 18548.025, -8783.4576, 8208.1755, -4428.2519, 2382.1925, -99.259356, 34.267294, -29.506087, 336.2826, -141.45317, 429.89928, 1538.6064, -644.54025, -1775.4475, -10800.613, 5107.0087, 2808.1222, 25408.587, -12761.481, -825.04569, -29916.131, 15596.492, -2534.5775, 17803.599, -9506.9789, 2816.5317, -4271.2977, 2316.819, -889.92907], np.float32)

COEFS_FDR = np.asarray([0.015608102, 0.33848641, -0.90287497, 0.1117453, -0.57163148, 1.3338325], np.float32)


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


def rough_transmittance(cos_i, alpha, eta):
    """Energy transmittance of a GGX rough dielectric interface, per lane
    (inputs clamp to the fitted domain)."""
    F, _, _, _ = fresnel_dielectric(cos_i, eta)
    e = torch.clamp(eta, *_CLAMP["eta"]) - 1.5
    a = torch.clamp(alpha, *_CLAMP["alpha"])
    c = torch.clamp(cos_i, *_CLAMP["cos"])
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
    return torch.clamp(1.0 - F + d, 0.0, 1.0)


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
