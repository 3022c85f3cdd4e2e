"""Microfacet distributions (Beckmann / GGX / Phong) with Smith shadowing
(port of cudatracerlib_tpu/math/microfacet.py:32-181).

Functions work in the local shading frame (+z = normal) on (..., 3)
directions, take a per-lane distribution tag and (alpha_x, alpha_y)
roughness. Every distribution is evaluated for every lane and the tag
selects, as in the JAX package; GGX samples visible normals (Heitz 2018).
"""
from __future__ import annotations

import torch

from ..utils.timing import upload
from . import frame as fr
from .vecmath import PI, cross, dot, safe_sqrt

BECKMANN = 0
GGX = 1
PHONG = 2


def _norm(v):
    return torch.sqrt(dot(v, v, keepdims=True))


def roughness_to_alpha(roughness):
    """Perceptual roughness -> alpha, clamped away from 0 for stability."""
    return torch.clamp(torch.as_tensor(roughness, dtype=torch.float32), min=1e-4)


def phong_exponent_from_alpha(alpha):
    return torch.div(2.0, torch.clamp(alpha * alpha, min=1e-8)) - 2.0


def D(dist_type, m, alpha_x, alpha_y):
    """NDF at the half vector m."""
    ct = fr.cos_theta(m)
    ct2 = ct * ct
    ax2 = alpha_x * alpha_x
    ay2 = alpha_y * alpha_y
    e = ((m[..., 0] ** 2 / torch.clamp(ax2, min=1e-12) + m[..., 1] ** 2 / torch.clamp(ay2, min=1e-12))
         / torch.clamp(ct2, min=1e-12))
    d_beck = torch.exp(-e) / torch.clamp(PI * alpha_x * alpha_y * ct2 * ct2, min=1e-12)
    denom = 1.0 + e
    d_ggx = 1.0 / torch.clamp(PI * alpha_x * alpha_y * ct2 * ct2 * denom * denom, min=1e-12)
    n_exp = phong_exponent_from_alpha(torch.sqrt(torch.clamp(alpha_x * alpha_y, min=1e-12)))
    d_phong = (n_exp + 2.0) / (2.0 * PI) * torch.pow(torch.clamp(ct, min=1e-12), n_exp)
    d = torch.where(dist_type == GGX, d_ggx, torch.where(dist_type == PHONG, d_phong, d_beck))
    return torch.where(ct > 0.0, d, 0.0)


def _proj_roughness2(v, alpha_x, alpha_y):
    """Squared projected roughness along v's azimuth."""
    st2 = fr.sin_theta2(v)
    cp2 = torch.where(st2 > 1e-9, v[..., 0] ** 2 / torch.clamp(st2, min=1e-9), 1.0)
    sp2 = torch.where(st2 > 1e-9, v[..., 1] ** 2 / torch.clamp(st2, min=1e-9), 0.0)
    return cp2 * alpha_x * alpha_x + sp2 * alpha_y * alpha_y


def smith_g1(dist_type, v, m, alpha_x, alpha_y):
    """Smith masking for one direction; 0 where v sees the back of m."""
    tan2 = fr.tan_theta2(v)
    a2 = _proj_roughness2(v, alpha_x, alpha_y)
    # clamped below at 1e-24 (= 1e-12 squared), not 0: the forward is the
    # same (a >= 1.6 there, so g_beck = 1), and the gradient of sqrt at 0 is
    # no longer inf (times the outer clamp's 0: the JAX form's NaN)
    a = 1.0 / torch.clamp(torch.sqrt(torch.clamp(a2 * tan2, min=1e-24)), min=1e-12)
    g_beck = torch.where(a >= 1.6, 1.0,
                         (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a))
    g_ggx = torch.div(2.0, 1.0 + torch.sqrt(1.0 + a2 * tan2))
    g = torch.where(dist_type == GGX, g_ggx, g_beck)
    front = dot(v, m) * fr.cos_theta(v) > 0.0
    return torch.where(front, g, 0.0)


def G(dist_type, wi, wo, m, alpha_x, alpha_y):
    """Separable Smith shadowing-masking."""
    return (smith_g1(dist_type, wi, m, alpha_x, alpha_y)
            * smith_g1(dist_type, wo, m, alpha_x, alpha_y))


def sample(dist_type, wi, alpha_x, alpha_y, u):
    """Sample a microfacet normal; returns (m, pdf). GGX samples visible
    normals w.r.t. wi, Beckmann and Phong sample the NDF (pdf = D cos_m)."""
    # GGX VNDF (Heitz 2018), anisotropic
    sign = torch.sign(fr.cos_theta(wi))[..., None]
    wi_up = wi * sign
    vh = torch.stack([alpha_x * wi_up[..., 0], alpha_y * wi_up[..., 1], wi_up[..., 2]], dim=-1)
    vh = vh / torch.clamp(_norm(vh), min=1e-12)
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-12))
    T1 = torch.where((lensq > 1e-9)[..., None],
                     torch.stack([-vh[..., 1] * inv, vh[..., 0] * inv, torch.zeros_like(inv)], -1),
                     upload("microfacet.sample", [1.0, 0.0, 0.0], vh.device).expand(vh.shape))
    T2 = cross(vh, T1)
    r = torch.sqrt(u[..., 0])
    phi = 2.0 * PI * u[..., 1]
    t1 = r * torch.cos(phi)
    t2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    t2 = (1.0 - s) * safe_sqrt(1.0 - t1 * t1) + s * t2
    nh = (T1 * t1[..., None] + T2 * t2[..., None]
          + vh * safe_sqrt(1.0 - t1 * t1 - t2 * t2)[..., None])
    m_ggx = torch.stack([alpha_x * nh[..., 0], alpha_y * nh[..., 1],
                         torch.clamp(nh[..., 2], min=1e-6)], dim=-1)
    m_ggx = m_ggx / torch.clamp(_norm(m_ggx), min=1e-12)
    pdf_ggx = pdf(torch.full_like(dist_type, GGX), wi, m_ggx, alpha_x, alpha_y)

    # Beckmann NDF sampling, azimuth stretched for anisotropy
    phi_b = 2.0 * PI * u[..., 1]
    phi_a = torch.atan2(alpha_y * torch.sin(phi_b), alpha_x * torch.cos(phi_b))
    cp, sp = torch.cos(phi_a), torch.sin(phi_a)
    a2inv = (cp * cp / torch.clamp(alpha_x * alpha_x, min=1e-12)
             + sp * sp / torch.clamp(alpha_y * alpha_y, min=1e-12))
    log_u = torch.log(torch.clamp(1.0 - u[..., 0], min=1e-12))
    tan2_b = -log_u / torch.clamp(a2inv, min=1e-12)
    ct_b = 1.0 / torch.sqrt(1.0 + tan2_b)
    st_b = safe_sqrt(1.0 - ct_b * ct_b)
    m_beck = torch.stack([st_b * cp, st_b * sp, ct_b], dim=-1)
    pdf_beck = D(torch.full_like(dist_type, BECKMANN), m_beck, alpha_x, alpha_y) * ct_b

    # Phong NDF sampling
    n_exp = phong_exponent_from_alpha(torch.sqrt(torch.clamp(alpha_x * alpha_y, min=1e-12)))
    ct_p = torch.pow(torch.clamp(u[..., 0], min=1e-12), 1.0 / (n_exp + 2.0))
    st_p = safe_sqrt(1.0 - ct_p * ct_p)
    m_phong = torch.stack([st_p * torch.cos(phi_b), st_p * torch.sin(phi_b), ct_p], dim=-1)
    pdf_phong = D(torch.full_like(dist_type, PHONG), m_phong, alpha_x, alpha_y) * ct_p

    is_ggx = dist_type == GGX
    is_phong = dist_type == PHONG
    m = torch.where(is_ggx[..., None], m_ggx, torch.where(is_phong[..., None], m_phong, m_beck))
    p = torch.where(is_ggx, pdf_ggx, torch.where(is_phong, pdf_phong, pdf_beck))
    return m, torch.clamp(p, min=0.0)


def pdf(dist_type, wi, m, alpha_x, alpha_y):
    """pdf of `sample` w.r.t. the solid angle of m."""
    d = D(dist_type, m, alpha_x, alpha_y)
    g1 = smith_g1(torch.full_like(dist_type, GGX), wi, m, alpha_x, alpha_y)
    pdf_vndf = g1 * dot(wi, m).abs() * d / torch.clamp(fr.abs_cos_theta(wi), min=1e-12)
    pdf_ndf = d * torch.clamp(fr.cos_theta(m), min=0.0)
    return torch.where(dist_type == GGX, pdf_vndf, pdf_ndf)
