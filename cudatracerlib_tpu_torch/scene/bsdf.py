"""BSDF evaluation and sampling (port of cudatracerlib_tpu/scene/bsdf.py).

Ported: DIFFUSE, DIELECTRIC, CONDUCTOR, ROUGHCONDUCTOR, ROUGHDIELECTRIC,
ROUGHPLASTIC;
any other type in the scene's static type set raises NotImplementedError.
Conventions as in the JAX package: directions are unit vectors in the local
shading frame (+z = normal), `wo` points to the previous vertex, eval
returns f * |cos_theta(wi)|, sample returns weight = f * |cos| / pdf, and
delta lobes report their discrete choice probability as pdf. Two-sided
types shade in the +z hemisphere. Every ported family is computed for every
lane and the per-lane tag selects (branch-free dispatch, as in JAX). The
render is forward only, so the JAX package's stop_gradients have no
counterpart here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..math import fresnel as fres
from ..math import frame as fr
from ..math import microfacet as mf
from ..math import warp
from ..math.rough_transmittance import rough_fdr, rough_transmittance
from ..math.vecmath import INV_PI, dot
from ..sampling.records import (
    E_DELTA_REFLECTION,
    E_DELTA_TRANSMISSION,
    E_DIFFUSE_REFLECTION,
    E_GLOSSY_REFLECTION,
    E_GLOSSY_TRANSMISSION,
    BSDFSample,
)

DIFFUSE = 0
ROUGHDIFFUSE = 1
DIELECTRIC = 2
THINDIELECTRIC = 3
ROUGHDIELECTRIC = 4
CONDUCTOR = 5
ROUGHCONDUCTOR = 6
PLASTIC = 7
ROUGHPLASTIC = 8
PHONG = 9
WARD = 10
COATING = 11
ROUGHCOATING = 12
BLEND = 13
HK = 14
NULL_BSDF = 15

PORTED = (DIFFUSE, DIELECTRIC, ROUGHDIELECTRIC, CONDUCTOR, ROUGHCONDUCTOR, ROUGHPLASTIC)
_TWO_SIDED = (DIFFUSE, ROUGHDIFFUSE, CONDUCTOR, ROUGHCONDUCTOR, PLASTIC,
              ROUGHPLASTIC, PHONG, WARD)


class MatParams(NamedTuple):
    """Per-lane material parameters after texture evaluation."""

    bsdf_type: torch.Tensor     # (...,) int32
    dist_type: torch.Tensor     # (...,) int32 microfacet NDF
    albedo: torch.Tensor        # (..., 3) diffuse reflectance
    specular: torch.Tensor      # (..., 3)
    transmittance: torch.Tensor  # (..., 3)
    eta: torch.Tensor           # (...,)
    cond_eta: torch.Tensor      # (..., 3)
    cond_k: torch.Tensor        # (..., 3)
    alpha_u: torch.Tensor       # (...,)
    alpha_v: torch.Tensor       # (...,)
    exponent: torch.Tensor      # (...,)
    nonlinear: torch.Tensor     # (...,)
    blend_weight: torch.Tensor  # (...,)


def check_ported(active):
    if active is None or not set(active) <= set(PORTED):
        raise NotImplementedError(f"bsdf types {active}: only {PORTED} are ported")


def _mulz(v, s):
    """Multiply the z component by the per-lane sign s."""
    return torch.cat([v[..., :2], v[..., 2:3] * s[..., None]], dim=-1)


def _flip_sign(mp: MatParams, wo):
    """Two-sided adapter: opaque BSDFs are shaded in the +z hemisphere."""
    two_sided = torch.zeros(mp.bsdf_type.shape, dtype=torch.bool, device=wo.device)
    for t in _TWO_SIDED:
        two_sided = two_sided | (mp.bsdf_type == t)
    return torch.where(two_sided & (wo[..., 2] < 0.0), -1.0, 1.0)


def _mirror(wo):
    return torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)


def _unit(v):
    return v / torch.clamp(torch.sqrt(dot(v, v, keepdims=True)), min=1e-12)


def _stype(like, flag):
    return torch.full(like.shape, flag, dtype=torch.int32, device=like.device)


def _diffuse_eval(mp, wo, wi):
    valid = (fr.cos_theta(wo) > 0) & (fr.cos_theta(wi) > 0)
    f = mp.albedo * (INV_PI * torch.clamp(fr.cos_theta(wi), min=0.0))[..., None]
    return (torch.where(valid[..., None], f, 0.0),
            torch.where(valid, warp.square_to_cosine_hemisphere_pdf(wi), 0.0))


def _diffuse_sample(mp, wo, u2):
    wi = warp.square_to_cosine_hemisphere(u2)
    pdf = warp.square_to_cosine_hemisphere_pdf(wi)
    f, _ = _diffuse_eval(mp, wo, wi)
    weight = f / torch.clamp(pdf, min=1e-12)[..., None]
    valid = fr.cos_theta(wo) > 0
    return (wi, torch.where(valid[..., None], weight, 0.0), torch.where(valid, pdf, 0.0),
            _stype(pdf, E_DIFFUSE_REFLECTION), torch.ones_like(pdf))


def _conductor_sample(mp, wo):
    F = fres.fresnel_conductor(fr.cos_theta(wo), mp.cond_eta, mp.cond_k)
    valid = fr.cos_theta(wo) > 0
    weight = torch.where(valid[..., None], mp.specular * F, 0.0)
    pdf = torch.where(valid, 1.0, 0.0)
    return _mirror(wo), weight, pdf, _stype(pdf, E_DELTA_REFLECTION), torch.ones_like(pdf)


def _dielectric_sample(mp, wo, u1):
    """Smooth dielectric: Fresnel-weighted choice of the mirror or the
    refracted direction (signed cos_t covers both sides). Radiance is
    compressed by 1/eta^2 on transmission."""
    F, cos_t, eta_it, eta_ti = fres.fresnel_dielectric(fr.cos_theta(wo), mp.eta)
    pick_reflect = u1 < F
    wi_t = torch.stack([-wo[..., 0] * eta_ti, -wo[..., 1] * eta_ti, cos_t], dim=-1)
    wi = torch.where(pick_reflect[..., None], _mirror(wo), wi_t)
    # F / F and (1 - F) / (1 - F), as the JAX package writes its
    # stop-gradient ratios: 1 wherever the lobe can be picked
    r_refl = F / torch.clamp(F, min=1e-12)
    r_trans = (1.0 - F) / torch.clamp(1.0 - F, min=1e-12)
    weight = torch.where(pick_reflect[..., None], mp.specular * r_refl[..., None],
                         mp.transmittance * (eta_ti * eta_ti * r_trans)[..., None])
    pdf = torch.where(pick_reflect, F, 1.0 - F)
    stype = torch.where(pick_reflect, E_DELTA_REFLECTION, E_DELTA_TRANSMISSION).to(torch.int32)
    return wi, weight, pdf, stype, torch.where(pick_reflect, 1.0, eta_it)


def _roughconductor_f_pdf(mp, wo, wi):
    valid = (fr.cos_theta(wo) > 0) & (fr.cos_theta(wi) > 0)
    m = _unit(wo + wi)
    d = mf.D(mp.dist_type, m, mp.alpha_u, mp.alpha_v)
    g = mf.G(mp.dist_type, wo, wi, m, mp.alpha_u, mp.alpha_v)
    F = fres.fresnel_conductor(dot(wo, m), mp.cond_eta, mp.cond_k)
    # f * cos_i = F D G / (4 cos_o): the cos_i of f cancels
    denom = 4.0 * torch.clamp(fr.cos_theta(wo), min=1e-6)
    f = mp.specular * F * (d * g / denom)[..., None]
    pdf_m = mf.pdf(mp.dist_type, wo, m, mp.alpha_u, mp.alpha_v)
    pdf = pdf_m / torch.clamp(4.0 * dot(wo, m).abs(), min=1e-8)
    return torch.where(valid[..., None], f, 0.0), torch.where(valid, pdf, 0.0)


def _roughconductor_sample(mp, wo, u2):
    m, _ = mf.sample(mp.dist_type, wo, mp.alpha_u, mp.alpha_v, u2)
    wi = 2.0 * dot(wo, m, keepdims=True) * m - wo
    f, pdf = _roughconductor_f_pdf(mp, wo, wi)
    weight = f / torch.clamp(pdf, min=1e-12)[..., None]
    valid = (fr.cos_theta(wo) > 0) & (fr.cos_theta(wi) > 0) & (pdf > 0)
    return (wi, torch.where(valid[..., None], weight, 0.0), torch.where(valid, pdf, 0.0),
            _stype(pdf, E_GLOSSY_REFLECTION), torch.ones_like(pdf))


def _roughdielectric_f_pdf(mp, wo, wi):
    """Walter et al. 2007 rough dielectric eval + pdf (radiance mode). The
    microfacet normal lives in the +z hemisphere; the NDF routines get
    sign(cos_o) * wo, as in `_roughdielectric_sample`."""
    ci, co = fr.cos_theta(wi), fr.cos_theta(wo)
    is_reflect = ci * co > 0.0
    eta = torch.where(co > 0, mp.eta, 1.0 / mp.eta)  # n_wi_side / n_wo_side

    m_r = wo + wi
    m_t = -(wo + wi * eta[..., None])
    m = _unit(torch.where(is_reflect[..., None], m_r, m_t))
    m = m * torch.sign(fr.cos_theta(m))[..., None]

    d = mf.D(mp.dist_type, m, mp.alpha_u, mp.alpha_v)
    g = mf.G(mp.dist_type, wo, wi, m, mp.alpha_u, mp.alpha_v)
    wo_m = dot(wo, m)
    wi_m = dot(wi, m)
    F, _, _, _ = fres.fresnel_dielectric(wo_m, mp.eta)

    abs_co = torch.clamp(co.abs(), min=1e-6)
    f_r = F * d * g / (4.0 * abs_co)
    # transmission (Walter eq. 21; in radiance mode the eta_b^2 numerator
    # and the 1/eta^2 radiance compression cancel)
    denom_t = wo_m + eta * wi_m
    f_t = ((wo_m * wi_m).abs() * (1.0 - F) * d * g
           / torch.clamp(denom_t * denom_t * abs_co, min=1e-8))

    v_up = wo * torch.sign(co)[..., None]
    pdf_m = mf.pdf(mp.dist_type, v_up, m, mp.alpha_u, mp.alpha_v)
    jac_r = 1.0 / torch.clamp(4.0 * wi_m.abs(), min=1e-8)
    jac_t = (eta * eta * wi_m.abs()) / torch.clamp(denom_t * denom_t, min=1e-8)
    pdf = torch.where(is_reflect, F * pdf_m * jac_r, (1.0 - F) * pdf_m * jac_t)

    # sidedness: wo must see the front of m, wi the side of its mode
    valid_r = is_reflect & (wo_m * co > 0) & (wi_m * ci > 0)
    valid_t = (~is_reflect) & (wo_m * co > 0) & (wi_m * ci > 0)
    f = torch.where(valid_r[..., None], mp.specular * f_r[..., None],
                    torch.where(valid_t[..., None], mp.transmittance * f_t[..., None], 0.0))
    return f, torch.where(valid_r | valid_t, pdf, 0.0)


def _roughdielectric_sample(mp, wo, u2, u1):
    co = fr.cos_theta(wo)
    v_up = wo * torch.sign(co)[..., None]
    m, pdf_m = mf.sample(mp.dist_type, v_up, mp.alpha_u, mp.alpha_v, u2)  # m.z > 0
    wo_m = dot(wo, m)
    F, cos_t, eta_it, eta_ti = fres.fresnel_dielectric(wo_m, mp.eta)
    pick_reflect = u1 < F

    wi_r = 2.0 * wo_m[..., None] * m - wo
    # generalized refraction about m (signed cos_t from fresnel_dielectric)
    wi_t = m * (wo_m * eta_ti + cos_t)[..., None] - wo * eta_ti[..., None]
    wi = torch.where(pick_reflect[..., None], wi_r, wi_t)

    f, pdf = _roughdielectric_f_pdf(mp, wo, wi)
    weight = f / torch.clamp(pdf, min=1e-12)[..., None]
    valid = (pdf > 1e-12) & (pdf_m > 0)
    stype = torch.where(pick_reflect, E_GLOSSY_REFLECTION, E_GLOSSY_TRANSMISSION).to(torch.int32)
    return (wi, torch.where(valid[..., None], weight, 0.0), torch.where(valid, pdf, 0.0),
            stype, torch.where(pick_reflect, 1.0, eta_it))


def _roughplastic_diffuse(mp, wo, wi):
    """The rough plastic's diffuse term and its smooth F_o (the JAX
    `_plastic_terms` with rough=True): interface transmittances and the
    internal diffuse reflectance come from the baked rough tables; F_o only
    steers the sampling probabilities."""
    F_o, _, _, _ = fres.fresnel_dielectric(fr.cos_theta(wo), mp.eta)
    T_o = rough_transmittance(fr.cos_theta(wo), mp.alpha_u, mp.eta)
    T_i = rough_transmittance(fr.cos_theta(wi), mp.alpha_u, mp.eta)
    fdr = rough_fdr(mp.alpha_u, mp.eta)
    inv_eta2 = 1.0 / torch.clamp(mp.eta * mp.eta, min=1e-8)
    denom_lin = 1.0 - fdr[..., None]
    denom_nonlin = 1.0 - mp.albedo * fdr[..., None]
    denom = torch.where(mp.nonlinear[..., None] > 0.5, denom_nonlin, denom_lin)
    f_diff = (mp.albedo / torch.clamp(denom, min=1e-6)
              * (INV_PI * inv_eta2 * T_o * T_i * torch.clamp(fr.cos_theta(wi), min=0.0))[..., None])
    return f_diff, F_o


def _roughplastic_eval(mp, wo, wi):
    valid = (fr.cos_theta(wo) > 0) & (fr.cos_theta(wi) > 0)
    m = _unit(wo + wi)
    d = mf.D(mp.dist_type, m, mp.alpha_u, mp.alpha_v)
    g = mf.G(mp.dist_type, wo, wi, m, mp.alpha_u, mp.alpha_v)
    F_m, _, _, _ = fres.fresnel_dielectric(dot(wo, m), mp.eta)
    f_spec = mp.specular * (F_m * d * g / (4.0 * torch.clamp(fr.cos_theta(wo), min=1e-6)))[..., None]
    f_diff, F_o = _roughplastic_diffuse(mp, wo, wi)
    f = f_spec + f_diff

    prob_spec = torch.clamp(F_o, 0.25, 0.9)
    pdf_m = mf.pdf(mp.dist_type, wo, m, mp.alpha_u, mp.alpha_v)
    pdf_s = pdf_m / torch.clamp(4.0 * dot(wo, m).abs(), min=1e-8)
    pdf = prob_spec * pdf_s + (1.0 - prob_spec) * warp.square_to_cosine_hemisphere_pdf(wi)
    return torch.where(valid[..., None], f, 0.0), torch.where(valid, pdf, 0.0)


def _roughplastic_sample(mp, wo, u2, u1):
    F_o, _, _, _ = fres.fresnel_dielectric(fr.cos_theta(wo), mp.eta)
    pick_spec = u1 < torch.clamp(F_o, 0.25, 0.9)
    m, _ = mf.sample(mp.dist_type, wo, mp.alpha_u, mp.alpha_v, u2)
    wi_s = 2.0 * dot(wo, m, keepdims=True) * m - wo
    wi_d = warp.square_to_cosine_hemisphere(u2)
    wi = torch.where(pick_spec[..., None], wi_s, wi_d)
    f, pdf = _roughplastic_eval(mp, wo, wi)
    weight = f / torch.clamp(pdf, min=1e-12)[..., None]
    valid = (pdf > 1e-12) & (fr.cos_theta(wi) > 0)
    return (wi, torch.where(valid[..., None], weight, 0.0), torch.where(valid, pdf, 0.0),
            _stype(pdf, E_GLOSSY_REFLECTION), torch.ones_like(pdf))


# eval/pdf families in the JAX dispatch order; CONDUCTOR and DIELECTRIC are
# delta (eval 0)
_EVAL = [
    (DIFFUSE, _diffuse_eval),
    (ROUGHCONDUCTOR, _roughconductor_f_pdf),
    (ROUGHDIELECTRIC, _roughdielectric_f_pdf),
    (ROUGHPLASTIC, _roughplastic_eval),
]


def eval_bsdf(mp: MatParams, wo, wi, active=None):
    """f(wo, wi) * |cos_theta(wi)| and the solid-angle pdf; 0 for delta
    lobes. `active`: the static tuple of bsdf type tags in the scene; the
    families of absent tags are not computed."""
    check_ported(active)
    s = _flip_sign(mp, wo)
    wo_l, wi_l = _mulz(wo, s), _mulz(wi, s)
    f, pdf = 0.0, 0.0   # lanes of delta-only tags keep 0
    for tag, fn in _EVAL:
        if tag in active:
            fi, pi_ = fn(mp, wo_l, wi_l)
            m = mp.bsdf_type == tag
            f = torch.where(m[..., None], fi, f)
            pdf = torch.where(m, pi_, pdf)
    if isinstance(f, float):  # no tag with an eval family is active
        return torch.zeros(wo.shape, device=wo.device), torch.zeros(wo.shape[:-1], device=wo.device)
    return f, pdf


def pdf_bsdf(mp: MatParams, wo, wi, active=None):
    return eval_bsdf(mp, wo, wi, active)[1]


def sample_bsdf(mp: MatParams, wo, u2, u1, active=None) -> BSDFSample:
    """Importance-sample the BSDF. u2: (..., 2); u1: (...,)."""
    check_ported(active)
    s = _flip_sign(mp, wo)
    wo_l = _mulz(wo, s)
    makers = [
        (DIFFUSE, lambda: _diffuse_sample(mp, wo_l, u2)),
        (CONDUCTOR, lambda: _conductor_sample(mp, wo_l)),
        (DIELECTRIC, lambda: _dielectric_sample(mp, wo_l, u1)),
        (ROUGHCONDUCTOR, lambda: _roughconductor_sample(mp, wo_l, u2)),
        (ROUGHDIELECTRIC, lambda: _roughdielectric_sample(mp, wo_l, u2, u1)),
        (ROUGHPLASTIC, lambda: _roughplastic_sample(mp, wo_l, u2, u1)),
    ]
    wi, weight, pdf, stype, eta = 0.0, 0.0, 0.0, 0, 1.0  # every ported tag samples
    for tag, make in makers:
        if tag in active:
            wi_i, w_i, p_i, st_i, eta_i = make()
            m = mp.bsdf_type == tag
            wi = torch.where(m[..., None], wi_i, wi)
            weight = torch.where(m[..., None], w_i, weight)
            pdf = torch.where(m, p_i, pdf)
            stype = torch.where(m, st_i, stype)
            eta = torch.where(m, eta_i, eta)
    return BSDFSample(wi=_mulz(wi, s), weight=weight, pdf=pdf, sampled_type=stype, eta=eta)


def is_delta(mp: MatParams):
    """Lanes whose lobe light sampling can never hit (pure delta)."""
    t = mp.bsdf_type
    return (t == CONDUCTOR) | (t == DIELECTRIC) | (t == THINDIELECTRIC)


def is_smooth(mp: MatParams):
    return ~is_delta(mp)
