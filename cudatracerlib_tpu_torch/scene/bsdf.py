"""BSDF evaluation and sampling (port of cudatracerlib_tpu/scene/bsdf.py).

Every BSDF tag of the JAX package is ported: the closed-form families
(DIFFUSE, ROUGHDIFFUSE, DIELECTRIC, THINDIELECTRIC, ROUGHDIELECTRIC,
CONDUCTOR, ROUGHCONDUCTOR, PLASTIC, ROUGHPLASTIC, PHONG, WARD, HK), NULL_BSDF
(no family: its lanes keep zero weight and pdf, as in JAX) and the nested
COATING / ROUGHCOATING / BLEND through `eval_bsdf_nested` and
`sample_bsdf_nested`. A nested tag has no family of its own in `eval_bsdf` /
`sample_bsdf`, so an engine that calls those alone gives its lanes zero
weight, as the JAX package's engines do.
Conventions as in the JAX package: directions are unit vectors in the local
shading frame (+z = normal), `wo` points to the previous vertex, eval
returns f * |cos_theta(wi)|, sample returns weight = f * |cos| / pdf, and
delta lobes report their discrete choice probability as pdf. Two-sided
types shade in the +z hemisphere. Every family whose tag is in the static
`active` set is computed for every lane and the per-lane tag selects
(branch-free dispatch, as in JAX); `active` is required.

Gradients follow the JAX package's detached estimator: sampled directions
and the pdfs that divide a sample's weight are detached (`_sg`) exactly
where the JAX package stops gradients. Its `_sg` sites (JAX bsdf.py) map
here as follows: 210-212 and 218 (smooth dielectric) to
`_dielectric_sample`; 233-240 to `_thindielectric_sample`; 265-267 to
`_roughconductor_sample`; 342-345 to `_roughdielectric_sample`; 410-414 to
`_plastic_sample`; 459-461 to `_roughplastic_sample`; 507-509 to
`_phong_sample`; 556-558 to `_ward_sample`; 613 to `_hk_sample`; 815-828
(COATING, BLEND) to `sample_bsdf_nested`; 49 is the helper itself.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..math import fresnel as fres
from ..math import frame as fr
from ..math import microfacet as mf
from ..math import warp
from ..math.rough_transmittance import rough_fdr, rough_transmittance
from ..math.vecmath import INV_PI, PI, dot, safe_sqrt
from ..sampling.records import (
    E_DELTA_REFLECTION,
    E_DELTA_TRANSMISSION,
    E_DIFFUSE_REFLECTION,
    E_GLOSSY_REFLECTION,
    E_GLOSSY_TRANSMISSION,
    E_NULL,
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

PORTED = tuple(range(16))
NESTED = (COATING, ROUGHCOATING, BLEND)
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
    """The port always passes the static type set; None (every family, the
    JAX default) and unknown tags are refused."""
    if active is None or not set(active) <= set(PORTED):
        raise NotImplementedError(f"bsdf types {active}: pass the static tuple of tags in {PORTED}")


def _sg(x):
    """stop_gradient: sampling decisions and the pdfs that divide sample
    weights are detached (the JAX package's detached estimator)."""
    return x.detach()


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


def _roughdiffuse_eval(mp, wo, wi):
    """Oren-Nayar (qualitative model); alpha_u is the roughness in radians."""
    valid = (fr.cos_theta(wo) > 0) & (fr.cos_theta(wi) > 0)
    sigma = mp.alpha_u
    s2 = sigma * sigma
    A = 1.0 - 0.5 * s2 / (s2 + 0.33)
    B = 0.45 * s2 / (s2 + 0.09)
    cos_dphi = fr.cos_phi(wi) * fr.cos_phi(wo) + fr.sin_phi(wi) * fr.sin_phi(wo)
    st_i, st_o = fr.sin_theta(wi), fr.sin_theta(wo)
    ct_i = torch.clamp(fr.cos_theta(wi), min=1e-6)
    ct_o = torch.clamp(fr.cos_theta(wo), min=1e-6)
    sin_alpha = torch.maximum(st_i, st_o)
    tan_beta = torch.minimum(st_i / ct_i, st_o / ct_o)
    f_scalar = INV_PI * (A + B * torch.clamp(cos_dphi, min=0.0) * sin_alpha * tan_beta)
    f = mp.albedo * (f_scalar * torch.clamp(fr.cos_theta(wi), min=0.0))[..., None]
    return (torch.where(valid[..., None], f, 0.0),
            torch.where(valid, warp.square_to_cosine_hemisphere_pdf(wi), 0.0))


def _diffuse_sample(mp, wo, u2, rough: bool = False):
    wi = warp.square_to_cosine_hemisphere(u2)
    pdf = warp.square_to_cosine_hemisphere_pdf(wi)
    f, _ = (_roughdiffuse_eval if rough else _diffuse_eval)(mp, wo, wi)
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
    # F / sg(F) and (1 - F) / sg(1 - F): 1 wherever the lobe can be picked,
    # and d(weight)/d(eta) stays unbiased through the discrete choice
    r_refl = F / torch.clamp(_sg(F), min=1e-12)
    r_trans = (1.0 - F) / torch.clamp(_sg(1.0 - F), min=1e-12)
    weight = torch.where(pick_reflect[..., None], mp.specular * r_refl[..., None],
                         mp.transmittance * (eta_ti * eta_ti * r_trans)[..., None])
    pdf = _sg(torch.where(pick_reflect, F, 1.0 - F))
    stype = torch.where(pick_reflect, E_DELTA_REFLECTION, E_DELTA_TRANSMISSION).to(torch.int32)
    return wi, weight, pdf, stype, torch.where(pick_reflect, 1.0, eta_it)


def _thindielectric_sample(mp, wo, u1):
    """Thin dielectric sheet: the mirror or the straight pass-through, with
    the internal bounces folded into R' = 2R / (1 + R)."""
    F, _, _, _ = fres.fresnel_dielectric(fr.cos_theta(wo).abs(), mp.eta)
    R = torch.where(F < 1.0, 2.0 * F / (1.0 + F), 1.0)
    pick_reflect = u1 < R
    wi = torch.where(pick_reflect[..., None], _mirror(wo), -wo)
    r_refl = R / torch.clamp(_sg(R), min=1e-12)
    r_trans = (1.0 - R) / torch.clamp(_sg(1.0 - R), min=1e-12)
    weight = torch.where(pick_reflect[..., None], mp.specular * r_refl[..., None],
                         mp.transmittance * r_trans[..., None])
    pdf = _sg(torch.where(pick_reflect, R, 1.0 - R))
    stype = torch.where(pick_reflect, E_DELTA_REFLECTION, E_NULL).to(torch.int32)
    return wi, weight, pdf, stype, torch.ones_like(pdf)


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
    wi = _sg(2.0 * dot(wo, m, keepdims=True) * m - wo)
    f, pdf = _roughconductor_f_pdf(mp, wo, wi)
    weight = f / torch.clamp(_sg(pdf), min=1e-12)[..., None]
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
    wi = _sg(torch.where(pick_reflect[..., None], wi_r, wi_t))

    f, pdf = _roughdielectric_f_pdf(mp, wo, wi)
    weight = f / torch.clamp(_sg(pdf), min=1e-12)[..., None]
    valid = (pdf > 1e-12) & (pdf_m > 0)
    stype = torch.where(pick_reflect, E_GLOSSY_REFLECTION, E_GLOSSY_TRANSMISSION).to(torch.int32)
    return (wi, torch.where(valid[..., None], weight, 0.0), torch.where(valid, pdf, 0.0),
            stype, torch.where(pick_reflect, 1.0, eta_it))


def _plastic_terms(mp, wi, T_o, T_i, fdr):
    """The plastic's diffuse term from the interface transmittances T_o,
    T_i and the internal diffuse reflectance fdr, smooth or rough (the
    JAX `_plastic_terms` after its choice of tables)."""
    inv_eta2 = 1.0 / torch.clamp(mp.eta * mp.eta, min=1e-8)
    denom_lin = 1.0 - fdr[..., None]
    denom_nonlin = 1.0 - mp.albedo * fdr[..., None]
    denom = torch.where(mp.nonlinear[..., None] > 0.5, denom_nonlin, denom_lin)
    return (mp.albedo / torch.clamp(denom, min=1e-6)
            * (INV_PI * inv_eta2 * T_o * T_i * torch.clamp(fr.cos_theta(wi), min=0.0))[..., None])


def _plastic_diffuse(mp, wo, wi):
    """The smooth plastic's diffuse term and F_o: smooth Fresnel
    transmittances and the smooth internal diffuse reflectance."""
    F_o, _, _, _ = fres.fresnel_dielectric(fr.cos_theta(wo), mp.eta)
    F_i, _, _, _ = fres.fresnel_dielectric(fr.cos_theta(wi), mp.eta)
    fdr = fres.fresnel_diffuse_reflectance(mp.eta)
    return _plastic_terms(mp, wi, 1.0 - F_o, 1.0 - F_i, fdr), F_o


def _plastic_eval(mp, wo, wi):
    valid = (fr.cos_theta(wo) > 0) & (fr.cos_theta(wi) > 0)
    f_diff, F_o = _plastic_diffuse(mp, wo, wi)
    pdf = (1.0 - F_o) * warp.square_to_cosine_hemisphere_pdf(wi)
    return torch.where(valid[..., None], f_diff, 0.0), torch.where(valid, pdf, 0.0)


def _plastic_sample(mp, wo, u2, u1):
    F_o, _, _, _ = fres.fresnel_dielectric(fr.cos_theta(wo), mp.eta)
    pick_spec = u1 < F_o
    wi = torch.where(pick_spec[..., None], _mirror(wo), warp.square_to_cosine_hemisphere(u2))
    f_diff, _ = _plastic_diffuse(mp, wo, wi)
    pdf_d = (1.0 - F_o) * warp.square_to_cosine_hemisphere_pdf(wi)
    r_spec = F_o / torch.clamp(_sg(F_o), min=1e-12)
    weight = torch.where(pick_spec[..., None], mp.specular * r_spec[..., None],
                         f_diff / torch.clamp(_sg(pdf_d), min=1e-12)[..., None])
    pdf = torch.where(pick_spec, F_o, pdf_d)
    valid = fr.cos_theta(wo) > 0
    stype = torch.where(pick_spec, E_DELTA_REFLECTION, E_DIFFUSE_REFLECTION).to(torch.int32)
    return (wi, torch.where(valid[..., None], weight, 0.0), torch.where(valid, pdf, 0.0),
            stype, torch.ones_like(pdf))


def _roughplastic_diffuse(mp, wo, wi):
    """The rough plastic's diffuse term and its smooth F_o (the JAX
    `_plastic_terms` with rough=True): interface transmittances and the
    internal diffuse reflectance come from the baked rough tables; F_o only
    steers the sampling probabilities."""
    F_o, _, _, _ = fres.fresnel_dielectric(fr.cos_theta(wo), mp.eta)
    T_o = rough_transmittance(fr.cos_theta(wo), mp.alpha_u, mp.eta)
    T_i = rough_transmittance(fr.cos_theta(wi), mp.alpha_u, mp.eta)
    return _plastic_terms(mp, wi, T_o, T_i, rough_fdr(mp.alpha_u, mp.eta)), F_o


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
    wi = _sg(torch.where(pick_spec[..., None], wi_s, wi_d))
    f, pdf = _roughplastic_eval(mp, wo, wi)
    weight = f / torch.clamp(_sg(pdf), min=1e-12)[..., None]
    valid = (pdf > 1e-12) & (fr.cos_theta(wi) > 0)
    return (wi, torch.where(valid[..., None], weight, 0.0), torch.where(valid, pdf, 0.0),
            _stype(pdf, E_GLOSSY_REFLECTION), torch.ones_like(pdf))


def _phong_lobe_weights(mp):
    ld = mp.albedo.mean(-1)
    ls = mp.specular.mean(-1)
    w_d = ld / torch.clamp(ld + ls, min=1e-6)
    return w_d, 1.0 - w_d


def _phong_eval(mp, wo, wi):
    """Modified Phong: kd / pi + ks (n + 2) / (2 pi) cos^n about the mirror
    direction."""
    valid = (fr.cos_theta(wo) > 0) & (fr.cos_theta(wi) > 0)
    cos_a = torch.clamp(dot(_mirror(wo), wi), min=0.0)
    n = mp.exponent
    f_spec = mp.specular * ((n + 2.0) * (0.5 / PI) * torch.pow(cos_a, n))[..., None]
    f = (mp.albedo * INV_PI + f_spec) * torch.clamp(fr.cos_theta(wi), min=0.0)[..., None]
    w_d, w_s = _phong_lobe_weights(mp)
    pdf_spec = (n + 1.0) * (0.5 / PI) * torch.pow(cos_a, n)
    pdf = w_d * warp.square_to_cosine_hemisphere_pdf(wi) + w_s * pdf_spec
    return torch.where(valid[..., None], f, 0.0), torch.where(valid, pdf, 0.0)


def _phong_sample(mp, wo, u2, u1):
    w_d, _ = _phong_lobe_weights(mp)
    pick_d = u1 < w_d
    wi_d = warp.square_to_cosine_hemisphere(u2)
    n = mp.exponent
    ct = torch.pow(torch.clamp(u2[..., 0], min=1e-12), 1.0 / (n + 1.0))
    st = safe_sqrt(1.0 - ct * ct)
    phi = 2.0 * PI * u2[..., 1]
    local = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)
    wi_s = fr.Frame.from_normal(_mirror(wo)).to_world(local)
    wi = _sg(torch.where(pick_d[..., None], wi_d, wi_s))
    f, pdf = _phong_eval(mp, wo, wi)
    weight = f / torch.clamp(_sg(pdf), min=1e-12)[..., None]
    valid = (pdf > 1e-12) & (fr.cos_theta(wi) > 0)
    return (wi, torch.where(valid[..., None], weight, 0.0), torch.where(valid, pdf, 0.0),
            _stype(pdf, E_GLOSSY_REFLECTION), torch.ones_like(pdf))


def _ward_eval(mp, wo, wi):
    """Anisotropic Ward-Duer, mixed with a cosine lobe by the Phong lobe
    weights."""
    valid = (fr.cos_theta(wo) > 0) & (fr.cos_theta(wi) > 0)
    h = wo + wi
    ax, ay = mp.alpha_u, mp.alpha_v
    ax2 = torch.clamp(ax * ax, min=1e-8)
    ay2 = torch.clamp(ay * ay, min=1e-8)
    hz2 = torch.clamp(h[..., 2] * h[..., 2], min=1e-12)
    expo = -(h[..., 0] ** 2 / ax2 + h[..., 1] ** 2 / ay2) / hz2
    ci = torch.clamp(fr.cos_theta(wi), min=1e-6)
    co = torch.clamp(fr.cos_theta(wo), min=1e-6)
    spec = torch.exp(expo) / (4.0 * PI * ax * ay * torch.sqrt(ci * co))
    f = (mp.albedo * INV_PI + mp.specular * spec[..., None]) * ci[..., None]

    hn = _unit(h)
    hz3 = torch.clamp(hn[..., 2] ** 3, min=1e-9)
    exph = -(hn[..., 0] ** 2 / ax2 + hn[..., 1] ** 2 / ay2) / torch.clamp(hn[..., 2] ** 2, min=1e-9)
    pdf_h = torch.exp(exph) / (PI * ax * ay * hz3)
    pdf_spec = pdf_h / torch.clamp(4.0 * dot(wo, hn).abs(), min=1e-8)
    w_d, w_s = _phong_lobe_weights(mp)
    pdf = w_d * warp.square_to_cosine_hemisphere_pdf(wi) + w_s * pdf_spec
    return torch.where(valid[..., None], f, 0.0), torch.where(valid, pdf, 0.0)


def _ward_sample(mp, wo, u2, u1):
    w_d, _ = _phong_lobe_weights(mp)
    pick_d = u1 < w_d
    wi_d = warp.square_to_cosine_hemisphere(u2)
    ax, ay = mp.alpha_u, mp.alpha_v
    phi = torch.atan2(ay * torch.sin(2.0 * PI * u2[..., 1]), ax * torch.cos(2.0 * PI * u2[..., 1]))
    cp, sp = torch.cos(phi), torch.sin(phi)
    denom = cp * cp / torch.clamp(ax * ax, min=1e-8) + sp * sp / torch.clamp(ay * ay, min=1e-8)
    tan2t = -torch.log(torch.clamp(u2[..., 0], min=1e-12)) / torch.clamp(denom, min=1e-8)
    ct = 1.0 / torch.sqrt(1.0 + tan2t)
    st = safe_sqrt(1.0 - ct * ct)
    h = torch.stack([st * cp, st * sp, ct], dim=-1)
    wi_s = 2.0 * dot(wo, h, keepdims=True) * h - wo
    wi = _sg(torch.where(pick_d[..., None], wi_d, wi_s))
    f, pdf = _ward_eval(mp, wo, wi)
    weight = f / torch.clamp(_sg(pdf), min=1e-12)[..., None]
    valid = (pdf > 1e-12) & (fr.cos_theta(wi) > 0)
    return (wi, torch.where(valid[..., None], weight, 0.0), torch.where(valid, pdf, 0.0),
            _stype(pdf, E_GLOSSY_REFLECTION), torch.ones_like(pdf))


def _hk_eval(mp, wo, wi):
    """Hanrahan-Krueger single-scattering slab, its reflection term.
    Parameters: sigma_s = |cond_eta|, sigma_a = |cond_k|, the slab's
    thickness = exponent, the Henyey-Greenstein g = alpha_u."""
    sigma_s = mp.cond_eta.abs()
    sigma_a = mp.cond_k.abs()
    sigma_t = torch.clamp(sigma_s + sigma_a, min=1e-6)
    w_alb = sigma_s / sigma_t
    tau = sigma_t * mp.exponent[..., None]
    ci = fr.cos_theta(wi).abs()
    co = fr.cos_theta(wo).abs()
    same = fr.cos_theta(wi) * fr.cos_theta(wo) > 0
    cos_g = -dot(wo, wi)
    g = mp.alpha_u
    g2 = g * g
    ph = (1.0 - g2) / torch.clamp(4.0 * PI * (1.0 + g2 - 2.0 * g * cos_g) ** 1.5, min=1e-8)
    denom = torch.clamp(ci + co, min=1e-6)
    atten = 1.0 - torch.exp(-tau * (1.0 / torch.clamp(ci, min=1e-4)
                                    + 1.0 / torch.clamp(co, min=1e-4))[..., None])
    f = w_alb * ph[..., None] * (ci / denom)[..., None] * atten
    valid = same & (ci > 1e-4) & (co > 1e-4)
    pdf = torch.where(valid, fr.abs_cos_theta(wi) * INV_PI * 0.5, 0.0)
    return torch.where(valid[..., None], f, 0.0), pdf


def _hk_sample(mp, wo, u2, u1):
    """Half the lanes reflect (cosine lobe on wo's side), half pass straight
    through, attenuated by the slab."""
    pick_refl = u1 < 0.5
    wi_r = _mulz(warp.square_to_cosine_hemisphere(u2), torch.sign(fr.cos_theta(wo)))
    wi = torch.where(pick_refl[..., None], wi_r, -wo)
    sigma_t = torch.clamp(mp.cond_eta.abs() + mp.cond_k.abs(), min=1e-6)
    tau = sigma_t * mp.exponent[..., None]
    trans = torch.exp(-tau / torch.clamp(fr.cos_theta(wo).abs(), min=1e-4)[..., None])
    f, pdf_r = _hk_eval(mp, wo, wi)
    w_refl = f / torch.clamp(_sg(pdf_r) * 0.5, min=1e-12)[..., None]
    weight = torch.where(pick_refl[..., None], w_refl, trans * 2.0)
    pdf = torch.where(pick_refl, 0.5 * pdf_r, 0.5)
    stype = torch.where(pick_refl, E_GLOSSY_REFLECTION, E_NULL).to(torch.int32)
    return wi, weight, pdf, stype, torch.ones_like(pdf)


# eval/pdf families in the JAX dispatch order; CONDUCTOR, DIELECTRIC and
# THINDIELECTRIC are delta (eval 0); NULL_BSDF and the nested tags have none
_EVAL = [
    (DIFFUSE, _diffuse_eval),
    (ROUGHDIFFUSE, _roughdiffuse_eval),
    (ROUGHCONDUCTOR, _roughconductor_f_pdf),
    (ROUGHDIELECTRIC, _roughdielectric_f_pdf),
    (HK, _hk_eval),
    (PLASTIC, _plastic_eval),
    (ROUGHPLASTIC, _roughplastic_eval),
    (PHONG, _phong_eval),
    (WARD, _ward_eval),
]


def eval_bsdf(mp: MatParams, wo, wi, active=None):
    """f(wo, wi) * |cos_theta(wi)| and the solid-angle pdf; 0 for delta
    lobes. `active`: the static tuple of bsdf type tags in the scene; the
    families of absent tags are not computed."""
    check_ported(active)
    s = _flip_sign(mp, wo)
    wo_l, wi_l = _mulz(wo, s), _mulz(wi, s)
    f, pdf = 0.0, 0.0   # lanes of tags without a family keep 0
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
        (ROUGHDIFFUSE, lambda: _diffuse_sample(mp, wo_l, u2, rough=True)),
        (CONDUCTOR, lambda: _conductor_sample(mp, wo_l)),
        (DIELECTRIC, lambda: _dielectric_sample(mp, wo_l, u1)),
        (THINDIELECTRIC, lambda: _thindielectric_sample(mp, wo_l, u1)),
        (ROUGHCONDUCTOR, lambda: _roughconductor_sample(mp, wo_l, u2)),
        (ROUGHDIELECTRIC, lambda: _roughdielectric_sample(mp, wo_l, u2, u1)),
        (PLASTIC, lambda: _plastic_sample(mp, wo_l, u2, u1)),
        (ROUGHPLASTIC, lambda: _roughplastic_sample(mp, wo_l, u2, u1)),
        (PHONG, lambda: _phong_sample(mp, wo_l, u2, u1)),
        (WARD, lambda: _ward_sample(mp, wo_l, u2, u1)),
        (HK, lambda: _hk_sample(mp, wo_l, u2, u1)),
    ]
    # lanes of tags without a sampler (NULL_BSDF, nested) keep 0, stype 0, eta 1
    wi, weight, pdf, stype, eta = 0.0, 0.0, 0.0, 0, 1.0
    for tag, make in makers:
        if tag in active:
            wi_i, w_i, p_i, st_i, eta_i = make()
            m = mp.bsdf_type == tag
            wi = torch.where(m[..., None], wi_i, wi)
            weight = torch.where(m[..., None], w_i, weight)
            pdf = torch.where(m, p_i, pdf)
            stype = torch.where(m, st_i, stype)
            eta = torch.where(m, eta_i, eta)
    if isinstance(pdf, float):  # no active tag samples
        z = torch.zeros(wo.shape[:-1], device=wo.device)
        wi, weight, pdf = torch.zeros_like(wo), torch.zeros_like(wo), z
        stype, eta = torch.zeros_like(z, dtype=torch.int32), torch.ones_like(z)
    return BSDFSample(wi=_mulz(wi, s), weight=weight, pdf=pdf, sampled_type=stype, eta=eta)


def is_delta(mp: MatParams):
    """Lanes whose lobe light sampling can never hit (pure delta)."""
    t = mp.bsdf_type
    return (t == CONDUCTOR) | (t == DIELECTRIC) | (t == THINDIELECTRIC)


def is_smooth(mp: MatParams):
    return ~is_delta(mp)


# ---- nested BSDFs: coating / roughcoating / blend (one nesting level) ----

def _as_diffuse(mp: MatParams) -> MatParams:
    return mp._replace(bsdf_type=torch.full_like(mp.bsdf_type, DIFFUSE))


def _coat_transmittance(mp, cos_abs, F, rough_coat):
    """Energy transmittance of the coating interface at |cos|: smooth
    Fresnel for COATING, the baked rough table for ROUGHCOATING lanes
    (computed only when ROUGHCOATING is active)."""
    if rough_coat is None:
        return 1.0 - F
    return torch.where(rough_coat, rough_transmittance(cos_abs, mp.alpha_u, mp.eta), 1.0 - F)


def eval_bsdf_nested(mp: MatParams, mp_inner: MatParams, wo, wi, active=None):
    """eval for scenes with coating / blend: `mp_inner` holds each lane's
    nested material. COATING: the inner BSDF through the interface,
    T(wo) T(wi) f_inner (ROUGHCOATING adds its microfacet lobe, F_o times a
    perfect-conductor rough lobe); BLEND: w f_diffuse(own fields) + (1 - w)
    f_inner. Each nested family is computed only when its tag is active."""
    f0, p0 = eval_bsdf(mp, wo, wi, active)
    fi, pi_ = eval_bsdf(mp_inner, wo, wi, active)
    t = mp.bsdf_type
    f, p = f0, p0
    if COATING in active or ROUGHCOATING in active:
        is_coat = (t == COATING) | (t == ROUGHCOATING)
        is_rc = (t == ROUGHCOATING) if ROUGHCOATING in active else None
        co, ci = fr.cos_theta(wo).abs(), fr.cos_theta(wi).abs()
        F_o, _, _, _ = fres.fresnel_dielectric(co, mp.eta)
        F_i, _, _, _ = fres.fresnel_dielectric(ci, mp.eta)
        trans = _coat_transmittance(mp, co, F_o, is_rc) * _coat_transmittance(mp, ci, F_i, is_rc)
        f_coat = trans[..., None] * fi
        p_coat = (1.0 - F_o) * pi_
        if is_rc is not None:
            mp_spec = mp._replace(bsdf_type=torch.full_like(t, ROUGHCONDUCTOR),
                                  cond_eta=torch.ones_like(mp.cond_eta) * 1e6,
                                  cond_k=torch.zeros_like(mp.cond_k))
            s = _flip_sign(mp, wo)
            f_spec, p_spec = _roughconductor_f_pdf(mp_spec, _mulz(wo, s), _mulz(wi, s))
            f_coat = f_coat + torch.where(is_rc[..., None], f_spec * F_o[..., None], 0.0)
            p_coat = p_coat + torch.where(is_rc, F_o * p_spec, 0.0)
        f = torch.where(is_coat[..., None], f_coat, f)
        p = torch.where(is_coat, p_coat, p)
    if BLEND in active:
        is_blend = t == BLEND
        w = torch.clamp(mp.blend_weight, 0.0, 1.0)
        f_blend = w[..., None] * f0_self(mp, wo, wi, active) + (1 - w)[..., None] * fi
        f = torch.where(is_blend[..., None], f_blend, f)
        p = torch.where(is_blend, w * pdf_self(mp, wo, wi, active) + (1 - w) * pi_, p)
    return f, p


def f0_self(mp: MatParams, wo, wi, active=None):
    """Blend component A: the material's own fields as a DIFFUSE lobe."""
    return eval_bsdf(_as_diffuse(mp), wo, wi, (DIFFUSE,))[0]


def pdf_self(mp: MatParams, wo, wi, active=None):
    return eval_bsdf(_as_diffuse(mp), wo, wi, (DIFFUSE,))[1]


def sample_bsdf_nested(mp: MatParams, mp_inner: MatParams, wo, u2, u1,
                       active=None) -> BSDFSample:
    """sample for scenes with nested BSDFs. COATING picks the specular
    mirror with probability F_o, else the inner sample times the interface
    transmittances over (1 - F_o); BLEND picks its diffuse component with
    probability w, else the inner sample, and weighs the direction by the
    whole blend's f / pdf."""
    bs0 = sample_bsdf(mp, wo, u2, u1, active)
    bsi = sample_bsdf(mp_inner, wo, u2, u1, active)
    t = mp.bsdf_type
    wi, weight, pdf, stype = bs0.wi, bs0.weight, bs0.pdf, bs0.sampled_type
    nested = torch.zeros_like(t, dtype=torch.bool)
    if COATING in active or ROUGHCOATING in active:
        is_coat = (t == COATING) | (t == ROUGHCOATING)
        is_rc = (t == ROUGHCOATING) if ROUGHCOATING in active else None
        s = _flip_sign(mp, wo)
        wo_l = _mulz(wo, s)
        co, ci = fr.cos_theta(wo_l).abs(), fr.cos_theta(bsi.wi).abs()
        F_o, _, _, _ = fres.fresnel_dielectric(co, mp.eta)
        F_i, _, _, _ = fres.fresnel_dielectric(ci, mp.eta)
        pick_spec = u1 < F_o
        wi_spec = _mulz(_mirror(wo_l), s)
        T_o = _coat_transmittance(mp, co, F_o, is_rc)
        T_i = _coat_transmittance(mp, ci, F_i, is_rc)
        w_inner = bsi.weight * (T_o * T_i / torch.clamp(_sg(1.0 - F_o), min=1e-6))[..., None]
        wi = torch.where(is_coat[..., None],
                         torch.where(pick_spec[..., None], wi_spec, bsi.wi), wi)
        weight = torch.where(is_coat[..., None],
                             torch.where(pick_spec[..., None], mp.specular, w_inner), weight)
        pdf = torch.where(is_coat, torch.where(pick_spec, F_o, (1.0 - F_o) * bsi.pdf), pdf)
        stype = torch.where(is_coat, torch.where(pick_spec, E_DELTA_REFLECTION,
                                                 bsi.sampled_type), stype)
        nested = nested | is_coat
    if BLEND in active:
        is_blend = t == BLEND
        w = torch.clamp(mp.blend_weight, 0.0, 1.0)
        pick_a = u1 < w
        bsa = sample_bsdf(_as_diffuse(mp), wo, u2, torch.zeros_like(u1), (DIFFUSE,))
        wi_blend = torch.where(pick_a[..., None], bsa.wi, bsi.wi)
        f_bl, p_bl = eval_bsdf_nested(mp, mp_inner, wo, wi_blend, active)
        wi = torch.where(is_blend[..., None], wi_blend, wi)
        weight = torch.where(is_blend[..., None],
                             f_bl / torch.clamp(_sg(p_bl), min=1e-12)[..., None], weight)
        pdf = torch.where(is_blend, p_bl, pdf)
        stype = torch.where(is_blend, torch.where(pick_a, bsa.sampled_type, bsi.sampled_type),
                            stype)
        nested = nested | is_blend
    eta = torch.where(nested, bsi.eta, bs0.eta)
    return BSDFSample(wi=wi, weight=weight, pdf=pdf, sampled_type=stype.to(torch.int32), eta=eta)
