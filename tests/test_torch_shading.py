"""Shading parity of the glossy slice: the port's Fresnel, microfacet and
rough-transmittance math, the CONDUCTOR / ROUGHCONDUCTOR / ROUGHDIELECTRIC
/ ROUGHPLASTIC BSDFs, the checkerboard texture and the INFINITE environment
light, against the JAX package on inputs made with numpy from seeds.

Tolerances:
  * elementwise math: rtol 1e-6 plus an absolute 1e-6 (float32 on values of
    order one); the rough transmittance, whose monomial sum reaches 6e4
    before cancelling to order 0.1, within 2 ulps of that sum (atol 1e-5);
  * BSDF values rtol 1e-4 with atol 1e-5 relative to their scale: the
    microfacet terms divide by cosines near zero and take powers, where one
    float32 ulp of an input moves the output by far more than one ulp;
    sampled directions and lobe flags agree on 99.9% of lanes or more.
    Sample weights within rtol 3e-3: a sampled direction may differ by one
    ulp, and the rough plastic's weight goes through the rough
    transmittance, whose cancelling sum turns that ulp into up to 1.6e-3;
  * environment tables array-equal (the same numpy construction);
    environment sampling and pdfs rtol 1e-5.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.math import fresnel as jfres
from cudatracerlib_tpu.math import microfacet as jmf
from cudatracerlib_tpu.math import rough_transmittance as jrt
from cudatracerlib_tpu.scene import bsdf as jbsdf
from cudatracerlib_tpu.scene import lights as jlights
from cudatracerlib_tpu.scene import textures as jtex
from cudatracerlib_tpu.scene.shapes import _sky_envmap as j_sky
from cudatracerlib_tpu_torch.math import fresnel as tfres
from cudatracerlib_tpu_torch.math import microfacet as tmf
from cudatracerlib_tpu_torch.math import rough_transmittance as trt
from cudatracerlib_tpu_torch.scene import bsdf as tbsdf
from cudatracerlib_tpu_torch.scene import lights as tlights
from cudatracerlib_tpu_torch.scene import textures as ttex
from cudatracerlib_tpu_torch.scene.shapes import _sky_envmap as t_sky

N = 4096


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(t, j, rtol=1e-6, atol=1e-6, err_msg=""):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol, err_msg=err_msg)


def _dirs(n, seed, upper=False):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    if upper:
        v[:, 2] = np.abs(v[:, 2])
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def test_fresnel():
    rng = np.random.default_rng(0)
    cos_i = rng.uniform(-1, 1, N).astype(np.float32)
    eta = rng.uniform(0.5, 2.5, N).astype(np.float32)
    for a, b in zip(tfres.fresnel_dielectric(_t(cos_i), _t(eta)),
                    jfres.fresnel_dielectric(jnp.asarray(cos_i), jnp.asarray(eta))):
        _close(a, b)
    ce = rng.uniform(0.1, 2.0, (N, 3)).astype(np.float32)
    ck = rng.uniform(0.5, 4.0, (N, 3)).astype(np.float32)
    _close(tfres.fresnel_conductor(_t(cos_i), _t(ce), _t(ck)),
           jfres.fresnel_conductor(jnp.asarray(cos_i), jnp.asarray(ce), jnp.asarray(ck)))
    _close(tfres.fresnel_diffuse_reflectance(_t(eta)),
           jfres.fresnel_diffuse_reflectance(jnp.asarray(eta)))


@pytest.mark.parametrize("dist", [jmf.BECKMANN, jmf.GGX, jmf.PHONG],
                         ids=["beckmann", "ggx", "phong"])
def test_microfacet(dist):
    rng = np.random.default_rng(1 + dist)
    wi = _dirs(N, 2)
    m = _dirs(N, 3, upper=True)
    ax = rng.uniform(0.05, 0.6, N).astype(np.float32)
    ay = rng.uniform(0.05, 0.6, N).astype(np.float32)
    u = rng.random((N, 2), dtype=np.float32)
    dt = np.full(N, dist, np.int32)
    j = [jnp.asarray(x) for x in (dt, wi, m, ax, ay, u)]
    t = [_t(x) for x in (dt, wi, m, ax, ay, u)]
    # D and pdf scale as 1 / (alpha^2 cos^4): compare relative to their size
    _close(tmf.D(t[0], t[2], t[3], t[4]), jmf.D(j[0], j[2], j[3], j[4]), rtol=1e-5, atol=1e-5)
    _close(tmf.smith_g1(t[0], t[1], t[2], t[3], t[4]),
           jmf.smith_g1(j[0], j[1], j[2], j[3], j[4]), rtol=1e-5, atol=1e-6)
    _close(tmf.G(t[0], t[1], t[2], t[2], t[3], t[4]),
           jmf.G(j[0], j[1], j[2], j[2], j[3], j[4]), rtol=1e-5, atol=1e-6)
    _close(tmf.pdf(t[0], t[1], t[2], t[3], t[4]),
           jmf.pdf(j[0], j[1], j[2], j[3], j[4]), rtol=1e-5, atol=1e-5)
    tm, tp = tmf.sample(t[0], t[1], t[3], t[4], t[5])
    jm, jp = jmf.sample(j[0], j[1], j[3], j[4], j[5])
    _close(tm, jm, rtol=1e-5, atol=1e-5)
    _close(tp, jp, rtol=1e-4, atol=1e-4)


def test_rough_transmittance():
    rng = np.random.default_rng(5)
    cos_i = rng.uniform(-0.2, 1.0, N).astype(np.float32)
    alpha = rng.uniform(0.0, 0.7, N).astype(np.float32)
    eta = rng.uniform(1.1, 2.1, N).astype(np.float32)
    _close(trt.rough_transmittance(_t(cos_i), _t(alpha), _t(eta)),
           jrt.rough_transmittance(jnp.asarray(cos_i), jnp.asarray(alpha), jnp.asarray(eta)),
           rtol=0, atol=1e-5)
    _close(trt.rough_fdr(_t(alpha), _t(eta)),
           jrt.rough_fdr(jnp.asarray(alpha), jnp.asarray(eta)))
    np.testing.assert_array_equal(trt.COEFS_T, jrt.COEFS_T)
    np.testing.assert_array_equal(trt.COEFS_FDR, jrt.COEFS_FDR)


@pytest.mark.parametrize("jax_dtype", ["float64", "float32"])
def test_rough_transmittance_gradient(jax_dtype):
    """The port's gradient (its correction's derivative polynomials summed
    in float64) against jax.grad of JAX's rough_transmittance, over the
    fitted domain (alpha, cos, eta) and a margin past each clamp.

    Against JAX run in float64 (the true derivative of the same float32
    coefficients): rtol 1e-4 plus 1e-6 of the largest entry. Against JAX in
    float32: 1e-2 of the largest entry, because autograd through JAX's 120
    float32 terms, which reach 6e4 and cancel to order 0.1, puts its own
    gradient up to 0.8% of the largest entry away from its float64 one
    (alpha; 0.14% for cos, 0.21% for eta, seed 11)."""
    rng = np.random.default_rng(11)
    n = 4096
    cos_i = rng.uniform(0.1, 1.0, n).astype(np.float32)
    alpha = rng.uniform(0.0, 0.65, n).astype(np.float32)
    eta = rng.uniform(1.2, 2.05, n).astype(np.float32)
    g = rng.normal(size=n).astype(np.float32)
    dt = getattr(jnp, jax_dtype)

    def jloss(c, a, e):
        return (jrt.rough_transmittance(c, a, e) * jnp.asarray(g, dt)).sum()

    with jax.enable_x64(jax_dtype == "float64"):
        jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
            *(jnp.asarray(x, dt) for x in (cos_i, alpha, eta)))
        jgrads = [np.asarray(x, np.float64) for x in jgrads]
    ts = [_t(x).requires_grad_() for x in (cos_i, alpha, eta)]
    (trt.rough_transmittance(*ts) * _t(g)).sum().backward()
    for name, t, j in zip(("cos", "alpha", "eta"), ts, jgrads):
        scale = np.abs(j).max()
        assert scale > 0.1 and np.isfinite(t.grad.numpy()).all()
        rtol, frac = (1e-4, 1e-6) if jax_dtype == "float64" else (0.0, 1e-2)
        np.testing.assert_allclose(t.grad.numpy(), j, rtol=rtol, atol=frac * scale, err_msg=name)


def _mat_params(tag, seed, n=N):
    """Per-lane MatParams of one BSDF tag with random parameters."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.05, 0.6, n).astype(np.float32)
    arrays = dict(
        bsdf_type=np.full(n, tag, np.int32),
        dist_type=np.full(n, jmf.GGX, np.int32),
        albedo=rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32),
        specular=rng.uniform(0.5, 1.0, (n, 3)).astype(np.float32),
        transmittance=rng.uniform(0.5, 1.0, (n, 3)).astype(np.float32),
        eta=rng.uniform(1.2, 1.9, n).astype(np.float32),
        cond_eta=rng.uniform(0.1, 1.5, (n, 3)).astype(np.float32),
        cond_k=rng.uniform(1.5, 4.0, (n, 3)).astype(np.float32),
        alpha_u=a, alpha_v=a,
        exponent=np.full(n, 30.0, np.float32),
        nonlinear=(rng.random(n) < 0.5).astype(np.float32),
        blend_weight=np.full(n, 0.5, np.float32),
    )
    return (jbsdf.MatParams(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            tbsdf.MatParams(**{k: _t(v) for k, v in arrays.items()}))


GLOSSY_TAGS = (tbsdf.ROUGHDIELECTRIC, tbsdf.CONDUCTOR, tbsdf.ROUGHCONDUCTOR, tbsdf.ROUGHPLASTIC)


@pytest.mark.parametrize("tag", GLOSSY_TAGS,
                         ids=["roughdielectric", "conductor", "roughconductor", "roughplastic"])
def test_bsdf_eval_pdf_sample(tag):
    jmp, tmp = _mat_params(tag, 10 + tag)
    wo, wi = _dirs(N, 20), _dirs(N, 21)
    rng = np.random.default_rng(22)
    u2 = rng.random((N, 2), dtype=np.float32)
    u1 = rng.random(N, dtype=np.float32)
    active = tuple(sorted(GLOSSY_TAGS))
    jf, jp = jbsdf.eval_bsdf(jmp, jnp.asarray(wo), jnp.asarray(wi), active)
    tf, tp = tbsdf.eval_bsdf(tmp, _t(wo), _t(wi), active)
    scale = max(float(np.abs(np.asarray(jf)).max()), 1e-6)
    _close(tf, jf, rtol=1e-4, atol=1e-5 * scale, err_msg="f")
    _close(tp, jp, rtol=1e-4, atol=1e-5 * max(float(np.asarray(jp).max()), 1e-6), err_msg="pdf")
    _close(tbsdf.pdf_bsdf(tmp, _t(wo), _t(wi), active), jp, rtol=1e-4,
           atol=1e-5 * max(float(np.asarray(jp).max()), 1e-6))

    jbs = jbsdf.sample_bsdf(jmp, jnp.asarray(wo), jnp.asarray(u2), jnp.asarray(u1), active)
    tbs = tbsdf.sample_bsdf(tmp, _t(wo), _t(u2), _t(u1), active)
    st_same = tbs.sampled_type.numpy() == np.asarray(jbs.sampled_type)
    assert st_same.mean() >= 0.999
    wi_close = (np.abs(tbs.wi.numpy() - np.asarray(jbs.wi)) <= 1e-4).all(-1)
    assert wi_close.mean() >= 0.999
    ok = st_same & wi_close
    for f, rtol in (("weight", 3e-3), ("pdf", 1e-4), ("eta", 1e-6)):
        a, b = getattr(tbs, f).numpy()[ok], np.asarray(getattr(jbs, f))[ok]
        np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-5 * max(float(np.abs(b).max()), 1e-6),
                                   err_msg=f)
    np.testing.assert_array_equal(tbsdf.is_delta(tmp).numpy(), np.asarray(jbsdf.is_delta(jmp)))
    np.testing.assert_array_equal(tbsdf.is_smooth(tmp).numpy(), np.asarray(jbsdf.is_smooth(jmp)))
    assert (tbs.pdf.numpy() > 0).mean() > 0.3


def test_bsdf_unported_tags_raise():
    """Every tag of the JAX package is ported (tests/test_torch_bsdf_more.py
    holds the new families to JAX); the static type set stays required:
    active=None (JAX's compute-every-family default) and unknown tags
    raise."""
    _, tmp = _mat_params(tbsdf.DIFFUSE, 0, n=4)
    wo = _t(_dirs(4, 1))
    assert tbsdf.PORTED == tuple(range(16))
    for active in [None, (0, 16), (-1,)]:
        with pytest.raises(NotImplementedError):
            tbsdf.eval_bsdf(tmp, wo, wo, active)
        with pytest.raises(NotImplementedError):
            tbsdf.sample_bsdf(tmp, wo, _t(np.zeros((4, 2), np.float32)),
                              _t(np.zeros(4, np.float32)), active)


def test_checkerboard_texture():
    records = [
        {"type": 1, "color_a": [0.45, 0.45, 0.45], "color_b": [0.25, 0.25, 0.28],
         "uv_xform": [8, 8, 0, 0]},
        {"type": 0, "color_a": [1.0, 0.71, 0.29]},
        {"type": 1, "color_a": [0.9, 0.1, 0.1], "color_b": [0.1, 0.1, 0.9],
         "uv_xform": [3, 5, 0.25, -0.5]},
    ]
    jt, tt = jtex.Textures.build(records), ttex.Textures.build(records)
    rng = np.random.default_rng(7)
    uv = rng.uniform(-1.5, 1.5, (N, 2)).astype(np.float32)
    tid = rng.integers(0, 3, N).astype(np.int32)
    want = jtex.eval_texture(jt, jnp.asarray(tid), jnp.asarray(uv), active=(0, 1))
    got = ttex.eval_texture(tt, _t(tid).long(), _t(uv), active=(0, 1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(NotImplementedError):   # an unknown texture tag
        ttex.eval_texture(tt, _t(tid).long(), _t(uv), active=(0, 6))


@pytest.fixture(scope="module")
def env_lights():
    env = t_sky()
    np.testing.assert_array_equal(env, j_sky())
    rec = [{"type": jlights.INFINITE, "radiance": [1.0, 1.0, 1.0]}]
    return (jlights.build_lights(rec, [0, 0, 0.5], 8.0, env),
            tlights.build_lights(rec, [0, 0, 0.5], 8.0, env))


def test_env_tables_equal(env_lights):
    jl, tl = env_lights
    for f in ("env_map", "env_w", "env_row_cdf", "env_col_cdf", "env_total"):
        np.testing.assert_array_equal(getattr(tl, f).numpy(), np.asarray(getattr(jl, f)), f)
    _close(tlights.light_power(tl), jlights.light_power(jl), rtol=1e-6, atol=0)


def test_env_sample_eval_pdf(env_lights):
    jl, tl = env_lights
    rng = np.random.default_rng(8)
    u2 = rng.random((N, 2), dtype=np.float32)
    ref_p = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    jds, jrad = jlights.sample_direct(jl, jnp.int32(0), jnp.asarray(ref_p), jnp.asarray(u2),
                                      active=(jlights.INFINITE,))
    tds, trad = tlights.sample_direct(tl, 0, _t(ref_p), _t(u2), active=(tlights.INFINITE,))
    _close(tds.d, jds.d, rtol=1e-5, atol=1e-6)
    _close(tds.pdf, jds.pdf, rtol=1e-5, atol=0)
    _close(trad, jrad, rtol=1e-6, atol=0)
    _close(tds.dist, jds.dist)
    _close(tds.p, jds.p, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tds.measure.numpy(), np.asarray(jds.measure))
    d = _dirs(N, 9)
    lid = jnp.zeros(N, jnp.int32)
    _close(tlights.eval_env(tl, torch.zeros(N, dtype=torch.long), _t(d)),
           jlights.eval_env(jl, lid, jnp.asarray(d)), rtol=1e-6, atol=0)
    _close(tlights.pdf_env_dir(tl, torch.zeros(N, dtype=torch.long), _t(d)),
           jlights.pdf_env_dir(jl, lid, jnp.asarray(d)), rtol=1e-5, atol=0)
    # the sampled directions' own pdf agrees with the sampler's
    pdf_back = tlights.pdf_env_dir(tl, 0, tds.d)
    ok = np.isclose(pdf_back.numpy(), tds.pdf.numpy(), rtol=1e-3)
    assert ok.mean() > 0.99


def test_unported_light_types_raise(env_lights):
    """Every light type is ported (tests/test_torch_camera_lights.py holds
    SPOT and DISTANT and every emitter to JAX); the static type set stays
    required: None and unknown types raise, in direct and emitter
    sampling."""
    _, tl = env_lights
    assert tlights.PORTED == tuple(range(6))
    for active in [None, (4, 6), (-1,)]:
        with pytest.raises(NotImplementedError):
            tlights.sample_direct(tl, 0, torch.zeros(2, 3), torch.zeros(2, 2), active=active)
        with pytest.raises(NotImplementedError):
            tlights.sample_emitter_ray(tl, 0, torch.zeros(2, 2), torch.zeros(2, 2), active=active)


def test_mixed_area_and_env_lights():
    """An area light beside the environment: each lane takes the branch of
    its own light's type."""
    env = t_sky(res_y=16)
    quad = np.array([[[-1, -1, 3], [1, -1, 3], [1, 1, 3]], [[-1, -1, 3], [1, 1, 3], [-1, 1, 3]]],
                    np.float32)
    rec = [{"type": jlights.AREA_LIGHT, "radiance": [5.0, 4.0, 3.0], "tris": quad},
           {"type": jlights.INFINITE, "radiance": [1.0, 1.0, 1.0]}]
    jl = jlights.build_lights(rec, [0, 0, 0.5], 8.0, env)
    tl = tlights.build_lights(rec, [0, 0, 0.5], 8.0, env)
    rng = np.random.default_rng(11)
    u2 = rng.random((N, 2), dtype=np.float32)
    ref_p = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    lid = rng.integers(0, 2, N).astype(np.int32)
    active = (jlights.AREA_LIGHT, jlights.INFINITE)
    jds, jrad = jlights.sample_direct(jl, jnp.asarray(lid), jnp.asarray(ref_p), jnp.asarray(u2),
                                      active=active)
    tds, trad = tlights.sample_direct(tl, _t(lid).long(), _t(ref_p), _t(u2), active=active)
    for f in ("p", "n", "d", "dist", "pdf"):
        _close(getattr(tds, f), getattr(jds, f), rtol=1e-5, atol=1e-5, err_msg=f)
    _close(trad, jrad, rtol=1e-6, atol=0)
    assert 0.3 < (lid == 0).mean() < 0.7


@pytest.mark.parametrize("mix", [False, True], ids=["alone", "with_area_and_env"])
def test_point_and_constant_env_direct(mix):
    """POINT and CONSTANT_ENV `sample_direct` lane by lane against JAX (alone,
    and mixed per lane with an area light and the environment map): the
    point light's DISCRETE measure and pdf 1, the constant environment's
    uniform sphere and 1 / (4 pi); `eval_env` and `pdf_env_dir` on the
    constant environment; their emitted rays (`sample_emitter_ray`)."""
    quad = np.array([[[-1, -1, 3], [1, -1, 3], [1, 1, 3]], [[-1, -1, 3], [1, 1, 3], [-1, 1, 3]]],
                    np.float32)
    rec = [{"type": jlights.POINT, "position": [0.3, -0.2, 1.5], "radiance": [30.0, 20.0, 10.0]},
           {"type": jlights.CONSTANT_ENV, "radiance": [0.5, 0.6, 0.7]}]
    env = None
    if mix:
        rec += [{"type": jlights.AREA_LIGHT, "radiance": [5.0, 4.0, 3.0], "tris": quad},
                {"type": jlights.INFINITE, "radiance": [1.0, 1.0, 1.0]}]
        env = t_sky(res_y=16)
    jl = jlights.build_lights(rec, [0, 0, 0.5], 8.0, env)
    tl = tlights.build_lights(rec, [0, 0, 0.5], 8.0, env)
    rng = np.random.default_rng(12)
    u2 = rng.random((N, 2), dtype=np.float32)
    ref_p = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    lid = rng.integers(0, len(rec), N).astype(np.int32)
    active = tuple(sorted({r["type"] for r in rec}))
    jds, jrad = jlights.sample_direct(jl, jnp.asarray(lid), jnp.asarray(ref_p), jnp.asarray(u2),
                                      active=active)
    tds, trad = tlights.sample_direct(tl, _t(lid).long(), _t(ref_p), _t(u2), active=active)
    for f in ("p", "n", "d", "dist", "pdf"):
        _close(getattr(tds, f), getattr(jds, f), rtol=1e-5, atol=1e-5, err_msg=f)
    _close(trad, jrad, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tds.measure.numpy(), np.asarray(jds.measure))
    is_point = lid == 0
    assert (tds.measure.numpy()[is_point] == 2).all() and (tds.pdf.numpy()[is_point] == 1).all()
    d = _dirs(N, 13)
    lid_env = np.full(N, 1, np.int32)
    _close(tlights.eval_env(tl, _t(lid_env).long(), _t(d)),
           jlights.eval_env(jl, jnp.asarray(lid_env), jnp.asarray(d)), rtol=1e-6, atol=0)
    _close(tlights.pdf_env_dir(tl, _t(lid_env).long(), _t(d)),
           jlights.pdf_env_dir(jl, jnp.asarray(lid_env), jnp.asarray(d)), rtol=1e-6, atol=0)
    # their emitted rays, per lane, against JAX's
    u_dir = rng.random((N, 2), dtype=np.float32)
    want = jlights.sample_emitter_ray(jl, jnp.asarray(lid), jnp.asarray(u2), jnp.asarray(u_dir))
    got = tlights.sample_emitter_ray(tl, _t(lid).long(), _t(u2), _t(u_dir), active=active)
    for name, a, b in zip(("o", "d", "w"), got, want):
        _close(a, b, rtol=1e-5, atol=1e-5 * max(float(np.abs(np.asarray(b)).max()), 1.0),
               err_msg=name)
