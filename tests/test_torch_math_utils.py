"""Parity of the port's math utilities with the JAX package on the CPU: the
vecmath, frame, Monte-Carlo and warp helpers, sampling records, splines,
quadrature, the merging model, direction compression, density kernels,
`hashgrid.query_reduce` and the path tracer's pass helpers. Inputs come from
numpy seeds; each test states its tolerance."""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.accel import hashgrid as jhg
from cudatracerlib_tpu.math import compression as jcomp
from cudatracerlib_tpu.math import frame as jframe
from cudatracerlib_tpu.math import function_model as jfm
from cudatracerlib_tpu.math import kernels as jker
from cudatracerlib_tpu.math import montecarlo as jmc
from cudatracerlib_tpu.math import quadrature as jquad
from cudatracerlib_tpu.math import spline as jspl
from cudatracerlib_tpu.math import vecmath as jvm
from cudatracerlib_tpu.math import warp as jwarp
from cudatracerlib_tpu.render import path_tracer as jpt
from cudatracerlib_tpu.sampling import records as jrec
from cudatracerlib_tpu.scene import bsdf as jbsdf
from cudatracerlib_tpu.scene import lights as jlights
from cudatracerlib_tpu_torch.accel import hashgrid as thg
from cudatracerlib_tpu_torch.math import compression as tcomp
from cudatracerlib_tpu_torch.math import frame as tframe
from cudatracerlib_tpu_torch.math import function_model as tfm
from cudatracerlib_tpu_torch.math import kernels as tker
from cudatracerlib_tpu_torch.math import montecarlo as tmc
from cudatracerlib_tpu_torch.math import quadrature as tquad
from cudatracerlib_tpu_torch.math import spline as tspl
from cudatracerlib_tpu_torch.math import vecmath as tvm
from cudatracerlib_tpu_torch.math import warp as twarp
from cudatracerlib_tpu_torch.render import path_tracer as tpt
from cudatracerlib_tpu_torch.sampling import records as trec
from cudatracerlib_tpu_torch.scene import bsdf as tbsdf
from cudatracerlib_tpu_torch.scene import lights as tlights


def _close(t, j, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor) else t,
                                          np.float64),
                               np.asarray(j, np.float64), rtol=rtol, atol=atol)


def _both(x):
    x = np.asarray(x)
    return torch.from_numpy(x.copy()), jnp.asarray(x)


def _unit(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# vecmath, frame, Monte Carlo, warps, records (1e-6)
# ---------------------------------------------------------------------------

_A = np.random.default_rng(10).normal(size=(512, 3)).astype(np.float32)
_B = np.random.default_rng(11).normal(size=(512, 3)).astype(np.float32)
_S = np.random.default_rng(12).uniform(-1.5, 1.5, 512).astype(np.float32)
_A[0, 1], _A[1] = np.inf, 0.0   # one non-finite row, one zero row (face_forward's sign 0)

_VEC_CASES = {
    "absdot": lambda m, a, b, s: m.absdot(a, b),
    "absdot_keepdims": lambda m, a, b, s: m.absdot(a, b, keepdims=True),
    "length": lambda m, a, b, s: m.length(b),
    "length_sqr": lambda m, a, b, s: m.length_sqr(b, keepdims=True),
    "distance": lambda m, a, b, s: m.distance(b, 2.0 * b),
    "distance_sqr": lambda m, a, b, s: m.distance_sqr(b, 0.5 * b),
    "lerp": lambda m, a, b, s: m.lerp(b, 2.0 * b, s[:, None]),
    "clamp": lambda m, a, b, s: m.clamp(b, -0.5, 0.75),
    "clamp_tensor_bound": lambda m, a, b, s: m.clamp(b, s[:, None], 1.0),
    "saturate": lambda m, a, b, s: m.saturate(b),
    "safe_acos": lambda m, a, b, s: m.safe_acos(s),
    "sqr": lambda m, a, b, s: m.sqr(b),
    "face_forward": lambda m, a, b, s: m.face_forward(b, a),
    "spherical_direction": lambda m, a, b, s: m.spherical_direction(
        m.saturate(s), m.saturate(-s), 3.0 * s),
    "spherical_coordinates": lambda m, a, b, s: m.spherical_coordinates(m.normalize(b)),
    "max3": lambda m, a, b, s: m.max3(b),
    "min3": lambda m, a, b, s: m.min3(b),
    "mean3": lambda m, a, b, s: m.mean3(b),
    "is_finite": lambda m, a, b, s: m.is_finite(a),
}


@pytest.mark.parametrize("name", sorted(_VEC_CASES))
def test_vecmath_helpers(name):
    fn = _VEC_CASES[name]
    ta, ja = _both(_A)
    tb, jb = _both(_B)
    ts, js = _both(_S)
    t_out, j_out = fn(tvm, ta, tb, ts), fn(jvm, ja, jb, js)
    if isinstance(j_out, tuple):
        for t, j in zip(t_out, j_out, strict=True):
            _close(t, j, 1e-6, 1e-6)
    else:
        assert tuple(t_out.shape) == tuple(j_out.shape)
        _close(t_out, j_out, 1e-6, 1e-6)


def test_vecmath_constants_and_vec3():
    assert (tvm.EPS, tvm.INF) == (jvm.EPS, float(jvm.INF))
    x = np.float32([0.5, -1.0, 2.0])
    v = tvm.vec3(torch.from_numpy(x), -x, x[::-1].copy(), device="cpu")
    _close(v, jvm.vec3(jnp.asarray(x), -x, x[::-1].copy()), 0.0)
    assert v.dtype == torch.float32 and v.shape == (3, 3)
    _close(tvm.vec3(1.0, 2, -0.5, device="cpu"), jvm.vec3(1.0, 2, -0.5), 0.0)


@pytest.mark.parametrize("name", ["cos_theta2", "tan_theta", "same_hemisphere"])
def test_frame_trig(name):
    v = _unit(1024, 13)
    v[:3] = [[0, 0, 1], [1, 0, 0], [0.6, 0.8, 0.0]]   # the pole and the equator
    w = _unit(1024, 14)
    (tv, jv), (tw, jw) = _both(v), _both(w)
    if name == "same_hemisphere":
        assert np.array_equal(tframe.same_hemisphere(tv, tw).numpy(),
                              np.asarray(jframe.same_hemisphere(jv, jw)))
    else:
        _close(getattr(tframe, name)(tv), getattr(jframe, name)(jv), 1e-6, 1e-6)


def test_balance_heuristic():
    rng = np.random.default_rng(15)
    pf, pg = (rng.uniform(0, 3, 256).astype(np.float32) for _ in range(2))
    pg[:4] = 0.0
    pf[:2] = 0.0
    (tf, jf), (tg, jg) = _both(pf), _both(pg)
    _close(tmc.balance_heuristic(1.0, tf, 2.0, tg), jmc.balance_heuristic(1.0, jf, 2.0, jg),
           1e-6, 1e-6)


@pytest.mark.parametrize("axis", [-1, 0])
def test_build_cdf_batched(axis):
    w = np.random.default_rng(16).uniform(-0.2, 1.0, (6, 33)).astype(np.float32)
    w[2] = 0.0    # a zero total maps to the uniform CDF
    w[3] = -1.0
    tw, jw = _both(w)
    (tc, tt), (jc, jt) = tmc.build_cdf(tw, axis), jmc.build_cdf(jw, axis)
    _close(tc, jc, 1e-6)
    _close(tt, jt, 1e-6, 1e-6)


_WARPS = ["square_to_uniform_hemisphere", "square_to_uniform_disk", "square_to_tent",
          "square_to_std_normal"]


@pytest.mark.parametrize("name", _WARPS)
def test_warps(name):
    u = np.random.default_rng(17).random((2048, 2), dtype=np.float32)
    u[:4] = [[0, 0], [1, 1], [0.5, 0.5], [0.999999, 0.0]]
    tu, ju = _both(u)
    _close(getattr(twarp, name)(tu), getattr(jwarp, name)(ju), 1e-6, 1e-6)


def test_warp_pdfs():
    for name in ("square_to_uniform_sphere_pdf", "square_to_uniform_hemisphere_pdf",
                 "square_to_uniform_disk_pdf"):
        np.testing.assert_allclose(getattr(twarp, name)(), getattr(jwarp, name)(), rtol=1e-7)
    p = np.random.default_rng(18).normal(size=(1024, 2)).astype(np.float32)
    tp, jp = _both(p)
    _close(twarp.square_to_std_normal_pdf(tp), jwarp.square_to_std_normal_pdf(jp), 1e-6, 1e-6)


def test_records_and_constants():
    assert (trec.RADIANCE, trec.IMPORTANCE) == (jrec.RADIANCE, jrec.IMPORTANCE)
    assert trec.PositionSample._fields == jrec.PositionSample._fields
    assert trec.DirectionSample._fields == jrec.DirectionSample._fields
    assert tbsdf.N_BSDF_TYPES == jbsdf.N_BSDF_TYPES
    assert tlights.ENV_RES_Y == jlights.ENV_RES_Y


@pytest.mark.parametrize("size", [(64, 64), (100, 37), (33, 70)])
def test_block_order_pixels(size):
    w, h = size
    t = tpt.block_order_pixels(w, h, device="cpu")
    j = np.asarray(jpt.block_order_pixels(w, h))
    assert t.dtype == torch.int64 and np.array_equal(t.numpy(), j.astype(np.int64))
    assert np.array_equal(tpt.block_order_pixels_np(w, h), t.numpy())


def test_render_pass_fn():
    from cudatracerlib_tpu_torch.scene.shapes import cornell_box

    scene = cornell_box(device="cpu")
    cfg = tpt.PTConfig(max_depth=2)
    fn = tpt.render_pass_fn(scene, 8, 8, 1, cfg)
    jfn = jpt.render_pass_fn(None, 8, 8, 1, jpt.PTConfig(max_depth=2))
    assert fn.func is tpt.render and jfn.func is jpt.render
    assert fn.args[1:] == jfn.args[1:] and fn.keywords.keys() == jfn.keywords.keys()
    assert torch.equal(fn(3), tpt.render(scene, 8, 8, 1, 3, cfg))


# ---------------------------------------------------------------------------
# splines (1e-5)
# ---------------------------------------------------------------------------

_VALS1 = np.random.default_rng(20).uniform(0.1, 2.0, 17).astype(np.float32)
_X1 = np.concatenate([np.random.default_rng(21).uniform(-0.3, 2.3, 2000),
                      [-0.2, 0.0, 2.0, 2.1, 0.125, 1.0]]).astype(np.float32)


@pytest.mark.parametrize("extrapolate", [False, True])
def test_spline_eval_1d(extrapolate):
    (tx, jx), (tv, jv) = _both(_X1), _both(_VALS1)
    _close(tspl.eval_1d(tx, tv, 0.0, 2.0, extrapolate),
           jax.jit(jspl.eval_1d, static_argnums=(2, 3, 4))(jx, jv, 0.0, 2.0, extrapolate), 1e-5)


@pytest.mark.parametrize("extrapolate", [False, True])
def test_spline_eval_2d(extrapolate):
    vals = np.random.default_rng(22).normal(size=(9, 12)).astype(np.float32)
    p = np.random.default_rng(23).uniform(-0.2, 1.2, (1500, 2)).astype(np.float32)
    p[:3] = [[0, 0], [1, 1], [0.5, 1.0]]
    (tp, jp), (tv, jv) = _both(p), _both(vals)
    _close(tspl.eval_2d(tp, tv, extrapolate=extrapolate),
           jax.jit(jspl.eval_2d, static_argnames="extrapolate")(jp, jv, extrapolate=extrapolate),
           1e-5)


@pytest.mark.parametrize("extrapolate", [False, True])
def test_spline_eval_3d(extrapolate):
    vals = np.random.default_rng(24).normal(size=(5, 6, 7)).astype(np.float32)
    p = np.random.default_rng(25).uniform(-0.1, 2.1, (1000, 3)).astype(np.float32)
    lo, hi = (0.0, 0.0, 0.0), (2.0, 1.5, 2.0)
    (tp, jp), (tv, jv) = _both(p), _both(vals)
    _close(tspl.eval_3d(tp, tv, lo, hi, extrapolate),
           jax.jit(jspl.eval_3d, static_argnums=(2, 3, 4))(jp, jv, lo, hi, extrapolate), 1e-5)


def test_spline_integrate_and_sample():
    (tv, jv) = _both(_VALS1)
    _close(tspl.integrate_1d(tv, 0.5, 3.0), jspl.integrate_1d(jv, 0.5, 3.0), 1e-5)
    u = np.random.default_rng(26).random(4096, dtype=np.float32)
    u[:3] = [0.0, 0.5, 0.9999999]
    tu, ju = _both(u)
    (tx, tp), (jx, jp) = tspl.sample_1d(tu, tv, 0.5, 3.0), jspl.sample_1d(ju, jv, 0.5, 3.0)
    _close(tx, jx, 1e-5)
    _close(tp, jp, 1e-5)


def test_spline_eval_1d_gradients():
    x = np.random.default_rng(27).uniform(0.01, 1.99, 300).astype(np.float32)
    w = np.random.default_rng(28).normal(size=300).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_()
    tv = torch.from_numpy(_VALS1.copy()).requires_grad_()
    (tspl.eval_1d(tx, tv, 0.0, 2.0) * torch.from_numpy(w)).sum().backward()
    gx, gv = jax.grad(lambda a, v: jnp.sum(jspl.eval_1d(a, v, 0.0, 2.0) * w), (0, 1))(
        jnp.asarray(x), jnp.asarray(_VALS1))
    _close(tx.grad, gx, 1e-5)
    _close(tv.grad, gv, 1e-5)


# ---------------------------------------------------------------------------
# quadrature (nodes 1e-7; integrals and gradients 1e-5)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", range(2, 9))
def test_gauss_rules(n):
    for tfn, jfn in ((tquad.gauss_legendre, jquad.gauss_legendre),
                     (tquad.gauss_lobatto, jquad.gauss_lobatto)):
        (tx, tw), (jx, jw) = tfn(n, device="cpu"), jfn(n)
        assert tx.dtype == torch.float32
        _close(tx, jx, 1e-7)
        _close(tw, jw, 1e-7)


def test_quadrature_integrate_and_gradients():
    rng = np.random.default_rng(30)
    a = rng.uniform(-1.0, 0.5, 64).astype(np.float32)
    b = a + rng.uniform(0.1, 2.0, 64).astype(np.float32)
    k = np.float32(1.7)
    ta, tb, tk = (torch.from_numpy(np.atleast_1d(v).copy()).requires_grad_() for v in (a, b, k))
    out = tquad.integrate(lambda x: torch.exp(-tk * x) * torch.sin(3.0 * x), ta, tb, 6)

    def jint(a_, b_, k_):
        return jquad.integrate(lambda x: jnp.exp(-k_ * x) * jnp.sin(3.0 * x), a_, b_, 6)

    _close(out, jax.jit(jint)(jnp.asarray(a), jnp.asarray(b), jnp.asarray(k)), 1e-5, 1e-5)
    out.sum().backward()
    ga, gb, gk = jax.jit(jax.grad(lambda *v: jnp.sum(jint(*v)), (0, 1, 2)))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(k))
    _close(ta.grad, ga, 1e-5, 1e-5)
    _close(tb.grad, gb, 1e-5, 1e-5)
    _close(tk.grad, np.atleast_1d(gk), 1e-5, 1e-5)


# ---------------------------------------------------------------------------
# merging model (xs / ys / n equal, eval 1e-6)
# ---------------------------------------------------------------------------

def _sequence(kind, n):
    rng = np.random.default_rng(40)
    if kind == "ascending":
        x = np.linspace(0.0, 3.0, n)
    elif kind == "random":
        x = rng.uniform(-1.0, 2.0, n)
    else:   # repeated x
        x = rng.choice(np.float32([0.0, 0.25, 0.5, 1.0]), n)
    x = x.astype(np.float32)
    return x, (np.sin(3.0 * x) + 0.1 * rng.normal(size=n)).astype(np.float32)


@pytest.mark.parametrize("capacity", [4, 8])
@pytest.mark.parametrize("kind", ["ascending", "random", "repeated"])
def test_merging_model(kind, capacity):
    xs, ys = _sequence(kind, 24)
    batch = 5
    m_t = tfm.merging_init(capacity, (batch,), device="cpu")
    m_j = jfm.merging_init(capacity, (batch,))
    j_insert, j_eval = jax.jit(jfm.merging_insert), jax.jit(jfm.merging_eval)
    shift = np.linspace(0.0, 0.4, batch).astype(np.float32)   # a different sequence per model
    for i, (x, y) in enumerate(zip(xs, ys)):
        xb, yb = (x + shift).astype(np.float32), (y * (1 + shift)).astype(np.float32)
        if i % 3 == 0:   # scalars broadcast over the batch too
            xb, yb = x, y
        m_t = tfm.merging_insert(m_t, torch.as_tensor(xb), torch.as_tensor(yb))
        m_j = j_insert(m_j, jnp.asarray(xb), jnp.asarray(yb))
        for a, b in zip(m_t, m_j):
            assert np.array_equal(a.numpy(), np.asarray(b)), (i, a, b)
    assert m_t.n.dtype == torch.int32
    q = np.linspace(-1.5, 3.5, 41, dtype=np.float32)
    for v in q:
        _close(tfm.merging_eval(m_t, torch.tensor(v)), j_eval(m_j, jnp.asarray(v)), 1e-6)


def test_merging_eval_few_knots():
    m_t, m_j = tfm.merging_init(4, device="cpu"), jfm.merging_init(4)
    j_insert, j_eval = jax.jit(jfm.merging_insert), jax.jit(jfm.merging_eval)
    for x, y in ((0.5, 2.0), (1.5, -1.0)):
        for v in (-1.0, 0.5, 1.0, 2.0):
            _close(tfm.merging_eval(m_t, v), j_eval(m_j, v), 1e-6)
        m_t, m_j = tfm.merging_insert(m_t, x, y), j_insert(m_j, x, y)


# ---------------------------------------------------------------------------
# compression (codes equal, decodes 1e-6)
# ---------------------------------------------------------------------------

def _directions():
    d = _unit(4096, 50)
    axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)   # poles and axes
    s = np.float32(np.sqrt(0.5))
    fold = np.float32([[s, s, 0], [s, -s, 0], [-s, s, 0], [-s, -s, 0],      # the octahedral fold edges
                       [s, 0, -s], [0, s, -s], [-s, 0, -s], [0, -s, -s],
                       [0.6, 0.0, -0.8], [0.0, -0.6, 0.8], [1e-7, 0.0, -1.0]])
    return np.concatenate([d, axes, fold])


@pytest.mark.parametrize("scheme", ["spherical_u16", "octahedral_u32"])
def test_direction_codes(scheme):
    """Codes equal to JAX's uint32 read as int64. The octahedral encoder
    normalizes first, and XLA's CPU rsqrt rounds otherwise than torch's on
    some inputs: on a lane where the two `normalize`s differ in the last bit
    the code may move by one quantization step in one field; every other
    lane is equal. Decoding the same codes agrees within 1e-6."""
    d = _directions()
    td, jd = _both(d)
    tc = getattr(tcomp, f"encode_{scheme}")(td)
    jc = np.asarray(getattr(jcomp, f"encode_{scheme}")(jd)).astype(np.int64)
    assert tc.dtype == torch.int64
    differ = tc.numpy() != jc
    if scheme == "octahedral_u32":
        same_n = (tvm.normalize(td).numpy() == np.asarray(jvm.normalize(jd))).all(-1)
        assert not (differ & same_n).any()
        steps = [np.abs((tc.numpy()[differ] >> s & 0xFFFF) - (jc[differ] >> s & 0xFFFF))
                 for s in (0, 16)]
        assert ((steps[0] + steps[1]) == 1).all(), steps
        print(f"{int(differ.sum())} of {d.shape[0]} codes one step apart "
              f"({int((~same_n).sum())} lanes normalize differently)")
    else:
        assert not differ.any()
    dec = getattr(tcomp, f"decode_{scheme}")
    _close(dec(torch.from_numpy(jc)), getattr(jcomp, f"decode_{scheme}")(jnp.asarray(jc, jnp.uint32)),
           1e-6)
    _close(dec(torch.from_numpy(jc).to(torch.uint32)), dec(torch.from_numpy(jc)), 0.0)


def test_uv_codes():
    uv = np.random.default_rng(51).uniform(-2.0, 3.0, (4096, 2)).astype(np.float32)
    uv[:6] = [[0, 0], [1, 1], [-0.3, 0.7], [0.5, -1e-9], [2.0, 0.99999], [-1.0, 1.5]]
    tu, ju = _both(uv)
    tc, jc = tcomp.encode_uv_u32(tu), jcomp.encode_uv_u32(ju)
    assert np.array_equal(tc.numpy(), np.asarray(jc).astype(np.int64))
    _close(tcomp.decode_uv_u32(tc), jcomp.decode_uv_u32(jc), 1e-6)
    _close(tcomp.decode_uv_u32(tc.to(torch.uint32)), tcomp.decode_uv_u32(tc), 0.0)


# ---------------------------------------------------------------------------
# density kernels (1e-6)
# ---------------------------------------------------------------------------

_T = np.concatenate([np.linspace(-0.2, 1.2, 301), [0.5, 1.0, 0.0]]).astype(np.float32)


@pytest.mark.parametrize("kind", range(10))
def test_kernel_profiles(kind):
    tt, jt = _both(_T)
    _close(tker.eval_kernel(kind, tt), jker.eval_kernel(kind, jt), 1e-6, 1e-6)
    for d in (1, 2, 3):
        np.testing.assert_allclose(tker.normalization(kind, d), jker.normalization(kind, d),
                                   rtol=1e-6)


def test_kernel_per_lane_kind_and_density_weight():
    rng = np.random.default_rng(60)
    kind = rng.integers(0, 11, _T.shape[0]).astype(np.int32)   # 10: unknown -> UNIFORM
    (tt, jt), (tk, jk) = _both(_T), _both(kind)
    _close(tker.eval_kernel(tk, tt), jker.eval_kernel(jk, jt), 1e-6, 1e-6)
    dist = rng.uniform(0.0, 0.12, 4096).astype(np.float32)
    radius = rng.uniform(0.02, 0.1, 4096).astype(np.float32)
    (tdist, jdist), (tr, jr) = _both(dist), _both(radius)
    for kd, d in ((tker.EPANECHNIKOV, 2), (tker.GAUSSIAN, 3), (tker.TENT, 1)):
        _close(tker.density_weight(kd, tdist, tr, d), jker.density_weight(kd, jdist, jr, d),
               1e-6, 1e-6)
        _close(tker.density_weight(kd, tdist, 0.05, d, norm=0.7),
               jker.density_weight(kd, jdist, 0.05, d, norm=0.7), 1e-6, 1e-6)
    np.testing.assert_allclose(tker.normalization(tker.EPANECHNIKOV, 2), 2.0 / np.pi, rtol=1e-6)


# ---------------------------------------------------------------------------
# query_reduce (equal)
# ---------------------------------------------------------------------------

class _Payload(NamedTuple):
    w: object
    c: object


def _grid_case():
    rng = np.random.default_rng(70)
    pts = rng.uniform(0.0, 1.0, (3000, 3)).astype(np.float32)
    valid = rng.random(3000) >= 0.1
    centers = rng.uniform(0.0, 1.0, (200, 3)).astype(np.float32)
    w = rng.integers(0, 9, 3000).astype(np.float32)    # small integers: every sum is exact
    c = rng.integers(0, 5, (3000, 3)).astype(np.float32)
    return pts, valid, centers, w, c


def _reduce(lib):
    def fn(acc, pl, valid):
        pw, pc = (pl.w, pl.c) if isinstance(pl, tuple) else (pl["w"], pl["c"])
        zero = 0.0
        return (acc + lib.where(valid, pw, zero).sum(-1),
                lib.where(valid[..., None], pc, zero).sum(-2), valid.sum(-1))
    return fn


class _TorchLib:
    @staticmethod
    def where(c, a, b):
        return torch.where(c, a, b)


@pytest.mark.parametrize("payload", ["namedtuple", "dict"])
def test_query_reduce(payload):
    pts, valid, centers, w, c = _grid_case()
    tg = thg.build_grid(torch.from_numpy(pts), [0, 0, 0], [1, 1, 1], 8,
                        valid=torch.from_numpy(valid))
    jg = jhg.build_grid(jnp.asarray(pts), [0, 0, 0], [1, 1, 1], 8, valid=jnp.asarray(valid))
    if payload == "namedtuple":
        tpl, jpl = _Payload(torch.from_numpy(w), torch.from_numpy(c)), _Payload(jnp.asarray(w),
                                                                                 jnp.asarray(c))
    else:
        tpl, jpl = {"w": torch.from_numpy(w), "c": torch.from_numpy(c)}, {
            "w": jnp.asarray(w), "c": jnp.asarray(c)}
    t_out = thg.query_reduce(tg, tpl, torch.from_numpy(centers), 0.1, 150, _reduce(_TorchLib),
                             torch.zeros(200))
    j_out = jax.jit(lambda pl, c: jhg.query_reduce(jg, pl, c, 0.1, 150, _reduce(jnp),
                                                   jnp.zeros(200)))(jpl, jnp.asarray(centers))
    for t, j in zip(t_out, j_out, strict=True):
        assert np.array_equal(t.numpy(), np.asarray(j).astype(t.numpy().dtype)), (t, j)
    assert int(t_out[2].max()) == 150   # some query is capped, so the cut order counts too
