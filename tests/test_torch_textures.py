"""Texture parity: the port's scene/textures.py against the JAX package's on
inputs made with numpy from seeds: the MIP pyramid and the atlas,
`eval_texture` of every type under every wrap and filter mode, the
trilinear and anisotropic lookups, and the gradients of a texture lookup
with respect to the atlas and the colours.

Tolerances:
  * the pyramid, the atlas and every table: array-equal (the same numpy
    construction);
  * lookups: within 1e-6 absolute (texels and colours lie in [0, 1]; a
    bilinear weight computed in another order moves the last float32 bit),
    and at most 1 lane in 10,000 may take the other texel where a
    coordinate lies within an ulp of a texel edge (floor of x * res - 0.5)
    or a checker edge; those lanes are counted, and none occurred here;
  * gradients against `jax.grad`: within 1e-6 absolute plus 1e-5
    relative (the atlas texels' sums run in another order).
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.scene import textures as jtex
from cudatracerlib_tpu_torch.scene import textures as ttex

N = 4096
FLIP_FRAC = 1e-4


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _images(seed):
    """Three seeded images of the sizes and ranks `Textures.build` takes:
    (48, 80, 3) colour, (64, 64) grey, (256, 256, 4) with alpha."""
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (48, 80, 3)).astype(np.float32),
            rng.uniform(0, 1, (64, 64)).astype(np.float32),
            rng.uniform(0, 1, (256, 256, 4)).astype(np.float32)]


def _records(wrap, filt):
    return [
        {"type": 0, "color_a": [0.3, 0.6, 0.9]},
        {"type": 1, "color_a": [0.9, 0.1, 0.1], "color_b": [0.1, 0.1, 0.9],
         "uv_xform": [3, 5, 0.25, -0.5]},
        {"type": 2, "image_id": 0, "color_a": [0.8, 1.0, 0.9], "uv_xform": [1.5, 2, 0.1, 0],
         "wrap_mode": wrap, "filter_mode": filt},
        {"type": 3, "uv_xform": [2, 3, 0, 0.5]},
        {"type": 4, "color_a": [0.2, 0.2, 0.2]},
        {"type": 5, "color_a": [0.5, 0.25, 0.125]},
        {"type": 2, "image_id": 1, "wrap_mode": wrap, "filter_mode": filt},
        {"type": 2, "image_id": 2, "uv_xform": [-1, 1, 0, 0], "wrap_mode": wrap,
         "filter_mode": filt},
    ]


@pytest.fixture(scope="module")
def images():
    return _images(11)


def _lanes(seed, n=N, nt=8):
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    tid = rng.integers(0, nt, n).astype(np.int32)
    bary = rng.dirichlet([1, 1, 1], n)[:, 1:].astype(np.float32)
    width = np.exp(rng.uniform(np.log(1e-4), np.log(2.0), n)).astype(np.float32)
    d0 = rng.normal(0, 0.01, (n, 2)).astype(np.float32)
    d1 = rng.normal(0, 0.002, (n, 2)).astype(np.float32)
    return uv, tid, bary, width, d0, d1


def _assert_lookup_close(got, want, label):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all(), label
    off = (np.abs(got - want) > 1e-6).any(-1)
    assert off.sum() <= FLIP_FRAC * got.shape[0], (
        f"{label}: {off.sum()} lanes off by up to {np.abs(got - want).max()}")


def test_pyramid_and_atlas_equal(images):
    """`build_pyramid` (each level the 2x2 mean of the one above) and the
    multi-layer atlas of `Textures.build`, array for array."""
    level0 = np.random.default_rng(2).uniform(0, 1, (256, 256, 3)).astype(np.float32)
    got = ttex.build_pyramid(level0)
    np.testing.assert_array_equal(got, jtex.build_pyramid(level0))
    assert got.shape == (ttex.ATLAS_TOTAL, 3) == (87381, 3)
    top = got[ttex._LEVEL_OFFSETS[-1]]
    np.testing.assert_allclose(top, level0.reshape(-1, 3).mean(0), rtol=1e-5)
    assert (ttex.N_LEVELS, tuple(ttex._LEVEL_RES), ttex.N_ANISO_PROBES) == (
        jtex.N_LEVELS, tuple(jtex._LEVEL_RES), jtex.N_ANISO_PROBES)
    np.testing.assert_array_equal(ttex._LEVEL_OFFSETS, jtex._LEVEL_OFFSETS)
    recs = _records(ttex.WRAP_MIRROR, ttex.FILTER_ANISOTROPIC)
    jt, tt = jtex.Textures.build(recs, images), ttex.Textures.build(recs, images)
    for f in jt._fields:
        np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)), f)
    assert tt.atlas.shape == (3, ttex.ATLAS_TOTAL, 3)


@pytest.mark.parametrize("wrap", [ttex.WRAP_REPEAT, ttex.WRAP_CLAMP, ttex.WRAP_MIRROR,
                                  ttex.WRAP_BLACK], ids=["repeat", "clamp", "mirror", "black"])
@pytest.mark.parametrize("filt", [ttex.FILTER_POINT, ttex.FILTER_BILINEAR,
                                  ttex.FILTER_ANISOTROPIC, ttex.FILTER_TRILINEAR],
                         ids=["point", "bilinear", "aniso", "trilinear"])
def test_eval_texture_every_type(images, wrap, filt):
    """Every texture type (CONSTANT, CHECKERBOARD, IMAGE of three layers,
    UV, WIREFRAME with and without barycentrics, BILERP: color_a as in
    JAX) at uvs in [-1.5, 2.5]^2, at level 0, through the ray cone's
    footprint (trilinear) and through a footprint ellipse (anisotropic)."""
    recs = _records(wrap, filt)
    jt, tt = jtex.Textures.build(recs, images), ttex.Textures.build(recs, images)
    uv, tid, bary, width, d0, d1 = _lanes(wrap * 4 + filt)
    active = tuple(range(6))
    j = lambda **kw: jtex.eval_texture(jt, jnp.asarray(tid), jnp.asarray(uv),  # noqa: E731
                                       active=active, **kw)
    t = lambda **kw: ttex.eval_texture(tt, _t(tid).long(), _t(uv), active=active,  # noqa: E731
                                       **kw)
    _assert_lookup_close(t(), j(), "level 0")
    _assert_lookup_close(t(bary=_t(bary)), j(bary=jnp.asarray(bary)), "barycentrics")
    _assert_lookup_close(t(uv_width=_t(width)), j(uv_width=jnp.asarray(width)), "trilinear")
    _assert_lookup_close(t(duv0=_t(d0), duv1=_t(d1)), j(duv0=jnp.asarray(d0),
                                                        duv1=jnp.asarray(d1)), "anisotropic")
    got = t(bary=_t(bary)).numpy()
    bilerp = np.tile([[0.5, 0.25, 0.125]], ((tid == 5).sum(), 1))   # BILERP: color_a
    np.testing.assert_array_equal(got[tid == 5], bilerp)
    assert (t().numpy()[tid == 4] == 0).all()   # WIREFRAME without barycentrics


def test_trilinear_and_aniso_lookups(images):
    """`sample_trilinear` at LODs across and beyond [0, 8] and
    `sample_aniso` with footprints of every anisotropy, per wrap mode."""
    jt, tt = (jtex.Textures.build(_records(0, 3), images),
              ttex.Textures.build(_records(0, 3), images))
    rng = np.random.default_rng(5)
    uv = rng.uniform(-0.5, 1.5, (N, 2)).astype(np.float32)
    layer = rng.integers(0, 3, N).astype(np.int32)
    lod = rng.uniform(-1.0, 10.0, N).astype(np.float32)
    d0 = rng.normal(0, 0.02, (N, 2)).astype(np.float32)
    d1 = (d0[:, ::-1] * [-1, 1] * rng.uniform(0.01, 1.0, (N, 1))).astype(np.float32)
    for wrap in range(4):
        w = np.full(N, wrap, np.int32)
        _assert_lookup_close(
            ttex.sample_trilinear(tt.atlas, _t(layer), _t(uv), _t(lod), _t(w)),
            jtex.sample_trilinear(jt.atlas, jnp.asarray(layer), jnp.asarray(uv),
                                  jnp.asarray(lod), jnp.asarray(w)), f"trilinear wrap {wrap}")
        _assert_lookup_close(
            ttex.sample_aniso(tt.atlas, _t(layer), _t(uv), _t(d0), _t(d1), _t(w)),
            jtex.sample_aniso(jt.atlas, jnp.asarray(layer), jnp.asarray(uv), jnp.asarray(d0),
                              jnp.asarray(d1), jnp.asarray(w)), f"aniso wrap {wrap}")


@pytest.mark.parametrize("mode", ["level0", "trilinear", "aniso"])
def test_texture_gradients(images, mode):
    """d sum(weights * eval_texture) with respect to the atlas, color_a
    and color_b against jax.grad. On the CPU the atlas's cotangent is the
    gather backward's plain float64 row sum; on the card its kernels."""
    recs = _records(ttex.WRAP_REPEAT, ttex.FILTER_TRILINEAR)
    jt, tt = jtex.Textures.build(recs, images), ttex.Textures.build(recs, images)
    uv, tid, _, width, d0, d1 = _lanes(21, n=2048)
    wts = np.random.default_rng(22).normal(size=(2048, 3)).astype(np.float32)
    kw_j = {"level0": {}, "trilinear": dict(uv_width=jnp.asarray(width)),
            "aniso": dict(duv0=jnp.asarray(d0), duv1=jnp.asarray(d1))}[mode]
    kw_t = {"level0": {}, "trilinear": dict(uv_width=_t(width)),
            "aniso": dict(duv0=_t(d0), duv1=_t(d1))}[mode]

    def jloss(atlas, ca, cb):
        tex = jt._replace(atlas=atlas, color_a=ca, color_b=cb)
        out = jtex.eval_texture(tex, jnp.asarray(tid), jnp.asarray(uv), active=tuple(range(6)),
                                **kw_j)
        return jnp.sum(out * wts)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jt.atlas, jt.color_a, jt.color_b)
    leaves = [x.clone().requires_grad_() for x in (tt.atlas, tt.color_a, tt.color_b)]
    tex = tt._replace(atlas=leaves[0], color_a=leaves[1], color_b=leaves[2])
    out = ttex.eval_texture(tex, _t(tid).long(), _t(uv), active=tuple(range(6)), **kw_t)
    (out * _t(wts)).sum().backward()
    for name, leaf, w in zip(("atlas", "color_a", "color_b"), leaves, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=1e-5, atol=1e-6, err_msg=name)


def test_check_ported_refuses_none_and_unknown_tags():
    """Every type of the JAX package is ported; the static set stays
    required: None and an unknown tag raise."""
    assert ttex.PORTED == (0, 1, 2, 3, 4, 5)
    tt = ttex.Textures.build([{"type": 0}])
    uv, tid = _t(np.zeros((4, 2), np.float32)), _t(np.zeros(4, np.int64))
    for active in (None, (0, 6), (-1,)):
        with pytest.raises(NotImplementedError):
            ttex.eval_texture(tt, tid, uv, active=active)
