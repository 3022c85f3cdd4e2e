"""The closed-form BSDFs this slice adds (ROUGHDIFFUSE, THINDIELECTRIC,
PLASTIC, PHONG, WARD, HK, NULL_BSDF) and the nested COATING / ROUGHCOATING /
BLEND against the JAX package on the CPU: lane by lane on seeded
directions, per pixel in the white furnace, and through `jax.grad`.

Tolerances:
  * lane by lane (4,096 directions from seeds), as
    tests/test_torch_shading.py's `test_bsdf_eval_pdf_sample`: eval and pdf
    within 1e-4 relative plus 1e-5 of their scale; sampled directions and
    lobe flags agree on 99.9% of lanes or more, and there the weights within
    3e-3 relative (the rough coating's goes through the rough
    transmittance's cancelling sum), pdfs 1e-4, eta 1e-6;
  * furnace renders at 16x16, 2 spp, depth 4, seed 3: 99% of pixels within
    1e-3 relative on every channel and the image means within 1e-4
    relative (measured: every pixel within 1.3e-4 absolute);
  * gradients of mean(render) (16x16, 2 spp, depth 3, no roulette) with
    respect to the albedo texture, and of the nested BSDFs' seeded outputs
    with respect to the inner albedo and outer specular lane by lane: 1e-3
    relative plus 1e-4 of the largest entry, as tests/test_torch_grad.py.

The port's own TestFurnace (tests/test_render.py:18-60) runs at that
test's sizes, where the CPU's brute-force intersector over the sphere's
2,208 triangles takes 30-100 s a render: it is marked `slow`, and
tests/test_torch_cuda.py runs it on the card.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.math import microfacet as jmf
from cudatracerlib_tpu.render import path_tracer as jpt
from cudatracerlib_tpu.scene import bsdf as jbsdf
from cudatracerlib_tpu.scene.scene import Materials as JMaterials
from cudatracerlib_tpu.scene.scene import build_scene as jbuild
from cudatracerlib_tpu.scene.sensors import Camera as JCamera
from cudatracerlib_tpu.scene.shapes import furnace_scene as jfurnace
from cudatracerlib_tpu.scene.textures import Textures as JTextures
from cudatracerlib_tpu_torch.convert import flatten, grads, scene_from_numpy, with_grad
from cudatracerlib_tpu_torch.math import microfacet as tmf
from cudatracerlib_tpu_torch.render import path_tracer as tpt
from cudatracerlib_tpu_torch.scene import bsdf as tbsdf
from cudatracerlib_tpu_torch.scene import shapes as tshapes

N = 4096
B = tbsdf
NEW = (B.ROUGHDIFFUSE, B.THINDIELECTRIC, B.PLASTIC, B.PHONG, B.WARD, B.HK, B.NULL_BSDF)
NEW_IDS = ["roughdiffuse", "thindielectric", "plastic", "phong", "ward", "hk", "null"]
NESTED = [(o, i) for o in (B.COATING, B.ROUGHCOATING, B.BLEND)
          for i in (B.DIFFUSE, B.ROUGHPLASTIC)]
NESTED_IDS = [f"{o}-{i}" for o in ("coating", "roughcoating", "blend")
              for i in ("diffuse", "roughplastic")]
ALL = tuple(range(16))
W = H = 16
SPP, SEED, DEPTH = 2, 3, 4
# furnace_scene keywords by BSDF tag (the port's shapes.FURNACE_CASES)
FURNACE_KW = {kw["bsdf_type"]: kw for kw in tshapes.FURNACE_CASES.values()}
NESTED_KW = tshapes.NESTED_KW


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _dirs(n, seed, upper=False):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    if upper:
        v[:, 2] = np.abs(v[:, 2])
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _mat_params(tag, seed, n=N):
    """Per-lane MatParams of one BSDF tag (or per-lane tags) with random
    parameters; HK reads cond_eta / cond_k as sigma_s / sigma_a, exponent
    as the slab's thickness and alpha_u as its g."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.05, 0.6, n).astype(np.float32)
    hk = np.asarray(tag) == B.HK
    arrays = dict(
        bsdf_type=np.broadcast_to(np.asarray(tag, np.int32), (n,)).copy(),
        dist_type=np.full(n, jmf.GGX, np.int32),
        albedo=rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32),
        specular=rng.uniform(0.1, 1.0, (n, 3)).astype(np.float32),
        transmittance=rng.uniform(0.5, 1.0, (n, 3)).astype(np.float32),
        eta=rng.uniform(1.2, 1.9, n).astype(np.float32),
        cond_eta=rng.uniform(0.1, 3.0, (n, 3)).astype(np.float32),
        cond_k=rng.uniform(0.1, 4.0, (n, 3)).astype(np.float32),
        alpha_u=np.where(hk, rng.uniform(-0.5, 0.8, n), a).astype(np.float32),
        alpha_v=rng.uniform(0.05, 0.6, n).astype(np.float32),
        exponent=np.where(hk, rng.uniform(0.05, 1.0, n), rng.uniform(2.0, 60.0, n))
        .astype(np.float32),
        nonlinear=(rng.random(n) < 0.5).astype(np.float32),
        blend_weight=rng.uniform(0.0, 1.0, n).astype(np.float32),
    )
    return (jbsdf.MatParams(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            tbsdf.MatParams(**{k: _t(v) for k, v in arrays.items()}))


def _scaled_close(got, want, err_msg):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-5 * max(float(np.abs(want).max()), 1e-6), err_msg=err_msg)


def _check_eval(jf, jp, tf, tp):
    _scaled_close(tf, jf, "f")
    _scaled_close(tp, jp, "pdf")


def _check_sample(tbs, jbs):
    st_same = tbs.sampled_type.numpy() == np.asarray(jbs.sampled_type)
    assert st_same.mean() >= 0.999
    wi_close = (np.abs(tbs.wi.numpy() - np.asarray(jbs.wi)) <= 1e-4).all(-1)
    assert wi_close.mean() >= 0.999
    ok = st_same & wi_close
    for f, rtol in (("weight", 3e-3), ("pdf", 1e-4), ("eta", 1e-6)):
        a, b = getattr(tbs, f).numpy()[ok], np.asarray(getattr(jbs, f))[ok]
        np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-5 * max(float(np.abs(b).max()), 1e-6),
                                   err_msg=f)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return (_dirs(N, seed), _dirs(N, seed + 1), rng.random((N, 2), dtype=np.float32),
            rng.random(N, dtype=np.float32))


@pytest.mark.parametrize("tag", NEW, ids=NEW_IDS)
def test_new_family_eval_pdf_sample(tag):
    jmp, tmp = _mat_params(tag, 40 + tag)
    wo, wi, u2, u1 = _inputs(50)
    active = (B.DIFFUSE, tag)
    jf, jp = jbsdf.eval_bsdf(jmp, jnp.asarray(wo), jnp.asarray(wi), active)
    tf, tp = tbsdf.eval_bsdf(tmp, _t(wo), _t(wi), active)
    _check_eval(jf, jp, tf, tp)
    jbs = jbsdf.sample_bsdf(jmp, jnp.asarray(wo), jnp.asarray(u2), jnp.asarray(u1), active)
    tbs = tbsdf.sample_bsdf(tmp, _t(wo), _t(u2), _t(u1), active)
    _check_sample(tbs, jbs)
    np.testing.assert_array_equal(tbsdf.is_delta(tmp).numpy(), np.asarray(jbsdf.is_delta(jmp)))
    if tag == B.NULL_BSDF:   # no family: zero weight and pdf on every lane
        assert not tbs.pdf.any() and not tbs.weight.any() and not tf.any()
    else:
        assert (tbs.pdf.numpy() > 0).mean() > 0.3
        assert tbs.weight.abs().sum() > 0


def test_mixed_tags_dispatch():
    """Every tag at once, one per lane, with every family active: each lane
    takes its own family, as in JAX."""
    tags = np.random.default_rng(60).integers(0, 16, N)
    jmp, tmp = _mat_params(tags, 61)
    wo, wi, u2, u1 = _inputs(62)
    jf, jp = jbsdf.eval_bsdf(jmp, jnp.asarray(wo), jnp.asarray(wi), ALL)
    tf, tp = tbsdf.eval_bsdf(tmp, _t(wo), _t(wi), ALL)
    _check_eval(jf, jp, tf, tp)
    _check_sample(tbsdf.sample_bsdf(tmp, _t(wo), _t(u2), _t(u1), ALL),
                  jbsdf.sample_bsdf(jmp, jnp.asarray(wo), jnp.asarray(u2), jnp.asarray(u1), ALL))


@pytest.mark.parametrize("outer,inner", NESTED, ids=NESTED_IDS)
def test_nested_eval_pdf_sample(outer, inner):
    jmp, tmp = _mat_params(outer, 70 + outer)
    jin, tin = _mat_params(inner, 80 + inner)
    wo, wi, u2, u1 = _inputs(90)
    active = (inner, outer)
    jf, jp = jbsdf.eval_bsdf_nested(jmp, jin, jnp.asarray(wo), jnp.asarray(wi), active)
    tf, tp = tbsdf.eval_bsdf_nested(tmp, tin, _t(wo), _t(wi), active)
    _check_eval(jf, jp, tf, tp)
    args = (jnp.asarray(wo), jnp.asarray(u2), jnp.asarray(u1))
    jbs = jbsdf.sample_bsdf_nested(jmp, jin, *args, active)
    tbs = tbsdf.sample_bsdf_nested(tmp, tin, _t(wo), _t(u2), _t(u1), active)
    _check_sample(tbs, jbs)
    assert (tbs.pdf.numpy() > 0).mean() > 0.3
    # the outer tag alone, without the nested dispatch, carries no weight
    plain = tbsdf.sample_bsdf(tmp, _t(wo), _t(u2), _t(u1), active)
    assert not plain.weight.any() and not plain.pdf.any()


def test_roughness_to_alpha():
    r = np.array([0.0, 1e-6, 1e-4, 0.3, 1.0], np.float32)
    np.testing.assert_array_equal(tmf.roughness_to_alpha(_t(r)).numpy(),
                                  np.asarray(jmf.roughness_to_alpha(r)))


def _assert_images_close(got, want, frac=0.99, rel=1e-3):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    ok = (np.abs(got - want) <= rel * np.abs(want) + 1e-6).all(-1)
    assert ok.mean() >= frac, f"only {ok.mean():.4f} of pixels within {rel}"
    assert abs(got.mean() - want.mean()) <= 1e-4 * abs(want.mean())


def _jax_nested(outer, inner=B.DIFFUSE):
    inp = tshapes.nested_furnace_inputs(outer, inner, **NESTED_KW)
    return jbuild(inp["vertices"], None, None, inp["mat_id"], JMaterials.build(inp["materials"]),
                  JTextures.build(inp["textures"]), inp["lights"],
                  JCamera.look_at(**inp["camera"]))


def _furnace(tag):
    return jfurnace(**FURNACE_KW[tag])


@pytest.mark.parametrize("tag", NEW, ids=NEW_IDS)
def test_furnace_render_matches_jax(tag):
    js = _furnace(tag)
    want = jpt.render(js, W, H, SPP, SEED, jpt.PTConfig(max_depth=DEPTH))
    got = tpt.render(scene_from_numpy(flatten(js), device="cpu"), W, H, SPP, SEED,
                     tpt.PTConfig(max_depth=DEPTH))
    _assert_images_close(got, want)


@pytest.mark.parametrize("outer", (B.COATING, B.ROUGHCOATING, B.BLEND),
                         ids=["coating", "roughcoating", "blend"])
def test_nested_furnace_render_matches_jax(outer):
    """The nested BSDFs over a DIFFUSE inner material: the port's own
    factory equals JAX's scene built from the same inputs, and renders it
    as JAX does (the nested dispatch of `surface_bounce`)."""
    js = _jax_nested(outer)
    ts = tshapes.nested_furnace(outer, device="cpu", **NESTED_KW)
    assert tpt.specialize_config(ts, tpt.PTConfig()).bsdf_types == (B.DIFFUSE, outer)
    want = jpt.render(js, W, H, SPP, SEED, jpt.PTConfig(max_depth=DEPTH))
    _assert_images_close(tpt.render(ts, W, H, SPP, SEED, tpt.PTConfig(max_depth=DEPTH)), want)


@pytest.mark.parametrize("tag", (B.PLASTIC, B.PHONG), ids=["plastic", "phong"])
def test_albedo_gradient_matches_jax(tag):
    """d mean(render) / d the albedo texture of a PLASTIC and of a PHONG
    sphere in the furnace."""
    js = _furnace(tag)
    cfg = dict(max_depth=3, rr_start=99)
    jcfg = jpt.specialize_config(js, jpt.PTConfig(**cfg))
    jl, jg = jax.value_and_grad(lambda s: jnp.mean(jpt.render(s, W, H, SPP, 0, jcfg)),
                                allow_int=True)(js)
    want = np.asarray(jg.textures.color_a)
    ts = with_grad(scene_from_numpy(flatten(js), device="cpu"), ["textures.color_a"])
    loss = tpt.render(ts, W, H, SPP, 0, tpt.PTConfig(**cfg)).mean()
    loss.backward()
    got = grads(ts)["textures.color_a"]
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    assert np.abs(want[0]).min() > 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("outer", (B.COATING, B.ROUGHCOATING, B.BLEND),
                         ids=["coating", "roughcoating", "blend"])
def test_nested_inner_albedo_gradient_matches_jax(outer):
    """The gradient of the nested BSDFs with respect to the inner
    material's albedo and an outer field (the coating's specular, the
    blend's own albedo), lane by lane: of the seeded sum of eval's f and
    pdf and of the sample's weight and pdf, so the detached sites (1 - F_o
    of the coating's inner weight, the blend's pdf) are held too. (The same
    through `render` costs JAX 140 s of compile for COATING.)"""
    n = 1024
    jmp, tmp = _mat_params(outer, 100 + outer, n)
    jin, tin = _mat_params(B.DIFFUSE, 110, n)
    wo, wi, u2, u1 = (x[:n] for x in _inputs(120))
    g3 = np.random.default_rng(121).uniform(-1, 1, (4, n, 3)).astype(np.float32)
    active = (B.DIFFUSE, outer)
    field = "albedo" if outer == B.BLEND else "specular"

    def jloss(alb, own):
        mp, mi = jmp._replace(**{field: own}), jin._replace(albedo=alb)
        f, p = jbsdf.eval_bsdf_nested(mp, mi, jnp.asarray(wo), jnp.asarray(wi), active)
        bs = jbsdf.sample_bsdf_nested(mp, mi, jnp.asarray(wo), jnp.asarray(u2), jnp.asarray(u1),
                                      active)
        return (jnp.sum(f * g3[0]) + jnp.sum(p * g3[1, :, 0]) + jnp.sum(bs.weight * g3[2])
                + jnp.sum(bs.pdf * g3[3, :, 0]))

    want = jax.grad(jloss, argnums=(0, 1))(jin.albedo, getattr(jmp, field))
    alb = tin.albedo.clone().requires_grad_()
    own = getattr(tmp, field).clone().requires_grad_()
    mp, mi = tmp._replace(**{field: own}), tin._replace(albedo=alb)
    f, p = tbsdf.eval_bsdf_nested(mp, mi, _t(wo), _t(wi), active)
    bs = tbsdf.sample_bsdf_nested(mp, mi, _t(wo), _t(u2), _t(u1), active)
    g = _t(g3)
    ((f * g[0]).sum() + (p * g[1, :, 0]).sum() + (bs.weight * g[2]).sum()
     + (bs.pdf * g[3, :, 0]).sum()).backward()
    for name, t, j in (("inner albedo", alb, want[0]), (f"outer {field}", own, want[1])):
        j = np.asarray(j)
        assert np.abs(j).max() > 0, name
        np.testing.assert_allclose(t.grad.numpy(), j, rtol=1e-3, atol=1e-4 * np.abs(j).max(),
                                   err_msg=name)


# ---- the port's TestFurnace (tests/test_render.py:18-60), at its sizes ----

@pytest.mark.slow
def test_port_diffuse_furnace():
    scene = tshapes.furnace_scene(albedo=0.7, bsdf_type=B.DIFFUSE, device="cpu")
    img = tpt.render(scene, 48, 48, 32, 0, tpt.PTConfig(max_depth=6)).numpy()
    assert abs(img[0:4, 0:4].mean() - 1.0) < 0.02
    assert abs(img[18:30, 18:30].mean() - 0.7) < 0.03


@pytest.mark.slow
def test_port_white_furnace_unit_albedo():
    scene = tshapes.furnace_scene(albedo=1.0, bsdf_type=B.DIFFUSE, device="cpu")
    img = tpt.render(scene, 32, 32, 32, 0, tpt.PTConfig(max_depth=16)).numpy()
    assert abs(img.mean() - 1.0) < 0.03


ENERGY_CASES = [
    (B.ROUGHCONDUCTOR, dict(alpha_u=0.3, alpha_v=0.3)), (B.PLASTIC, {}),
    (B.ROUGHPLASTIC, dict(alpha_u=0.3, alpha_v=0.3)), (B.PHONG, {}),
    (B.WARD, dict(alpha_u=0.3, alpha_v=0.3)), (B.ROUGHDIELECTRIC, dict(alpha_u=0.1, alpha_v=0.1,
                                                                        dist_type=0)),
    (B.DIELECTRIC, {}), (B.ROUGHDIELECTRIC, dict(alpha_u=0.3, alpha_v=0.3)),
    (B.THINDIELECTRIC, {}), (B.CONDUCTOR, {}), (B.ROUGHDIFFUSE, dict(alpha_u=0.3)),
]


@pytest.mark.slow
@pytest.mark.parametrize("bt,kw", ENERGY_CASES)
def test_port_energy_conservation(bt, kw):
    spec = 0.2 if bt in (B.PHONG, B.WARD) else 1.0
    scene = tshapes.furnace_scene(albedo=0.8, bsdf_type=bt, specular=spec, device="cpu", **kw)
    img = tpt.render(scene, 32, 32, 16, 0, tpt.PTConfig(max_depth=8)).numpy()
    assert np.isfinite(img).all()
    assert img.mean() < 1.1, f"type {bt} gains energy: {img.mean()}"
    if bt in (B.DIELECTRIC, B.THINDIELECTRIC, B.ROUGHDIELECTRIC):
        assert img.mean() > 0.85, f"type {bt} loses too much: {img.mean()}"
