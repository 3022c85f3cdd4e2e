"""Spectral rendering: math/spectrum.py, math/spectral.py,
math/dispersion.py and render/spectral.py against the JAX package on the
CPU (scenes built by JAX and carried across by `convert`).

Tolerances, stated once:
  * the calibration (uplift matrix, int ybar, white balance) within 1e-6
    relative; `cie_xyz` within 2e-7 absolute (peak ~1); wavelengths within
    2e-5 nm (float32 at ~700); band indicators and packed RGBE / RGBCOL
    words equal; colour conversions within 1e-6 of the largest entry;
  * `dispersive_eta` (Cauchy, Sellmeier) within 1e-6;
  * `trace_radiance_spectral` lane by lane at seed 3 on Cornell, the
    dispersive caustic scene and a rough dispersive sphere: every lane
    within 1e-4 of the largest lane's radiance;
  * `render_spectral`, its progressive mean and `render_spectral_vol`:
    every pixel within 1e-4 of the image's largest entry;
  * gradients against `jax.grad`: d mean / d light radiance and d (ramp-
    weighted mean) / d cauchy_c within 1e-3 relative; d mean / d sigma_s
    scale through `render_spectral_vol` within 1e-3 of JAX's, and against
    a central difference at JAX's own gate and setting (rtol 0.35; the
    furnace in a box of medium).

The one deliberate difference is the guarded continue gate (the port adds
`bs.pdf > 0`, render/spectral.py's docstring): `trace_radiance_spectral(...,
with_gate=True)` counts the lanes it stops where JAX's gate continues them
(the renders below trace the same lanes), and the tests
hold every pixel to JAX's except at most those lanes' pixels. On these
scenes the count is 0: a sampled rough refraction with pdf 0 and positive
per-wavelength pdfs is rare enough that 2^18 synthetic rough-dispersive
samples hold none either (counted below).
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.math import dispersion as jdisp
from cudatracerlib_tpu.math import spectral as jsp
from cudatracerlib_tpu.math import spectrum as jspec
from cudatracerlib_tpu.render import path_tracer as jpt
from cudatracerlib_tpu.render import spectral as jsr
from cudatracerlib_tpu.sampling.rng import Sampler as JSampler
from cudatracerlib_tpu.scene import media as jmedia
from cudatracerlib_tpu.scene.shapes import caustic_scene as jcaustic
from cudatracerlib_tpu.scene.shapes import cornell_box as jcornell
from cudatracerlib_tpu.scene.shapes import furnace_scene as jfurnace
from cudatracerlib_tpu_torch.convert import flatten, media_from_numpy, scene_from_numpy
from cudatracerlib_tpu_torch.math import dispersion as tdisp
from cudatracerlib_tpu_torch.math import spectral as tsp
from cudatracerlib_tpu_torch.math import spectrum as tspec
from cudatracerlib_tpu_torch.render import path_tracer as tpt
from cudatracerlib_tpu_torch.render import spectral as tsr
from cudatracerlib_tpu_torch.scene import bsdf as tbsdf

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import engines_cases as ec  # noqa: E402

S, SPP, SEED = 16, 4, 3


def _close(got, ref, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1e-30))


def _rough(js):
    """The caustic scene's glass sphere turned rough (alpha 0.15) and
    dispersive; a fresh mat_id array so the JAX package derives its
    specialization from the new materials."""
    m = js.materials
    mats = m._replace(bsdf_type=jnp.where(m.bsdf_type == 2, 4, m.bsdf_type),
                      alpha_u=jnp.full_like(m.alpha_u, 0.15), alpha_v=jnp.full_like(m.alpha_v, 0.15),
                      cauchy_c=jnp.where(m.bsdf_type == 2, ec.DISP_C, 0.0))
    return js._replace(materials=mats,
                       shading=js.shading._replace(mat_id=jnp.array(js.shading.mat_id)))


@pytest.fixture(scope="module")
def scenes():
    cornell, caustic = jcornell(), jcaustic()
    out = {"cornell": cornell, "dispersive": ec.with_cauchy(caustic, ec.DISP_C),
           "rough": _rough(caustic)}
    return {k: (js, scene_from_numpy(flatten(js), device="cpu")) for k, js in out.items()}


# ---- math ----

def test_calibration_matches_jax():
    np.testing.assert_allclose(np.asarray(tsp._UPLIFT_M), np.asarray(jsp._UPLIFT_M), rtol=1e-6)
    np.testing.assert_allclose(tsp._Y_INT, float(jsp._Y_INT), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(tsp._BALANCE), np.asarray(jsp._BALANCE), rtol=1e-6)


def test_cie_wavelengths_and_uplift_match_jax():
    rng = np.random.default_rng(0)
    lam_grid = np.linspace(370.0, 730.0, 1001, dtype=np.float32)
    _close(tsp.cie_xyz(torch.from_numpy(lam_grid)), jsp.cie_xyz(jnp.asarray(lam_grid)), 2e-7)
    np.testing.assert_array_equal(tsp.band_responses(torch.from_numpy(lam_grid)).numpy(),
                                  np.asarray(jsp.band_responses(jnp.asarray(lam_grid))))
    u = rng.random(4096, dtype=np.float32)
    lam_t, pdf_t = tsp.sample_wavelengths(torch.from_numpy(u))
    lam_j, pdf_j = jsp.sample_wavelengths(jnp.asarray(u))
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j), rtol=0, atol=2e-5)
    assert pdf_t == pytest.approx(float(pdf_j))
    lam = np.asarray(lam_j)
    rgb = rng.gamma(1.5, 0.6, (4096, 3)).astype(np.float32)
    _close(tsp.rgb_to_spectrum(torch.from_numpy(rgb), torch.from_numpy(lam)),
           jsp.rgb_to_spectrum(jnp.asarray(rgb), jnp.asarray(lam)), 1e-6)
    L = rng.gamma(1.5, 0.6, (4096, 4)).astype(np.float32)
    _close(tsp.spectral_to_rgb(torch.from_numpy(L), torch.from_numpy(lam), pdf_t),
           jsp.spectral_to_rgb(jnp.asarray(L), jnp.asarray(lam), pdf_j), 1e-6)


def test_spectrum_module_matches_jax():
    rng = np.random.default_rng(1)
    rgb = (rng.gamma(1.0, 0.5, (2048, 3)) * (rng.random((2048, 1)) < 0.9)).astype(np.float32)
    t, j = torch.from_numpy(rgb), jnp.asarray(rgb)
    for name in ("luminance", "average", "max_component", "rgb_to_xyz", "xyz_to_rgb",
                 "linear_to_srgb", "srgb_to_linear"):
        _close(getattr(tspec, name)(t), getattr(jspec, name)(j), 1e-6)
    np.testing.assert_array_equal(tspec.is_black(t).numpy(), np.asarray(jspec.is_black(j)))
    for pack, unpack in (("to_rgbe", "from_rgbe"), ("to_rgbcol", "from_rgbcol")):
        wt, wj = getattr(tspec, pack)(t), getattr(jspec, pack)(j)
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj).astype(np.int64))
        _close(getattr(tspec, unpack)(wt), getattr(jspec, unpack)(wj), 1e-6)


def test_dispersion_matches_jax():
    lam = np.linspace(400.0, 700.0, 64, dtype=np.float32)
    eta = np.full(64, 1.5, np.float32)
    cc = np.linspace(0.0, 0.05, 64, dtype=np.float32)
    _close(tsr.dispersive_eta(torch.from_numpy(eta), torch.from_numpy(cc), torch.from_numpy(lam)),
           jsr.dispersive_eta(jnp.asarray(eta), jnp.asarray(cc), jnp.asarray(lam)), 1e-6)
    sb = np.tile(np.asarray(tdisp.SELLMEIER_BK7[0], np.float32), (64, 1))
    sb[::2] = 0.0                                  # every other lane falls back to Cauchy
    sc = np.tile(np.asarray(tdisp.SELLMEIER_BK7[1], np.float32), (64, 1))
    args = (eta, cc, lam, sb, sc)
    _close(tsr.dispersive_eta(*map(torch.from_numpy, args)),
           jsr.dispersive_eta(*map(jnp.asarray, args)), 1e-6)
    assert tdisp.SELLMEIER_BK7 == jdisp.SELLMEIER_BK7
    assert tdisp.CAUCHY_PRESETS == jdisp.CAUCHY_PRESETS and tdisp.LAMBDA_RGB == jdisp.LAMBDA_RGB
    _close(tdisp.rgb_ior_cauchy("sf10", device="cpu"), jdisp.rgb_ior_cauchy("sf10"), 1e-6)
    lam_um = np.asarray([0.45, 0.55, 0.65], np.float32)
    _close(tdisp.sellmeier_ior(torch.from_numpy(lam_um), *tdisp.SELLMEIER_BK7),
           jdisp.sellmeier_ior(jnp.asarray(lam_um), *jdisp.SELLMEIER_BK7), 1e-6)
    _close(tdisp.cauchy_ior(torch.from_numpy(lam_um), 1.5, 0.0042),
           jdisp.cauchy_ior(jnp.asarray(lam_um), 1.5, 0.0042), 1e-6)


# ---- the tracer ----

@pytest.mark.parametrize("name", ["cornell", "dispersive", "rough"])
def test_trace_radiance_spectral_lanes_match_jax(scenes, name):
    js, ts = scenes[name]
    tcfg = tpt.specialize_config(ts, tpt.PTConfig(max_depth=5, rr_start=99))
    jcfg = jpt.specialize_config(js, jpt.PTConfig(max_depth=5, rr_start=99))
    assert set(tcfg.bsdf_types) == set(jcfg.bsdf_types)
    o, d, _, smp, lam, _ = tsr._camera_lam(ts, S, S, SPP, SEED)
    L, smp_t, n_gate = tsr.trace_radiance_spectral(ts, o, d, lam, smp, tcfg, with_gate=True)
    trace = jax.jit(lambda o, d, lam, st: jsr.trace_radiance_spectral(
        js, o, d, lam, JSampler(state=st), jcfg))
    Lj, smp_j = trace(*(jnp.asarray(x.numpy()) for x in (o, d, lam)),
                      jnp.asarray(smp.state.numpy().astype(np.uint32)))
    assert int(n_gate) == 0
    _close(L, Lj, 1e-4)
    np.testing.assert_array_equal(smp_t.state.numpy(), np.asarray(smp_j.state).astype(np.int64))
    assert float(L.max()) > 0


@pytest.mark.parametrize("name", ["cornell", "dispersive"])
def test_render_spectral_matches_jax(scenes, name):
    js, ts = scenes[name]
    cfg = dict(max_depth=5, rr_start=99)
    img = tsr.render_spectral(ts, S, S, SPP, SEED, tpt.PTConfig(**cfg))
    _close(img, jsr.render_spectral(js, S, S, SPP, SEED, jpt.PTConfig(**cfg)), 1e-4)
    prog = tsr.render_spectral_progressive(ts, S, S, 2, 2, 5, tpt.PTConfig(**cfg))
    _close(prog, jsr.render_spectral_progressive(js, S, S, 2, 2, 5, jpt.PTConfig(**cfg)), 1e-4)


def _medium_pair(js):
    jm = jmedia.Media.build(ec.cornell_medium(js))
    return jm, media_from_numpy(flatten(jm), device="cpu")


def test_render_spectral_vol_matches_jax(scenes):
    js, ts = scenes["cornell"]
    jm, tm = _medium_pair(js)
    img = tsr.render_spectral_vol(ts, tm, S, S, SPP, SEED, tpt.PTConfig(max_depth=5))
    _close(img, jsr.render_spectral_vol(js, jm, S, S, SPP, SEED, jpt.PTConfig(max_depth=5)), 1e-4)
    assert float(img.mean()) > 0


# ---- gradients ----

def test_gradients_match_jax_grad(scenes):
    """d mean / d light radiance on Cornell, d (ramp-weighted mean) / d
    cauchy_c on the caustic scene's glass (tests/test_spectral.py's loss)."""
    p = ec.PIN["grad_radiance"]
    js, ts = scenes["cornell"]
    jcfg = jpt.PTConfig(max_depth=p["max_depth"], rr_start=p["rr_start"])
    tcfg = tpt.PTConfig(max_depth=p["max_depth"], rr_start=p["rr_start"])

    def jloss(rad):
        sc = js._replace(lights=js.lights._replace(radiance=rad))
        return jsr.render_spectral(sc, p["size"], p["size"], p["spp"], p["seed"], jcfg).mean()

    g_ref = np.asarray(jax.grad(jloss)(js.lights.radiance))
    rad = ts.lights.radiance.clone().requires_grad_()
    tsr.render_spectral(ts._replace(lights=ts.lights._replace(radiance=rad)), p["size"],
                        p["size"], p["spp"], p["seed"], tcfg).mean().backward()
    np.testing.assert_allclose(rad.grad.numpy(), g_ref, rtol=1e-3)

    q = ec.PIN["grad_cauchy"]
    jc, tc = scenes["dispersive"]
    ramp = ec.weight_ramp(q["size"])
    jcfg = jpt.PTConfig(max_depth=q["max_depth"], rr_start=q["rr_start"])
    tcfg = tpt.PTConfig(max_depth=q["max_depth"], rr_start=q["rr_start"])

    def jloss_c(c):
        img = jsr.render_spectral(ec.with_cauchy(jc, c), q["size"], q["size"], q["spp"],
                                  q["seed"], jcfg)
        return (img * ramp).mean()

    l_ref, gc_ref = jax.value_and_grad(jloss_c)(jnp.float32(q["c"]))
    c = torch.tensor(q["c"], requires_grad=True)
    loss = (tsr.render_spectral(ec.with_cauchy(tc, c), q["size"], q["size"], q["spp"], q["seed"],
                                tcfg) * torch.from_numpy(ramp)).mean()
    loss.backward()
    assert float(loss) == pytest.approx(float(l_ref), rel=1e-5)
    assert abs(float(gc_ref)) > 0
    assert float(c.grad) == pytest.approx(float(gc_ref), rel=1e-3)


def test_vol_gradient_matches_jax_and_central_difference():
    """d mean / d sigma_s scale through the spectral volume path, in
    tests/test_spectral.py's setting (the furnace sphere in a box of
    medium, 16x16, 12 spp, depth 3, seed 2)."""
    js = jfurnace(albedo=0.5, env_radiance=1.0)
    ts = scene_from_numpy(flatten(js), device="cpu")
    jm = jmedia.Media.build(ec.furnace_medium(js))
    tm = media_from_numpy(flatten(jm), device="cpu")
    cfg = dict(max_depth=3, rr_start=99)

    def jloss(s):
        return jsr.render_spectral_vol(js, jm._replace(sigma_s=jm.sigma_s * s), 16, 16, 12, 2,
                                       jpt.PTConfig(**cfg)).mean()

    def tloss(s):
        return tsr.render_spectral_vol(ts, tm._replace(sigma_s=tm.sigma_s * s), 16, 16, 12, 2,
                                       tpt.PTConfig(**cfg)).mean()

    g_ref = float(jax.grad(jloss)(jnp.float32(1.0)))
    s = torch.tensor(1.0, requires_grad=True)
    tloss(s).backward()
    g = float(s.grad)
    assert g == pytest.approx(g_ref, rel=1e-3)
    eps = 0.05
    with torch.no_grad():
        fd = (float(tloss(torch.tensor(1 + eps))) - float(tloss(torch.tensor(1 - eps)))) / (2 * eps)
    assert np.isfinite(g) and abs(fd) > 1e-5
    np.testing.assert_allclose(g, fd, rtol=0.35)


def test_guarded_gate_difference_counted():
    """Where the guarded gate and JAX's differ: refracted rough-dispersive
    samples whose own pdf is 0 while the per-wavelength pdfs along their
    direction are positive. Counted on 2^18 seeded samples (both sides of
    the interface, alpha 0.02-0.62, cauchy_c 0.03); the renders above
    count them per lane (0 there)."""
    g = torch.Generator().manual_seed(0)
    n = 1 << 18
    wo = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=-1)
    u2, u1, ul = torch.rand(n, 2, generator=g), torch.rand(n, generator=g), torch.rand(n, generator=g)
    lam, _ = tsp.sample_wavelengths(ul)
    al = torch.rand(n, generator=g) * 0.6 + 0.02
    cc, eta_d, ones = torch.full((n,), ec.DISP_C), torch.full((n,), 1.5), torch.ones(n, 3)
    mp = tbsdf.MatParams(
        bsdf_type=torch.full((n,), tbsdf.ROUGHDIELECTRIC, dtype=torch.int32),
        dist_type=torch.ones(n, dtype=torch.int32), albedo=ones, specular=ones,
        transmittance=ones, eta=tsr.dispersive_eta(eta_d, cc, lam[:, 0]), cond_eta=ones,
        cond_k=ones, alpha_u=al, alpha_v=al, exponent=torch.zeros(n), nonlinear=torch.zeros(n),
        blend_weight=torch.zeros(n))
    active = (tbsdf.ROUGHDIELECTRIC,)
    bs = tbsdf.sample_bsdf(mp, wo, u2, u1, active=active)
    pdfs = [tbsdf.eval_bsdf(mp._replace(eta=tsr.dispersive_eta(eta_d, cc, lam[:, j])), wo, bs.wi,
                            active=active)[1] for j in range(lam.shape[1])]
    pdf_mean = torch.stack(pdfs, -1).mean(-1)
    refracted = (bs.sampled_type & tsr._TRANSMIT) > 0
    differ = refracted & (bs.pdf <= 0) & (pdf_mean > 0)
    assert int(refracted.sum()) > n // 4
    assert int(differ.sum()) == 0
