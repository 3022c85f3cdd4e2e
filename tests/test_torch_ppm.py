"""The progressive photon mapping slice (bench config 5's PPM half) in the
port against the JAX package, on the CPU: the DIELECTRIC sampler, emitted
rays of area and environment lights, the caustic scene, the film, the
photon pass and the whole PPM pass on both density branches.

Tolerances:
  * BSDF samples and emitted rays within 1e-6 (relative, plus 1e-6 of the
    values' scale): the same float32 operations in the same order;
  * scene arrays exactly equal; the progressive radius bit for bit;
  * photon pass at 4,096 photons: valid and caustic masks and the ray count
    equal, positions and power within 1e-5 relative (positions also 1e-4
    absolute, see the test);
  * `render_ppm_pass` at 16x16, 1 spp, 4,096 photons, seed 3, pass 1:
    - query-major branch (the CPU default of both packages): every pixel
      within 1e-3 relative (+1e-6), the image sums within 1e-5 relative
      (1.2e-4 and 6.6e-7 measured): float32 rounding in the two
      intersectors and the BSDF evaluation;
    - photon-major branch (both packages' `ppm_uses_kernel` patched to
      True): the port's plain density against JAX's interpret-mode kernel,
      every pixel within 2e-3 relative (+1e-5), the sums within 1e-4
      relative (9.7e-4 and 2.1e-5 measured): the TPU kernel's bf16 hi/lo
      split and its expanded d^2.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import cudatracerlib_tpu.ops.photon_gather as jpg
from cudatracerlib_tpu.image import film as jfilm
from cudatracerlib_tpu.render import path_tracer as jpt
from cudatracerlib_tpu.render import ppm as jppm
from cudatracerlib_tpu.scene import bsdf as jbsdf
from cudatracerlib_tpu.scene import lights as jlights
from cudatracerlib_tpu.scene.shapes import _sky_envmap, caustic_scene as jcaustic
from cudatracerlib_tpu_torch import convert
from cudatracerlib_tpu_torch.convert import flatten
from cudatracerlib_tpu_torch.image import film as tfilm
from cudatracerlib_tpu_torch.ops import photon_gather as tpg
from cudatracerlib_tpu_torch.render import path_tracer as tpt
from cudatracerlib_tpu_torch.render import ppm as tppm
from cudatracerlib_tpu_torch.scene import bsdf as tbsdf
from cudatracerlib_tpu_torch.scene import lights as tlights
from cudatracerlib_tpu_torch.scene import shapes as tshapes

N = 4096
RENDER = dict(width=16, height=16, spp=1, seed=3, pass_idx=1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(t, j, rtol=1e-6, err_msg=""):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=rtol,
                               atol=1e-6 * max(float(np.abs(j).max()), 1.0), err_msg=err_msg)


@pytest.fixture(scope="module")
def scenes():
    return jcaustic(), tshapes.caustic_scene(device="cpu")


def test_entry_points_default_to_the_card():
    for fn in (tshapes.caustic_scene, convert.scene_from_numpy, tfilm.Film.create):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__


def test_caustic_arrays_exactly_equal(scenes):
    js, ts = scenes
    a, b = flatten(js), flatten(ts)
    assert set(b) <= set(a)
    for k in sorted(b):
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert ts.bvh.woop.shape == (3160, 12)
    want = jpt.specialize_config(js, jpt.PTConfig())
    got = tpt.specialize_config(ts, tpt.PTConfig())
    for f in tpt.PTConfig._fields:
        assert getattr(got, f) == getattr(want, f), f
    assert got.bsdf_types == (tbsdf.DIFFUSE, tbsdf.DIELECTRIC) and got.light_types == (3,)


def test_dielectric_sample_matches_jax():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(N, 3)).astype(np.float32)
    wo = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)  # both sides
    arrays = dict(
        bsdf_type=np.full(N, tbsdf.DIELECTRIC, np.int32), dist_type=np.ones(N, np.int32),
        albedo=rng.uniform(0.1, 1.0, (N, 3)).astype(np.float32),
        specular=rng.uniform(0.5, 1.0, (N, 3)).astype(np.float32),
        transmittance=rng.uniform(0.5, 1.0, (N, 3)).astype(np.float32),
        eta=rng.choice(np.float32([1.5, 1.33, 2.4, 1.0]), N),
        cond_eta=np.zeros((N, 3), np.float32), cond_k=np.zeros((N, 3), np.float32),
        alpha_u=np.full(N, 0.1, np.float32), alpha_v=np.full(N, 0.1, np.float32),
        exponent=np.full(N, 30.0, np.float32), nonlinear=np.zeros(N, np.float32),
        blend_weight=np.full(N, 0.5, np.float32))
    u2 = rng.random((N, 2), dtype=np.float32)
    u1 = rng.random(N, dtype=np.float32)
    active = (tbsdf.DIFFUSE, tbsdf.DIELECTRIC)
    jmp = jbsdf.MatParams(**{k: jnp.asarray(x) for k, x in arrays.items()})
    tmp = tbsdf.MatParams(**{k: _t(x) for k, x in arrays.items()})
    jbs = jbsdf.sample_bsdf(jmp, jnp.asarray(wo), jnp.asarray(u2), jnp.asarray(u1), active)
    tbs = tbsdf.sample_bsdf(tmp, _t(wo), _t(u2), _t(u1), active)
    for f in ("wi", "weight", "pdf", "eta"):
        _close(getattr(tbs, f), getattr(jbs, f), err_msg=f)
    np.testing.assert_array_equal(tbs.sampled_type.numpy(), np.asarray(jbs.sampled_type))
    st = tbs.sampled_type.numpy()
    assert (st == 16).mean() > 0.02 and (st == 32).mean() > 0.5   # both lobes drawn
    f, pdf = tbsdf.eval_bsdf(tmp, _t(wo), _t(wo[:, [1, 0, 2]]), active)
    assert not f.any() and not pdf.any()                            # delta: eval is 0
    assert tbsdf.is_delta(tmp).all()


def _emitted(jl, tl, lid_j, lid_t, active, seed):
    rng = np.random.default_rng(seed)
    u_pos = rng.random((N, 2), dtype=np.float32)
    u_dir = rng.random((N, 2), dtype=np.float32)
    want = jlights.sample_emitter_ray(jl, lid_j, jnp.asarray(u_pos), jnp.asarray(u_dir))
    got = tlights.sample_emitter_ray(tl, lid_t, _t(u_pos), _t(u_dir), active=active)
    for name, a, b in zip(("o", "d", "w"), got, want):
        assert a.shape == (N, 3), name
        _close(a, b, err_msg=name)
    return got


def test_sample_emitter_ray_area_light(scenes):
    js, ts = scenes
    o, d, w = _emitted(js.lights, ts.lights, jnp.int32(0), 0, (tlights.AREA_LIGHT,), 1)
    assert (d[:, 2] < 0).all()    # the ceiling light emits downward


def test_sample_emitter_ray_environment_light():
    env = _sky_envmap()
    rec = [{"type": jlights.INFINITE, "radiance": [1.0, 1.0, 1.0]}]
    jl = jlights.build_lights(rec, [0, 0, 0.5], 8.0, env)
    tl = tlights.build_lights(rec, [0, 0, 0.5], 8.0, env)
    _emitted(jl, tl, jnp.int32(0), 0, (tlights.INFINITE,), 2)


def test_sample_emitter_ray_mixed_lights(scenes):
    """An area light beside the environment, light chosen per lane."""
    js, _ = scenes
    tris = np.asarray(js.lights.tris)[:2]
    rec = [{"type": jlights.AREA_LIGHT, "radiance": [5.0, 4.0, 3.0], "tris": tris},
           {"type": jlights.INFINITE, "radiance": [1.0, 1.0, 1.0]}]
    jl = jlights.build_lights(rec, [0, 0, 1.5], 4.0, _sky_envmap())
    tl = tlights.build_lights(rec, [0, 0, 1.5], 4.0, _sky_envmap())
    lid = (np.random.default_rng(3).random(N) < 0.5).astype(np.int32)
    _emitted(jl, tl, jnp.asarray(lid), _t(lid).long(),
             (tlights.AREA_LIGHT, tlights.INFINITE), 4)
    with pytest.raises(NotImplementedError):
        tlights.sample_emitter_ray(tl, 0, torch.zeros(2, 2), torch.zeros(2, 2), active=(0, 3))


def test_film_matches_jax():
    rng = np.random.default_rng(5)
    pid = rng.integers(0, 6 * 5, 500).astype(np.int32)
    val = rng.uniform(0, 2, (500, 3)).astype(np.float32)
    val[::50] = np.nan
    jf = jfilm.add_samples(jfilm.Film.create(6, 5), jnp.asarray(pid), jnp.asarray(val))
    tf = tfilm.add_samples(tfilm.Film.create(6, 5, device="cpu"), _t(pid), _t(val))
    _close(tfilm.develop(tf), jfilm.develop(jf))
    _close(tf.weight, jf.weight)


def test_progressive_radius_bit_exact():
    """Bit for bit through pass 47; later, XLA's CPU reduction reassociates
    the product of 255 factors and the radius moves by a few ulps."""
    for p in list(range(48)) + [100, 254]:
        want = np.asarray(jppm.progressive_radius(jnp.float32(0.07), jnp.float32(p)))
        got = tppm.progressive_radius(0.07, p)
        assert got.dtype == np.float32, p
        if p < 48:
            assert got.view(np.int32) == want.view(np.int32), p
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6)


def test_ppm_uses_kernel_keys_on_device_and_bsdfs(scenes):
    _, ts = scenes
    cfg = tpt.specialize_config(ts, tpt.PTConfig())
    assert tppm.ppm_uses_kernel(cfg, "cuda") and not tppm.ppm_uses_kernel(cfg, "cpu")
    glossy = cfg._replace(bsdf_types=(tbsdf.DIFFUSE, tbsdf.ROUGHPLASTIC))
    assert not tppm.ppm_uses_kernel(glossy, "cuda")


def test_trace_photons_matches_jax(scenes):
    js, ts = scenes
    jcfg = jpt.specialize_config(js, jppm.PPMConfig().base)
    tcfg = tpt.specialize_config(ts, tppm.PPMConfig().base)
    jpm, jn = jppm.trace_photons(js, N, jnp.uint32(3), jcfg, with_stats=True)
    tpm, tn = tppm.trace_photons(ts, N, 3, tcfg, with_stats=True)
    for f in ("valid", "caustic"):
        np.testing.assert_array_equal(getattr(tpm, f).numpy(), np.asarray(getattr(jpm, f)), f)
    v = tpm.valid.numpy()
    assert 0 < tpm.caustic.numpy().sum() < v.sum() and v.sum() > N // 4
    # positions also within 1e-4 absolute (2.5e-5 of the 4-unit room): a
    # float32 ulp of a hit distance grows at grazing bounces (5.2e-5 measured
    # on 3 of 9,099 coordinates, at depths 3-5)
    for f, atol in (("p", 1e-4), ("power", 1e-6), ("wi", 1e-5), ("n", 1e-6)):
        np.testing.assert_allclose(getattr(tpm, f).numpy()[v], np.asarray(getattr(jpm, f))[v],
                                   rtol=1e-5, atol=atol, err_msg=f)
    assert int(tn) == int(jn)


def _render_both(js, ts, caustic_map=True):
    r = RENDER
    want = np.asarray(jppm.render_ppm_pass(
        js, r["width"], r["height"], r["spp"], r["seed"], r["pass_idx"],
        jppm.PPMConfig(n_photons=N, caustic_map=caustic_map)))
    got = tppm.render_ppm_pass(
        ts, r["width"], r["height"], r["spp"], r["seed"], r["pass_idx"],
        tppm.PPMConfig(n_photons=N, caustic_map=caustic_map)).numpy()
    assert got.shape == want.shape == (16, 16, 3) and np.isfinite(got).all()
    return got, want


@pytest.mark.parametrize("caustic_map", [True, False], ids=["two-maps", "one-map"])
def test_render_ppm_pass_query_major_matches_jax(scenes, caustic_map):
    js, ts = scenes
    got, want = _render_both(js, ts, caustic_map)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6)
    assert abs(got.sum() - want.sum()) <= 1e-5 * abs(want.sum())
    assert want.mean() > 0.1


def test_render_ppm_pass_kernel_branch_matches_jax(scenes, monkeypatch):
    """Both packages forced onto the photon-major branch: JAX's kernel runs
    in interpret mode, the port's wrapper takes the plain version (CPU).
    JAX's traces are cleared around the run: `_ppm_impl` is jitted with the
    branch chosen at trace time."""
    js, ts = scenes
    calls = {"jax": 0, "port": 0}

    def counted(fn, key):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(jpg, "photon_density_tpu", counted(jpg.photon_density_tpu, "jax"))
    monkeypatch.setattr(tpg, "photon_density", counted(tpg.photon_density, "port"))
    monkeypatch.setattr(jppm, "ppm_uses_kernel", lambda cfg: True)
    monkeypatch.setattr(tppm, "ppm_uses_kernel", lambda cfg, device: True)
    jax.clear_caches()
    try:
        with pltpu.force_tpu_interpret_mode():
            got, want = _render_both(js, ts)
    finally:
        jax.clear_caches()
    assert calls == {"jax": 2, "port": 2}    # the global and the caustic map
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-5)
    assert abs(got.sum() - want.sum()) <= 1e-4 * abs(want.sum())
