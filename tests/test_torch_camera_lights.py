"""The spot and distant lights, the emitted rays of every light type, the
five camera models and what renders through them, against the JAX package
on the CPU: lane by lane, per pixel on the Cornell box, the light tracer,
BDPT and VCM on a point- and spot-lit Cornell box and on the constant-
environment furnace, and `jax.grad` of a spot light's radiance. Also: a
JAX scene that uses every field these types read converts to the port
array for array, and every engine accepts a scene of every BSDF tag and
light type.

Tolerances:
  * lights lane by lane: positions, directions, distances and pdfs within
    1e-5 relative plus 1e-5 of their scale, radiance and power weights
    within 1e-5 relative plus 1e-5 of their scale (the same float32
    operations; the frames and sums in another order), measures equal;
  * camera rays within 1e-5 relative plus 1e-6 (JAX's transform is an
    einsum, the port's explicit float32 sums), `pixel_spread` equal;
  * path-traced images (16x16, 2 spp, depth 4, seed 3): 99% of pixels
    within 1e-3 relative on every channel and the means within 1e-4
    relative;
  * the bidirectional engines (16x16, 2 spp or 512 light paths, seed 3):
    every pixel within 1e-3 relative plus 1e-6, as tests/test_torch_bdpt.py
    holds them;
  * the spot light's radiance gradient: 1e-3 relative plus 1e-4 of the
    largest entry, as tests/test_torch_grad.py.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.render import bdpt as jbdpt
from cudatracerlib_tpu.render import light_tracer as jlt
from cudatracerlib_tpu.render import path_tracer as jpt
from cudatracerlib_tpu.render import vcm as jvcm
from cudatracerlib_tpu.scene import lights as jlights
from cudatracerlib_tpu.scene import sensors as jsensors
from cudatracerlib_tpu.scene.scene import Materials as JMaterials
from cudatracerlib_tpu.scene.scene import build_scene as jbuild
from cudatracerlib_tpu.scene.shapes import _sky_envmap as j_sky
from cudatracerlib_tpu.scene.shapes import cornell_box as jcornell
from cudatracerlib_tpu.scene.shapes import furnace_scene as jfurnace
from cudatracerlib_tpu.scene.textures import Textures as JTextures
from cudatracerlib_tpu_torch.convert import flatten, grads, scene_from_numpy, with_grad
from cudatracerlib_tpu_torch.render import bdpt as tbdpt
from cudatracerlib_tpu_torch.render import light_tracer as tlt
from cudatracerlib_tpu_torch.render import path_tracer as tpt
from cudatracerlib_tpu_torch.render import ppm as tppm
from cudatracerlib_tpu_torch.render import sppm as tsppm
from cudatracerlib_tpu_torch.render import vcm as tvcm
from cudatracerlib_tpu_torch.render import wavefront as twf
from cudatracerlib_tpu_torch.scene import bsdf as tbsdf
from cudatracerlib_tpu_torch.scene import lights as tlights
from cudatracerlib_tpu_torch.scene import sensors as tsensors
from cudatracerlib_tpu_torch.scene import shapes as tshapes
from cudatracerlib_tpu_torch.scene.scene import Materials as TMaterials
from cudatracerlib_tpu_torch.scene.scene import build_scene as tbuild
from cudatracerlib_tpu_torch.scene.textures import Textures as TTextures

N = 4096
W = H = 16
SPP, SEED, DEPTH = 2, 3, 4
L = tlights
QUAD = np.array([[[-1, -1, 3], [1, -1, 3], [1, 1, 3]], [[-1, -1, 3], [1, 1, 3], [-1, 1, 3]]],
                np.float32)
# one record of each light type, in tag order
RECORDS = [
    {"type": L.POINT, "position": [0.3, -0.2, 1.5], "radiance": [30.0, 20.0, 10.0]},
    {"type": L.SPOT, "position": [-0.4, 0.5, 2.5], "direction": [0.2, -0.1, -1.0],
     "radiance": [40.0, 30.0, 20.0], "cos_width": float(np.cos(np.radians(35.0))),
     "cos_falloff": float(np.cos(np.radians(20.0)))},
    {"type": L.DISTANT, "direction": [0.3, 0.4, -0.8], "radiance": [2.0, 1.5, 1.0]},
    {"type": L.AREA_LIGHT, "radiance": [5.0, 4.0, 3.0], "tris": QUAD},
    {"type": L.INFINITE, "radiance": [1.0, 1.0, 1.0]},
    {"type": L.CONSTANT_ENV, "radiance": [0.5, 0.6, 0.7]},
]
LIGHT_IDS = ["point", "spot", "distant", "area", "infinite", "constant_env"]
CAMERAS = tshapes.CORNELL_CAMERAS   # the Cornell box seen by each other model


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(t, j, rtol=1e-5, frac=1e-5, err_msg=""):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=rtol,
                               atol=frac * max(float(np.abs(j).max()), 1.0), err_msg=err_msg)


def _lights(records):
    env = j_sky(res_y=16)
    return (jlights.build_lights(records, [0, 0, 0.5], 8.0, env),
            tlights.build_lights(records, [0, 0, 0.5], 8.0, env))


def _lane_inputs(seed, n_lights):
    rng = np.random.default_rng(seed)
    return (rng.random((N, 2), dtype=np.float32), rng.random((N, 2), dtype=np.float32),
            rng.uniform(-2, 2, (N, 3)).astype(np.float32),
            rng.integers(0, n_lights, N).astype(np.int32))


def _direct(records, seed):
    jl, tl = _lights(records)
    u2, _, ref_p, lid = _lane_inputs(seed, len(records))
    active = tuple(sorted({r["type"] for r in records}))
    jds, jrad = jlights.sample_direct(jl, jnp.asarray(lid), jnp.asarray(ref_p), jnp.asarray(u2),
                                      active=active)
    tds, trad = tlights.sample_direct(tl, _t(lid).long(), _t(ref_p), _t(u2), active=active)
    for f in ("p", "n", "d", "dist", "pdf"):
        _close(getattr(tds, f), getattr(jds, f), err_msg=f)
    _close(trad, jrad, err_msg="radiance")
    np.testing.assert_array_equal(tds.measure.numpy(), np.asarray(jds.measure))
    return tds, trad, lid


@pytest.mark.parametrize("which", ["spot", "distant"])
def test_spot_and_distant_direct(which):
    """Alone: the delta measure (DISCRETE, pdf 1), the spot's falloff (0
    outside its cone, 1 inside the inner one), the distant light's fixed
    direction at twice the scene's radius."""
    rec = RECORDS[1] if which == "spot" else RECORDS[2]
    tds, trad, _ = _direct([rec], 1)
    assert (tds.measure.numpy() == 2).all() and (tds.pdf.numpy() == 1).all()
    if which == "spot":
        lit = (trad.numpy() > 0).all(-1)
        assert 0.02 < lit.mean() < 0.9
    else:
        assert np.allclose(tds.d.numpy(), -np.asarray(RECORDS[2]["direction"])
                           / np.linalg.norm(RECORDS[2]["direction"]), atol=1e-6)
        np.testing.assert_allclose(tds.dist.numpy(), 16.0, rtol=1e-6)


def test_all_six_direct_mixed():
    """Every light type at once, one per lane."""
    _, _, lid = _direct(RECORDS, 2)
    assert len(np.unique(lid)) == 6


@pytest.mark.parametrize("ltype", range(6), ids=LIGHT_IDS)
def test_sample_emitter_ray_each_type(ltype):
    rec = RECORDS[ltype]
    jl, tl = _lights([rec])
    u_pos, u_dir, _, _ = _lane_inputs(10 + ltype, 1)
    want = jlights.sample_emitter_ray(jl, jnp.int32(0), jnp.asarray(u_pos), jnp.asarray(u_dir))
    got = tlights.sample_emitter_ray(tl, 0, _t(u_pos), _t(u_dir), active=(ltype,))
    for name, a, b in zip(("o", "d", "w"), got, want):
        assert tuple(a.shape) == (N, 3), name
        _close(a, b, err_msg=name)
    assert float(got[2].sum()) > 0


def test_sample_emitter_ray_mixed():
    jl, tl = _lights(RECORDS)
    u_pos, u_dir, _, lid = _lane_inputs(20, 6)
    want = jlights.sample_emitter_ray(jl, jnp.asarray(lid), jnp.asarray(u_pos), jnp.asarray(u_dir))
    got = tlights.sample_emitter_ray(tl, _t(lid).long(), _t(u_pos), _t(u_dir),
                                     active=tuple(range(6)))
    for name, a, b in zip(("o", "d", "w"), got, want):
        _close(a, b, err_msg=name)


def _cameras(ctype, **kw):
    args = dict(origin=[0.0, -3.25, 1.0], target=[0.0, 1.0, 1.0], up=[0.0, 0.0, 1.0],
                fov_deg=39.3077, aspect=1.25, ctype=ctype)
    args.update(kw)
    if ctype == tsensors.SPHERICAL:
        args["target"] = [0.0, 2.0, 1.0]
    return jsensors.Camera.look_at(**args), tsensors.Camera.look_at(**args)


@pytest.mark.parametrize("ctype", range(5),
                         ids=["perspective", "thinlens", "orthographic", "spherical", "telecentric"])
def test_sample_ray_and_pixel_spread(ctype):
    kw = dict(aperture_radius=0.1, focal_distance=3.0, ortho_scale=1.3)
    jcam, tcam = _cameras(ctype, **kw)
    rng = np.random.default_rng(30 + ctype)
    uv = rng.random((N, 2), dtype=np.float32)
    u_ap = rng.random((N, 2), dtype=np.float32)
    want = jsensors.sample_ray(jcam, jnp.asarray(uv), jnp.asarray(u_ap))
    got = tsensors.sample_ray(tcam, _t(uv), _t(u_ap))
    for name, a, b in zip(("o", "d", "w"), got, want):
        _close(a, b, rtol=1e-5, frac=1e-6, err_msg=name)
    if ctype in (tsensors.THINLENS, tsensors.TELECENTRIC):   # the lens moves the origins
        assert float(got[0].std(0).max()) > 0.01
    for a, b in zip(tsensors.pixel_spread(tcam, 64, 48), jsensors.pixel_spread(jcam, 64, 48)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))


def _assert_images_close(got, want, frac=0.99, rel=1e-3):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    ok = (np.abs(got - want) <= rel * np.abs(want) + 1e-6).all(-1)
    assert ok.mean() >= frac, f"only {ok.mean():.4f} of pixels within {rel}"
    assert abs(got.mean() - want.mean()) <= 1e-4 * abs(want.mean())
    assert want.mean() > 1e-3


def _cornell_with_camera(name):
    return jcornell()._replace(camera=jsensors.Camera.look_at(**CAMERAS[name]))


@pytest.mark.parametrize("name", list(CAMERAS))
def test_cornell_camera_render_matches_jax(name):
    js = _cornell_with_camera(name)
    want = jpt.render(js, W, H, SPP, SEED, jpt.PTConfig(max_depth=DEPTH))
    got = tpt.render(scene_from_numpy(flatten(js), device="cpu"), W, H, SPP, SEED,
                     tpt.PTConfig(max_depth=DEPTH))
    _assert_images_close(got, want)


def _jax_point_spot():
    inp = tshapes.cornell_point_spot_inputs()
    return jbuild(inp["vertices"], None, None, inp["mat_id"], JMaterials.build(inp["materials"]),
                  JTextures.build(inp["textures"]), inp["lights"],
                  jsensors.Camera.look_at(**inp["camera"]))


@pytest.fixture(scope="module")
def point_spot():
    js = _jax_point_spot()
    ts = tshapes.cornell_point_spot(device="cpu")
    a, b = flatten(js), flatten(ts)
    for k in sorted(b):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    return js, ts


def test_point_spot_cornell_path_traced(point_spot):
    js, ts = point_spot
    assert tpt.specialize_config(ts, tpt.PTConfig()).light_types == (L.POINT, L.SPOT)
    want = jpt.render(js, W, H, SPP, SEED, jpt.PTConfig(max_depth=DEPTH))
    _assert_images_close(tpt.render(ts, W, H, SPP, SEED, tpt.PTConfig(max_depth=DEPTH)), want)


def _assert_bidir_close(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape == (H, W, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6)
    assert want.mean() > 0.05


BIDIR = {
    "lt": (lambda s: jlt.render_light_trace(s, W, H, 512, SEED),
           lambda s: tlt.render_light_trace(s, W, H, 512, SEED)),
    "bdpt": (lambda s: jbdpt.render_bdpt(s, W, H, SPP, SEED),
             lambda s: tbdpt.render_bdpt(s, W, H, SPP, SEED)),
    "vcm": (lambda s: jvcm.render_vcm(s, W, H, SPP, SEED, 1),
            lambda s: tvcm.render_vcm(s, W, H, SPP, SEED, 1)),
}


@pytest.mark.parametrize("engine", list(BIDIR))
def test_bidirectional_on_point_spot_cornell(point_spot, engine):
    js, ts = point_spot
    jfn, tfn = BIDIR[engine]
    _assert_bidir_close(tfn(ts), jfn(js))


@pytest.mark.parametrize("engine", list(BIDIR))
def test_bidirectional_on_constant_env_furnace(engine):
    jfn, tfn = BIDIR[engine]
    _assert_bidir_close(tfn(tshapes.furnace_scene(device="cpu")), jfn(jfurnace()))


def test_spot_radiance_gradient_matches_jax(point_spot):
    js, _ = point_spot
    cfg = dict(max_depth=3, rr_start=99)
    jcfg = jpt.specialize_config(js, jpt.PTConfig(**cfg))
    jl, jg = jax.value_and_grad(lambda s: jnp.mean(jpt.render(s, W, H, SPP, 0, jcfg)),
                                allow_int=True)(js)
    want = np.asarray(jg.lights.radiance)
    ts = with_grad(scene_from_numpy(flatten(js), device="cpu"), ["lights.radiance"])
    loss = tpt.render(ts, W, H, SPP, 0, tpt.PTConfig(**cfg)).mean()
    loss.backward()
    got = grads(ts)["lights.radiance"]
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    assert np.abs(want[1]).min() > 1e-4    # the spot light's row
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * np.abs(want).max())


def test_scene_from_numpy_carries_every_new_field():
    """A JAX scene whose materials, lights and camera set every field these
    types read (nested_id, blend_weight, exponent, the spot's cone, the
    light's direction, the camera's ctype, aperture, focal distance and
    ortho scale) converts to the port array for array and renders as JAX
    does."""
    inp = tshapes.cornell_point_spot_inputs()
    mats = [dict(m) for m in inp["materials"]] + [
        {"bsdf_type": tbsdf.BLEND, "tex_albedo": 1, "nested_id": 4, "blend_weight": 0.35},
        {"bsdf_type": tbsdf.PHONG, "tex_albedo": 0, "exponent": 12.0}]
    mat_id = inp["mat_id"].copy()
    mat_id[-12:] = 3   # the short block: the blend over phong
    cam = dict(inp["camera"], ctype=tsensors.THINLENS, aperture_radius=0.07,
               focal_distance=3.9, ortho_scale=1.7)
    js = jbuild(inp["vertices"], None, None, mat_id, JMaterials.build(mats),
                JTextures.build(inp["textures"]), inp["lights"], jsensors.Camera.look_at(**cam))
    ts = scene_from_numpy(flatten(js), device="cpu")
    want = flatten(js)
    for k, v in flatten(ts).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert int(ts.materials.nested_id[3]) == 4 and float(ts.materials.exponent[4]) == 12.0
    assert float(ts.lights.spot_cos_width[1]) == np.float32(np.cos(np.radians(30.0)))
    assert int(ts.camera.ctype) == tsensors.THINLENS
    want = jpt.render(js, W, H, SPP, SEED, jpt.PTConfig(max_depth=DEPTH))
    _assert_images_close(tpt.render(ts, W, H, SPP, SEED, tpt.PTConfig(max_depth=DEPTH)), want)


def _kitchen_sink():
    """A scene of every BSDF tag (one a face of the Cornell box's walls and
    blocks, the nested tags over DIFFUSE) lit by one light of every type,
    seen through a thin lens."""
    inp = tshapes.cornell_point_spot_inputs()
    verts = inp["vertices"]
    mat_id = (np.arange(len(verts)) // 2 % 16).astype(np.int32)
    mats = [{"bsdf_type": t, "tex_albedo": t % 3, "nested_id": 0 if t in tbsdf.NESTED else t,
             "alpha_u": 0.2, "alpha_v": 0.3} for t in range(16)]
    recs = [dict(r) for r in RECORDS]
    recs[1] = dict(recs[1], position=[0.5, 0.3, 1.8])
    recs[3] = dict(recs[3], tris=np.asarray(tshapes.quad([-0.25, 0.75, 1.99], [-0.25, 1.25, 1.99],
                                                         [0.25, 1.25, 1.99],
                                                         [0.25, 0.75, 1.99])))
    cam = dict(inp["camera"], ctype=tsensors.THINLENS, aperture_radius=0.05, focal_distance=4.0)
    return tbuild(verts, None, None, mat_id, TMaterials.build(mats),
                  TTextures.build(inp["textures"]), recs, tsensors.Camera.look_at(**cam),
                  env_map=j_sky(res_y=8), device="cpu")


ENGINES = {
    "render": lambda s: tpt.render(s, 8, 8, 1, 0, tpt.PTConfig(max_depth=3, regularization=0.1,
                                                               rec_filter=2)),
    "wavefront": lambda s: twf.render_wavefront_counted(s, 8, 8, 1, 0,
                                                        tpt.PTConfig(max_depth=3))[0],
    "light_tracer": lambda s: tlt.render_light_trace(s, 8, 8, 128, 0),
    "bdpt": lambda s: tbdpt.render_bdpt(s, 8, 8, 1, 0),
    "vcm": lambda s: tvcm.render_vcm(s, 8, 8, 1, 0, 1),
    "ppm": lambda s: tppm.render_ppm_pass(s, 8, 8, 1, 0, 1, tppm.PPMConfig(n_photons=256)),
    "sppm": lambda s: tsppm.render_sppm_pass(s, 8, 8, 0, None,
                                             tsppm.SPPMConfig(n_photons=256))[0],
}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_every_engine_accepts_every_type(engine):
    scene = _kitchen_sink()
    spec = tpt.specialize_config(scene, tpt.PTConfig())
    assert spec.bsdf_types == tuple(range(16)) and spec.light_types == tuple(range(6))
    img = ENGINES[engine](scene)
    assert tuple(img.shape) == (8, 8, 3) and bool(torch.isfinite(img).all())
    assert float(img.sum()) > 0
