"""Material maps and the alpha test: the port's `apply_material_maps` and
`alpha_test` against the JAX package's on the same interactions, JAX's
three TestMaterialMaps renders (tests/test_components.py) per pixel, and
the maps case of tools/texture_cases.py (an IMAGE albedo filtered by the
ray cone, a height map with parallax and an alpha-tested quad) through both
engines.

Tolerances:
  * maps on the same interactions: uv within 1e-6, the frame within 1e-4
    (the height map's bump divides a texel difference by 1/256, which turns
    a lookup's last-bit difference into ~2e-5 of a normal); the alpha test's
    keep mask equal on all but 1 lane in 10,000 (a luminance within an ulp
    of its reference; none occurred);
  * renders: at least 99% of pixels within 1e-3 relative (+1e-6) on every
    channel, the image means within 0.5% (a bounced direction from a
    bump-mapped normal ~1e-5 apart may take the other side of an edge), as
    tests/test_torch_render.py holds the Cornell box.
"""
import os
import sys

import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_components as jcomponents
from cudatracerlib_tpu.render import path_tracer as jpt
from cudatracerlib_tpu.render import wavefront as jwf
from cudatracerlib_tpu.scene import scene as jsc
from cudatracerlib_tpu.scene import textures as jtex
from cudatracerlib_tpu.scene.scene import Materials, build_scene
from cudatracerlib_tpu.scene.sensors import Camera
from cudatracerlib_tpu_torch.convert import flatten, scene_from_numpy
from cudatracerlib_tpu_torch.render import path_tracer as tpt
from cudatracerlib_tpu_torch.render import wavefront as twf
from cudatracerlib_tpu_torch.scene import scene as tsc

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import texture_cases  # noqa: E402

FLIP_FRAC = 1e-4


def _quad(**kw):
    """JAX's TestMaterialMaps quad scene and the port's from its arrays."""
    js = jcomponents.TestMaterialMaps._quad_scene(None, **kw)
    return js, scene_from_numpy(flatten(js), device="cpu")


def _assert_images_close(port, ref, frac=0.99, rel=1e-3):
    port, ref = port.numpy(), np.asarray(ref)
    assert port.shape == ref.shape and np.isfinite(port).all()
    ok = (np.abs(port - ref) <= rel * np.abs(ref) + 1e-6).all(-1)
    assert ok.mean() >= frac, f"only {ok.mean():.4f} of pixels within {rel}"
    assert abs(port.mean() - ref.mean()) <= 5e-3 * abs(ref.mean())


@pytest.fixture(scope="module")
def maps_scenes():
    from cudatracerlib_tpu.scene.textures import Textures

    js = texture_cases.build(texture_cases.maps_case(), build_scene, Materials, Textures, Camera)
    return js, scene_from_numpy(flatten(js), device="cpu")


def test_maps_case_inputs(maps_scenes):
    """The port's build of the maps case equals the JAX package's array for
    array, and its specialization turns on what the case exercises."""
    js, _ = maps_scenes
    ts = texture_cases.build(texture_cases.maps_case(), tsc.build_scene, tsc.Materials,
                             tsc.Textures, tsc.Camera, device="cpu")
    a, b = flatten(js), flatten(ts)
    assert set(a) == set(b)
    for k in a:
        bits = lambda x: x.view(np.int32) if x.dtype == np.float32 else x  # noqa: E731
        np.testing.assert_array_equal(bits(a[k]), bits(b[k]), err_msg=k)
    spec = tpt.specialize_config(ts, tpt.PTConfig())
    assert spec.tex_types == (jtex.CONSTANT, jtex.IMAGE) and ts.textures.atlas.shape[0] == 3
    assert spec.height_maps and spec.parallax and spec.alpha_test and not spec.normal_maps


@pytest.mark.parametrize("case", ["maps", "normal", "height"])
def test_maps_and_alpha_on_the_same_interactions(maps_scenes, case):
    """apply_material_maps (parallax march, height bump, normal map, frame
    re-orthogonalisation) and alpha_test on the first hits of 4,096 camera
    rays, from each package's own interaction of the same hits."""
    if case == "maps":
        js, ts = maps_scenes
    elif case == "normal":
        js, ts = _quad(mat_extra={"tex_normal": 1},
                       tex_records=[{"type": 0}, {"type": 2, "image_id": 0}],
                       images=[np.random.default_rng(4).uniform(0, 1, (32, 32, 3))])
    else:
        js, ts = _quad(mat_extra={"tex_height": 1, "parallax": 1, "height_scale": 0.1,
                                  "alpha_mode": 3, "tex_alpha": 1, "alpha_ref": 0.3,
                                  "alpha_ref_color": [0.5, 0.5, 0.5]},
                       tex_records=[{"type": 0}, {"type": 2, "image_id": 0}],
                       images=[np.random.default_rng(5).uniform(0, 1, (16, 16))])
    o, d, _, _ = tpt.camera_rays(ts, 64, 64, 1, 3)
    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    jh, th = jsc.scene_intersect(js, jo, jd), tsc.scene_intersect(ts, o, d)
    np.testing.assert_array_equal(th.prim.numpy(), np.asarray(jh.prim))
    jit, tit = jsc.make_interaction(js, jo, jd, jh), tsc.make_interaction(ts, o, d, th)
    spec = tpt.specialize_config(ts, tpt.PTConfig())
    jm = jsc.apply_material_maps(js, jit, -jd, spec.tex_types)
    tm = tsc.apply_material_maps(ts, tit, -d, spec.tex_types)
    valid = th.valid.numpy()
    assert valid.mean() > 0.3
    np.testing.assert_allclose(tm.uv.numpy()[valid], np.asarray(jm.uv)[valid], atol=1e-6)
    for f in ("s", "t", "n"):
        np.testing.assert_allclose(getattr(tm.frame, f).numpy()[valid],
                                   np.asarray(getattr(jm.frame, f))[valid], atol=1e-4, err_msg=f)
    moved = np.abs(tm.frame.n.numpy() - tit.frame.n.numpy()).max(-1)[valid]
    assert (moved > 1e-3).mean() > 0.1   # the maps bent the normals
    ja = np.asarray(jsc.alpha_test(js, jm, spec.tex_types))
    ta = tsc.alpha_test(ts, tm, spec.tex_types).numpy()
    assert (ja != ta).sum() <= FLIP_FRAC * ja.size
    if case != "normal":
        assert 0.05 < 1.0 - ta[valid].mean() < 0.95, "the alpha test kept or dropped every lane"


@pytest.mark.parametrize("name", ["alpha_test_punches_holes", "normal_map_changes_shading",
                                  "height_map_flat_is_noop"])
def test_test_material_maps_renders(name):
    """JAX's three TestMaterialMaps renders at their sizes (checker alpha
    48x48, 4 spp, depth 2; constant tilted normal and flat height 32x32, 4
    spp, depth 2), pixel for pixel, through `render` and the wavefront
    engine."""
    T = jtex
    kw, size = {
        "alpha_test_punches_holes": (dict(
            mat_extra={"alpha_mode": 1, "tex_alpha": 1, "alpha_ref": 0.5},
            tex_records=[{"type": T.CONSTANT},
                         {"type": T.CHECKERBOARD, "color_a": [1, 1, 1], "color_b": [0, 0, 0],
                          "uv_xform": [4, 4, 0, 0]}]), 48),
        "normal_map_changes_shading": (dict(
            mat_extra={"tex_normal": 1},
            tex_records=[{"type": T.CONSTANT},
                         {"type": T.CONSTANT, "color_a": [0.85, 0.5, 0.85]}]), 32),
        "height_map_flat_is_noop": (dict(
            mat_extra={"tex_height": 1},
            tex_records=[{"type": T.CONSTANT},
                         {"type": T.CONSTANT, "color_a": [0.5, 0.5, 0.5]}]), 32),
    }[name]
    js, ts = _quad(**kw)
    cfg = dict(max_depth=2)
    want = jpt.render(js, size, size, 4, jnp.uint32(0), jpt.PTConfig(**cfg))
    got = tpt.render(ts, size, size, 4, 0, tpt.PTConfig(**cfg))
    _assert_images_close(got, want)
    _assert_images_close(twf.render_wavefront(ts, size, size, 4, 0, tpt.PTConfig(**cfg)),
                         jwf.render_wavefront(js, size, size, 4, 0, jpt.PTConfig(**cfg)))
    if name == "alpha_test_punches_holes":
        lit = (got.numpy().mean(-1) > 1e-4).mean()
        assert 0.15 < lit < 0.6, lit


@pytest.mark.parametrize("engine", ["megakernel", "wavefront"])
def test_maps_case_render(maps_scenes, engine):
    """The maps case at 24x24, 4 spp, depth 4, seed 3: rays equal and the
    image per pixel."""
    js, ts = maps_scenes
    cfg = dict(max_depth=4)
    if engine == "megakernel":
        want, want_rays = jpt.render_counted(js, 24, 24, 4, 3, jpt.PTConfig(**cfg))
        got, rays = tpt.render_counted(ts, 24, 24, 4, 3, tpt.PTConfig(**cfg))
    else:
        want, want_rays = jwf.render_wavefront_counted(js, 24, 24, 4, 3, jpt.PTConfig(**cfg))
        got, rays = twf.render_wavefront_counted(ts, 24, 24, 4, 3, tpt.PTConfig(**cfg))
    assert abs(int(rays) - float(want_rays)) <= 1e-3 * float(want_rays)
    _assert_images_close(got, want)
    assert float(got.mean()) > 0.02
