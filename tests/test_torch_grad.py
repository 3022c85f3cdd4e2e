"""Render-gradient parity: the port's autograd through `render` against the
JAX package's `jax.grad` on the CPU, on the scenes of the JAX package's
TestGradients (tests/test_render.py:99-238): the Cornell box (albedo and
light radiance), the white furnace with a ROUGHCONDUCTOR sphere (roughness)
and a wall lit by a point light (camera origin and FOV).

Each scene's gradient is taken once, with respect to every float field of
the scene (JAX: `jax.grad` of the scene pytree; the port: `convert.with_grad`
and `convert.grads`), in a module fixture; the TestGradients cases read
their fields from it. Tolerances, stated once:
  * every field: 1e-3 relative + 1e-4 of the field's largest entry (the two
    packages agree to ~1e-5 relative on these scenes: float32 sums in
    another order; the JAX CPU render intersects the Cornell box by brute
    force with gradients through the select, the port through the refine's
    closed form, which differ only at exact ties);
  * losses: 1e-5 relative;
  * remat on against off: the loss bit-equal, gradients within 1e-4;
  * the port's own central differences against its AD at the JAX tests'
    10% (camera) bounds;
  * inverse_step: the loss 1e-5, gradients 1e-3 relative, except texture
    rows exactly at a clip bound (0 or 1), where `jnp.clip` gives half the
    gradient (a tie splits 0.5 / 0.5) and `torch.clamp` all of it.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.render import path_tracer as jpt
from cudatracerlib_tpu.scene import bsdf as JB
from cudatracerlib_tpu.scene import lights as JL
from cudatracerlib_tpu.scene.scene import Materials, build_scene
from cudatracerlib_tpu.scene.sensors import Camera
from cudatracerlib_tpu.scene.shapes import cornell_box as jcornell
from cudatracerlib_tpu.scene.shapes import furnace_scene as jfurnace
from cudatracerlib_tpu.scene.shapes import glossy_scene as jglossy
from cudatracerlib_tpu.scene.shapes import quad
from cudatracerlib_tpu.scene.textures import Textures
from cudatracerlib_tpu_torch import entry as tentry
from cudatracerlib_tpu_torch.convert import flatten, grads, scene_from_numpy, set_field, with_grad
from cudatracerlib_tpu_torch.render import path_tracer as tpt

RTOL, FIELD_FRAC = 1e-3, 1e-4


def _wall():
    """TestGradients' camera scene: one wall filling the frame, a point
    light, no silhouettes (tests/test_render.py:163-173)."""
    wall = quad([-50, 5, -50], [50, 5, -50], [50, 5, 50], [-50, 5, 50])
    return build_scene(
        wall, None, None, np.zeros(len(wall), np.int32),
        Materials.build([{"bsdf_type": JB.DIFFUSE, "tex_albedo": 0}]),
        Textures.build([{"type": 0, "color_a": [0.7, 0.6, 0.5]}]),
        [{"type": JL.POINT, "position": [0, 1.0, 0.5], "radiance": [30.0] * 3}],
        Camera.look_at([0, 0, 0], [0, 5, 0], up=[0, 0, 1], fov_deg=40.0))


# name: (scene factory, width, height, spp, max_depth), as TestGradients runs them
SCENES = {
    "cornell": (jcornell, 32, 32, 8, 4),
    "furnace": (lambda: jfurnace(albedo=0.8, bsdf_type=JB.ROUGHCONDUCTOR, alpha_u=0.3,
                                 alpha_v=0.3), 24, 24, 8, 3),
    "wall": (_wall, 24, 24, 8, 2),
}


def _both(name, remat=False):
    """(JAX loss, JAX {field: grad}, port scene with grads, port loss, port
    {field: grad}) of mean(render) at seed 0, rr_start 99."""
    make, w, h, spp, depth = SCENES[name]
    js = make()
    jcfg = jpt.specialize_config(js, jpt.PTConfig(max_depth=depth, rr_start=99))
    jl, jg = jax.value_and_grad(lambda s: jnp.mean(jpt.render(s, w, h, spp, 0, jcfg)),
                                allow_int=True)(js)
    ts = with_grad(scene_from_numpy(flatten(js), device="cpu"))
    tcfg = tpt.PTConfig(max_depth=depth, rr_start=99, remat=remat)
    tl = tpt.render(ts, w, h, spp, 0, tcfg).mean()
    tl.backward()
    return float(jl), flatten(jg), ts, float(tl.detach()), grads(ts)


@pytest.fixture(scope="module")
def cornell():
    return _both("cornell")


@pytest.fixture(scope="module")
def furnace():
    return _both("furnace")


@pytest.fixture(scope="module")
def wall():
    return _both("wall")


def _close(got, ref, rtol=RTOL, frac=FIELD_FRAC, err_msg=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all(), err_msg
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=frac * np.abs(ref).max(),
                               err_msg=err_msg)


@pytest.mark.parametrize("name", list(SCENES))
def test_render_grad_every_field(name, request):
    """Every float field of the scene, JAX's gradient against the port's:
    the Woop rows, shading, materials, textures, lights and camera."""
    jl, jg, _, tl, tg = request.getfixturevalue(name)
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    assert sum(np.abs(g).max() > 0 for g in tg.values()) >= 4
    for k, g in tg.items():
        _close(g, np.asarray(jg[k], np.float32), err_msg=k)


def _case(case, request):
    """(port, JAX) gradient of one TestGradients case, from the fixtures."""
    fixture, read = {
        "albedo": ("cornell", lambda g, s: g["textures.color_a"]),
        "light_radiance": ("cornell", lambda g, s: g["lights.radiance"]),
        # alpha_u and alpha_v set to one value a: d/da is the sum
        "roughness": ("furnace", lambda g, s: g["materials.alpha_u"] + g["materials.alpha_v"]),
        # the dolly adds dy to to_world[1, 3]
        "camera_origin": ("wall", lambda g, s: g["camera.to_world"][1, 3]),
        # tan_half_fov * s at s = 1: d/ds = tan_half_fov * its gradient
        "camera_fov": ("wall", lambda g, s: g["camera.tan_half_fov"] * s),
    }[case]
    _, jg, ts, _, tg = request.getfixturevalue(fixture)
    fov = float(ts.camera.tan_half_fov.detach())
    jg = {k: v for k, v in jg.items() if np.issubdtype(v.dtype, np.floating)}
    return read(tg, fov), read(jg, fov)


@pytest.mark.parametrize("case", ["albedo", "light_radiance", "roughness", "camera_origin",
                                  "camera_fov"])
def test_testgradients_case(case, request):
    got, ref = _case(case, request)
    assert np.all(np.abs(ref) > 0) if np.ndim(ref) == 0 else np.abs(ref).max() > 0
    _close(got, ref)


def _fd(ts, make_scene, x0, h, w, hh, spp, depth):
    cfg = tpt.PTConfig(max_depth=depth, rr_start=99)
    with torch.no_grad():
        up = tpt.render(make_scene(ts, x0 + h), w, hh, spp, 0, cfg).mean()
        dn = tpt.render(make_scene(ts, x0 - h), w, hh, spp, 0, cfg).mean()
    return float(up - dn) / (2 * h)


@pytest.mark.parametrize("case", ["camera_origin", "camera_fov"])
def test_camera_fd_matches_ad(case, wall, request):
    """The port's central differences against its AD, as the JAX tests hold
    JAX's (10%, h = 1e-2)."""
    _, _, ts, _, _ = wall
    ts = scene_from_numpy(flatten(ts), device="cpu")    # the same arrays, no grads
    if case == "camera_origin":
        def make(s, dy):
            m = s.camera.to_world.clone()
            m[1, 3] += dy
            return set_field(s, "camera.to_world", m)
    else:
        def make(s, k):
            return set_field(s, "camera.tan_half_fov", s.camera.tan_half_fov * k)
    x0 = 0.0 if case == "camera_origin" else 1.0
    fd = _fd(ts, make, x0, 1e-2, 24, 24, 8, 2)
    ad, _ = _case(case, request)
    assert abs(fd - ad) < 0.1 * max(abs(fd), 1e-4) + 1e-4, (fd, ad)


def test_remat_gradients_match(cornell):
    """PTConfig.remat recomputes each bounce in the backward: the loss is
    bit-equal and the gradients agree with the non-remat port's and JAX's."""
    jl, jg, _, tl, tg = cornell
    _, _, _, tl_r, tg_r = _both("cornell", remat=True)
    assert tl_r == tl
    for k, g in tg.items():
        _close(tg_r[k], g, rtol=1e-4, frac=1e-6, err_msg=k)
        _close(tg_r[k], np.asarray(jg[k], np.float32), err_msg=k)


@pytest.mark.slow
def test_render_grad_every_field_glossy():
    """The glossy scene (6,624 rows, four BSDF families, the checkerboard,
    the environment map) at 16x16, 2 spp, depth 3: every field. The JAX
    CPU compile of this gradient takes minutes."""
    js = jglossy()
    jcfg = jpt.specialize_config(js, jpt.PTConfig(max_depth=3, rr_start=99))
    jl, jg = jax.value_and_grad(lambda s: jnp.mean(jpt.render(s, 16, 16, 2, 0, jcfg)),
                                allow_int=True)(js)
    ts = with_grad(scene_from_numpy(flatten(js), device="cpu"))
    tl = tpt.render(ts, 16, 16, 2, 0, tpt.PTConfig(max_depth=3, rr_start=99)).mean()
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    jf = flatten(jg)
    for k, g in grads(ts).items():
        _close(g, np.asarray(jf[k], np.float32), err_msg=k)


def test_entry_renders_the_port_render():
    fn, (scene, seed) = tentry.entry(device="cpu")
    img = fn(scene, seed)
    assert tuple(img.shape) == (64, 64, 3) and not img.requires_grad
    ref = tpt.render(scene, 64, 64, 2, 0, tpt.PTConfig(max_depth=5))
    assert torch.equal(img, ref)


def test_inverse_step_matches_jax():
    """One step of the inverse-rendering example at 16x16, 2 spp, depth 3,
    against JAX's value_and_grad of the example's loss; then three steps
    from the grey start lower the loss."""
    W = H = 16
    jcfg = jpt.PTConfig(max_depth=3, rr_start=99)
    target = jpt.render(jcornell(), W, H, 2, 0, jcfg)
    jstart = jcornell(light_radiance=(5.0, 5.0, 5.0), white=(0.5, 0.5, 0.5),
                      red=(0.5, 0.5, 0.5), green=(0.5, 0.5, 0.5))

    def jloss(params, seed):
        ca, rad = params
        s = jstart._replace(textures=jstart.textures._replace(color_a=jnp.clip(ca, 0.0, 1.0)),
                            lights=jstart.lights._replace(radiance=jnp.abs(rad)))
        return jnp.mean((jpt.render(s, W, H, 2, seed, jcfg) - target) ** 2)

    p0 = (jstart.textures.color_a, jstart.lights.radiance)
    jl, (jg_ca, jg_rad) = jax.value_and_grad(jloss)(p0, jnp.uint32(1))

    start = tentry.grey_start(device="cpu")
    tp = (start.textures.color_a, start.lights.radiance)
    np.testing.assert_array_equal(tp[0].numpy(), np.asarray(p0[0]))
    tcfg = tpt.PTConfig(max_depth=3, rr_start=99)
    step = tentry.inverse_step(start, tp, torch.from_numpy(np.array(target)), 1, W, H, 2, tcfg)
    assert abs(float(step.loss) - float(jl)) <= 1e-5 * float(jl)
    g_ca, g_rad = (g.numpy() for g in step.grads)
    _close(g_rad, jg_rad)
    ca0 = tp[0].numpy()
    at_bound = ((ca0 == 0.0) | (ca0 == 1.0)).all(-1)        # the light's black, the white
    assert at_bound.any() and not at_bound[:3].any()
    _close(g_ca[~at_bound], np.asarray(jg_ca)[~at_bound])
    _close(g_ca[at_bound], 2.0 * np.asarray(jg_ca)[at_bound])
    np.testing.assert_allclose(step.params[0].numpy(), ca0 - 0.4 * g_ca, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(step.params[1].numpy(), tp[1].numpy() - 4.0 * g_rad, rtol=1e-6)

    # three steps (seeds 1, 2, 3); the loss read at seed 1 before and after
    # (so the two readings share their samples; at 16x16, 2 spp one seed's
    # noise is larger than a step's gain)
    params, t_np = tp, torch.from_numpy(np.array(target))
    for k in range(3):
        params = tentry.inverse_step(start, params, t_np, k + 1, W, H, 2, tcfg).params
    with torch.no_grad():
        before = tentry.inverse_loss(start, tp, t_np, W, H, 2, 1, tcfg)
        after = tentry.inverse_loss(start, params, t_np, W, H, 2, 1, tcfg)
    assert float(before) == float(step.loss)
    assert float(after) < float(before), (float(before), float(after))
