"""Parity of the port's pixel debug visualizers (image/debug_viz.py) with the
JAX package on the CPU: the full-image passes within 1e-6, and the
host-side drawer's pixels on Cornell's camera at 32x32, fed the same AOV
buffers."""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.image import debug_viz as jdv
from cudatracerlib_tpu.scene.sensors import Camera as JCamera
from cudatracerlib_tpu_torch.image import debug_viz as tdv
from cudatracerlib_tpu_torch.render.prim_tracer import render_aovs
from cudatracerlib_tpu_torch.scene import sensors
from cudatracerlib_tpu_torch.scene.shapes import cornell_box

SIZE = 32
CORNELL_CAMERA = dict(origin=[0.0, -3.25, 1.0], target=[0.0, 1.0, 1.0], up=[0.0, 0.0, 1.0],
                      fov_deg=39.3077)


def _close(t, j, atol=1e-6):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=atol)


@pytest.fixture(scope="module")
def aovs():
    """Cornell's first-hit AOVs at 32x32 and each pixel's world position
    (the pixel-centre camera ray at the hit's depth), as numpy."""
    scene = cornell_box(device="cpu")
    out = render_aovs(scene, SIZE, SIZE)
    pid = torch.arange(SIZE * SIZE)
    uv = torch.stack([(pid % SIZE + 0.5) / SIZE, (pid // SIZE + 0.5) / SIZE], -1).float()
    o, d, _ = sensors.sample_ray(scene.camera, uv, torch.zeros(SIZE * SIZE, 2))
    depth = out["depth"].reshape(-1)
    points = (o + d * depth[:, None]).reshape(SIZE, SIZE, 3)
    return {"depth": out["depth"].numpy(), "normal": (out["normal_sh"] * 2.0 - 1.0).numpy(),
            "uv": out["uv"][..., :2].numpy(), "albedo": out["albedo"].numpy(),
            "points": points.numpy(), "valid": (depth > 0).reshape(SIZE, SIZE).numpy()}


def _buf(shape, seed, lo=-2.0, hi=3.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


@pytest.mark.parametrize("source", ["aov", "random"])
@pytest.mark.parametrize("normalize", [True, False])
def test_visualize_scalar(aovs, source, normalize):
    b = aovs["depth"] if source == "aov" else _buf((SIZE, SIZE), 1)
    _close(tdv.visualize_scalar(torch.from_numpy(b), normalize, scale=0.7),
           jdv.visualize_scalar(jnp.asarray(b), normalize, scale=0.7))


@pytest.mark.parametrize("source", ["aov", "random"])
@pytest.mark.parametrize("normalize", [True, False])
def test_visualize_vec2(aovs, source, normalize):
    b = aovs["uv"] if source == "aov" else _buf((SIZE, SIZE, 2), 2)
    _close(tdv.visualize_vec2(torch.from_numpy(b), normalize),
           jdv.visualize_vec2(jnp.asarray(b), normalize))


@pytest.mark.parametrize("source", ["aov", "random"])
@pytest.mark.parametrize("normalize", [True, False])
def test_visualize_vec3(aovs, source, normalize):
    b = aovs["normal"] if source == "aov" else _buf((SIZE, SIZE, 3), 3)
    _close(tdv.visualize_vec3(torch.from_numpy(b), normalize),
           jdv.visualize_vec3(jnp.asarray(b), normalize))


def test_colorize():
    t = np.concatenate([np.linspace(-0.5, 1.5, 401), [0.25, 0.5, 0.75]]).astype(np.float32)
    _close(tdv.colorize(torch.from_numpy(t)), jdv.colorize(jnp.asarray(t)))


@pytest.mark.parametrize("masked", [False, True])
def test_overlay(aovs, masked):
    base, aux = aovs["albedo"], _buf((SIZE, SIZE, 3), 4, 0.0, 1.0)
    mask = aovs["valid"] if masked else None
    _close(tdv.overlay(torch.from_numpy(base), torch.from_numpy(aux), 0.3,
                       None if mask is None else torch.from_numpy(mask)),
           jdv.overlay(jnp.asarray(base), jnp.asarray(aux), 0.3, mask))


# ---------------------------------------------------------------------------
# the host-side drawer
# ---------------------------------------------------------------------------

def _drawers(aovs):
    t_img, j_img = (aovs["albedo"].copy() for _ in range(2))
    t_cam = sensors.Camera.look_at(**CORNELL_CAMERA)
    j_cam = JCamera.look_at(**CORNELL_CAMERA)
    return (tdv.DebugDrawer(t_img, tdv.camera_projector(t_cam)),
            jdv.DebugDrawer(j_img, jdv.camera_projector(j_cam)))


_SHAPES = {
    "line": lambda d: d.draw_line([-0.8, 1.8, 0.1], [0.7, 0.3, 1.9], (0.0, 1.0, 0.0)),
    "line_half_outside": lambda d: d.draw_line([0.0, 1.0, 1.0], [3.0, 1.0, 1.0]),
    "ellipse": lambda d: d.draw_ellipse([0.0, 1.0, 1.0], [1.0, 0.0, 0.0], [0.0, 0.6, 0.8],
                                        0.5, 0.3),
    "ellipsoid": lambda d: d.draw_ellipsoid([0.3, 1.2, 0.6], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                                            [0.0, 0.0, 1.0], 0.3, 0.2, 0.4, (0.2, 0.2, 1.0)),
    "cone": lambda d: d.draw_cone([-0.4, 1.0, 0.2], [0.3, 0.2, 1.0], 0.6, 0.9),
}


@pytest.mark.parametrize("shape", sorted(_SHAPES))
def test_drawer_shapes(aovs, shape):
    """The drawn pixel sets are equal: the two projectors' film uv agree to
    float32 rounding, and no sample of these shapes lands on a .5 tie."""
    t_draw, j_draw = _drawers(aovs)
    _SHAPES[shape](t_draw)
    _SHAPES[shape](j_draw)
    assert (t_draw.img != aovs["albedo"]).any()
    assert np.array_equal(t_draw.img, j_draw.img)


def test_projector():
    t_cam = sensors.Camera.look_at(**CORNELL_CAMERA)
    j_proj = jdv.camera_projector(JCamera.look_at(**CORNELL_CAMERA))
    t_proj = tdv.camera_projector(t_cam)
    for p in np.random.default_rng(5).uniform([-1.5, -0.5, -0.5], [1.5, 2.5, 2.5], (20, 3)):
        (tuv, tok), (juv, jok) = t_proj(p), j_proj(p)
        assert tok == jok and tuv.dtype == np.float64
        np.testing.assert_allclose(tuv, juv, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stride", [4, 8])
def test_draw_vector_field(aovs, stride):
    """`draw_vector_field` over Cornell's hit points and shading normals:
    the drawn pixel sets are equal."""
    t_cam = sensors.Camera.look_at(**CORNELL_CAMERA)
    j_cam = JCamera.look_at(**CORNELL_CAMERA)
    args = (aovs["points"], aovs["normal"], aovs["valid"])
    t_img = tdv.draw_vector_field(torch.from_numpy(aovs["albedo"]), t_cam,
                                  *(torch.from_numpy(a) for a in args), stride=stride, scale=0.3)
    j_img = jdv.draw_vector_field(aovs["albedo"], j_cam, *args, stride=stride, scale=0.3)
    assert isinstance(t_img, np.ndarray) and t_img.dtype == np.float32
    assert (t_img != aovs["albedo"]).any()
    assert np.array_equal(t_img, j_img)
