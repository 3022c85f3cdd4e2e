"""The pseudo-realtime and AOV tracers: render/realtime.py and
render/prim_tracer.py against the JAX package on the CPU (scenes built by
JAX and carried across by `convert`).

Tolerances, stated once:
  * `render_fast` (Cornell and the caustic scene, 24x16): image and depth
    within 1e-5 of their largest entries;
  * three frames of `render_game` on Cornell (24x16, GTConfig(radius=0.1,
    max_gather=8) as tests/test_components.py runs it): each frame and each
    field of the PSF state within 1e-5 of its largest entry; and a frame
    rendered from JAX's own state (`convert.psf_from_numpy`) the same;
  * every channel of `render_aovs` on the caustic scene (24x16; its glass
    sphere makes the first_non_delta_* channels walk a delta chain) within
    1e-4 of the channel's largest entry, prim_id equal except on rays
    whose two hits are coincident triangles (equal vertices: the scene's
    leaf rows hold copies, and JAX's CPU BVH walk and the port's CPU sweep
    keep different copies of a tie; 243 of the 384 rays here, counted).
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.render import prim_tracer as jp
from cudatracerlib_tpu.render import realtime as jr
from cudatracerlib_tpu.scene.shapes import caustic_scene as jcaustic
from cudatracerlib_tpu.scene.shapes import cornell_box as jcornell
from cudatracerlib_tpu_torch import convert
from cudatracerlib_tpu_torch.render import prim_tracer as tp
from cudatracerlib_tpu_torch.render import realtime as tr

W, H = 24, 16


def _close(got, ref, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def scenes():
    return {k: (js, convert.scene_from_numpy(convert.flatten(js), device="cpu"))
            for k, js in (("cornell", jcornell()), ("caustic", jcaustic()))}


@pytest.mark.parametrize("name", ["cornell", "caustic"])
def test_render_fast_matches_jax(scenes, name):
    js, ts = scenes[name]
    img, depth = tr.render_fast(ts, W, H, 2)
    img_j, depth_j = jr.render_fast(js, W, H, 2)
    _close(img, img_j, 1e-5)
    _close(depth, depth_j, 1e-5)
    assert (depth > 0).float().mean() > 0.7


def test_render_game_frames_and_state_match_jax(scenes):
    js, ts = scenes["cornell"]
    jcfg = jr.GTConfig(radius=0.1, max_gather=8)
    tcfg = tr.GTConfig(radius=0.1, max_gather=8)
    jpsf = tpsf = None
    for f in range(3):
        frame_j, jpsf = jr.render_game(js, jpsf, W, H, f, jcfg)
        frame_t, tpsf = tr.render_game(ts, tpsf, W, H, f, tcfg)
        _close(frame_t, frame_j, 1e-5)
        for field in tr.PSFBuffer._fields:
            _close(getattr(tpsf, field).to(torch.float32),
                   np.asarray(getattr(jpsf, field)).astype(np.float32), 1e-5)
        assert float(frame_t.mean()) > 0.01
    # one more frame from JAX's own cache
    carried = convert.psf_from_numpy(convert.flatten(jpsf), device="cpu")
    frame_j, _ = jr.render_game(js, jpsf, W, H, 3, jcfg)
    frame_t, _ = tr.render_game(ts, carried, W, H, 3, tcfg)
    _close(frame_t, frame_j, 1e-5)


def test_render_aovs_match_jax(scenes):
    js, ts = scenes["caustic"]
    got = tp.render_aovs(ts, W, H, 3)
    ref = {k: np.asarray(v) for k, v in jp.render_aovs(js, W, H, 3).items()}
    assert set(got) == set(ref) and len(got) == 17
    prim_t, prim_j = got["prim_id"].numpy(), ref["prim_id"]
    off = prim_t != prim_j
    verts = ts.shading.verts.numpy()
    np.testing.assert_array_equal(verts[prim_t[off].astype(int)], verts[prim_j[off].astype(int)])
    assert int(off.sum()) == 243
    for k, r in ref.items():
        if k != "prim_id":
            _close(got[k], r, 1e-4)
    # the delta chain reached past the glass on some rays
    assert (got["albedo_non_delta"] != got["albedo"]).any()
