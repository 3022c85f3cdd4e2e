"""The volumetric path tracer (bench config 4's slice) in the port against
the JAX package on the CPU: scenes and media built from the JAX package's
arrays (`scene_from_numpy`, `media_from_numpy`), so both compute on the
same tables.

Tolerances, stated once:
  * the camera batch: pixel ids and sampler states exactly equal, rays
    within 1e-6 relative (+1e-7): the same float32 operations;
  * the film: the reshape-sum over spp equals `film.add_samples` +
    `develop` bit for bit (non-finite samples count as 0 in both);
  * renders (Cornell with bench config 4's plume at 16x16, 2 spp, depth 4,
    seed 3; JAX's furnace scattering case and 10-slab aggregate at 12x12,
    4 spp): rays exactly equal, every pixel within 1e-3 relative (+1e-6),
    the image sums within 1e-5 relative (measured: Cornell 1.3e-7, pixels
    within 5.4e-7 absolute). A tracking decision that one ulp flips would
    change every later draw of every lane (scene/media.py); none flips at
    these sizes, and a flip would fail the ray count, not hide in a
    tolerance;
  * `render_vol_stepwise` equals `render_vol_progressive` bit for bit, and
    its ray count is the sum of `render_vol_counted`'s over the passes.
Alone this file takes about 55 s, most of it JAX compiling three renders.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.render import volpath as jvol
from cudatracerlib_tpu.render.path_tracer import PTConfig as JPTConfig
from cudatracerlib_tpu.scene import media as jm
from cudatracerlib_tpu.scene import phase as jph
from cudatracerlib_tpu.scene.shapes import cornell_box as jcornell
from cudatracerlib_tpu.scene.shapes import furnace_scene as jfurnace
from cudatracerlib_tpu_torch.convert import flatten, media_from_numpy, scene_from_numpy
from cudatracerlib_tpu_torch.image import film as tfilm
from cudatracerlib_tpu_torch.render import path_tracer as tpt
from cudatracerlib_tpu_torch.render import volpath as tvol
from cudatracerlib_tpu_torch.scene import media as tm


def _pair(jscene, records):
    jmed = jm.Media.build(records)
    return ((jscene, jmed),
            (scene_from_numpy(flatten(jscene), device="cpu"),
             media_from_numpy(flatten(jmed), device="cpu")))


@pytest.fixture(scope="module")
def cornell_plume():
    js = jcornell()
    return _pair(js, tm.plume_records(np.asarray(js.bvh.world_min),
                                      np.asarray(js.bvh.world_max)))


def _furnace_scatter():
    """tests/test_engines.py:119: a pure scatterer in a white furnace."""
    return _pair(jfurnace(albedo=1.0), [
        {"type": jm.HOMOGENEOUS, "sigma_a": [0.0] * 3, "sigma_s": [0.4] * 3,
         "phase_type": jph.ISOTROPIC, "box_min": [-2, -2, -2], "box_max": [2, 2, 2]}])


def _ten_slabs():
    """tests/test_engines.py:240: ten thin absorbing slabs with gaps."""
    return _pair(jfurnace(albedo=0.7), [
        {"type": jm.HOMOGENEOUS, "sigma_a": [0.5] * 3, "sigma_s": [0.0] * 3,
         "box_min": [-2, -2.9 + i * 0.14, -2], "box_max": [2, -2.9 + i * 0.14 + 0.1, 2]}
        for i in range(10)])


def _assert_render_matches(jax_pair, port_pair, W, H, spp, seed, depth):
    (js, jmed), (ts, tmed) = jax_pair, port_pair
    want_img, want_rays = jvol.render_vol_counted(js, jmed, W, H, spp, seed,
                                                  JPTConfig(max_depth=depth))
    got_img, got_rays = tvol.render_vol_counted(ts, tmed, W, H, spp, seed,
                                                tpt.PTConfig(max_depth=depth))
    want, got = np.asarray(want_img), got_img.numpy()
    assert got.shape == want.shape == (H, W, 3) and np.isfinite(got).all()
    assert int(got_rays) == int(want_rays)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6)
    assert abs(got.sum() - want.sum()) <= 1e-5 * abs(want.sum())
    return got


def test_camera_batch_matches_jax(cornell_plume):
    (js, _), (ts, _) = cornell_plume
    want = jvol._camera_batch(js, 12, 8, 3, jnp.uint32(9))
    got = tvol._camera_batch(ts, 12, 8, 3, 9)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]).astype(np.int64))
    for g, w in zip(got[1:4], want[1:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[4].state.numpy(), np.asarray(want[4].state).astype(np.int64))


def test_film_equals_add_samples():
    W, H, spp = 5, 3, 4
    rng = np.random.default_rng(2)
    L = torch.from_numpy(rng.normal(size=(W * H * spp, 3)).astype(np.float32))
    L[3, 1], L[17, 0], L[40, 2] = float("nan"), float("inf"), float("-inf")
    film = tfilm.add_samples(tfilm.Film.create(H, W, device="cpu"),
                             torch.arange(W * H).repeat(spp), L)
    assert torch.equal(tvol._film(L, W, H, spp), tfilm.develop(film))


def test_render_vol_counted_cornell_plume_matches_jax(cornell_plume):
    img = _assert_render_matches(*cornell_plume, 16, 16, 2, 3, 4)
    assert img.mean() > 0.1


def test_furnace_scattering_matches_jax():
    img = _assert_render_matches(*_furnace_scatter(), 12, 12, 4, 0, 8)
    assert abs(img.mean() - 1.0) < 0.15  # the JAX test's furnace, at 1/16 of its samples


def test_ten_slab_aggregate_matches_jax():
    img = _assert_render_matches(*_ten_slabs(), 12, 12, 4, 0, 4)
    assert abs(img[0:2].mean() - np.exp(-0.5)) < 0.1  # the top band sees the sky through 1 unit


def test_stepwise_equals_progressive(cornell_plume):
    _, (ts, tmed) = cornell_plume
    cfg = tpt.PTConfig(max_depth=3)
    prog = tvol.render_vol_progressive(ts, tmed, 8, 8, 2, 2, 5, cfg)
    step, rays = tvol.render_vol_stepwise(ts, tmed, 8, 8, 2, 2, 5, cfg, with_stats=True)
    assert torch.equal(prog, tvol.render_vol_stepwise(ts, tmed, 8, 8, 2, 2, 5, cfg))
    assert torch.equal(prog, step)
    passes = [tvol.render_vol_counted(ts, tmed, 8, 8, 2, s, cfg) for s in (5, 6)]
    assert int(rays) == sum(int(r) for _, r in passes)
    assert torch.equal(prog, (passes[0][0] + passes[1][0]) / 2)


def test_render_vol_is_differentiable():
    """render_vol records a graph: denser absorption darkens the image; with
    remat each bounce is recomputed in the backward, to the same loss and
    gradient bit for bit."""
    _, (ts, tmed) = _pair(jfurnace(albedo=0.7), [
        {"type": jm.HOMOGENEOUS, "sigma_a": [0.3] * 3, "sigma_s": [0.1] * 3,
         "box_min": [-2, -3, -2], "box_max": [2, -1.5, 2]}])
    out = []
    for remat in (False, True):
        sigma_a = tmed.sigma_a.clone().requires_grad_()
        loss = tvol.render_vol(ts, tmed._replace(sigma_a=sigma_a), 8, 8, 2, 0,
                               tpt.PTConfig(max_depth=3, rr_start=99, remat=remat)).mean()
        loss.backward()
        out.append((loss.detach(), sigma_a.grad))
    assert torch.isfinite(out[0][1]).all() and float(out[0][1].sum()) < 0
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    with torch.no_grad():
        _, rays = tvol.render_vol_counted(ts, tmed, 8, 8, 2, 0, tpt.PTConfig(max_depth=3))
    assert int(rays) > 0


def test_unported_features_raise(cornell_plume):
    _, (ts, tmed) = cornell_plume
    with pytest.raises(NotImplementedError):
        tvol.render_vol(ts, tmed, 4, 4, 1, 0, tpt.PTConfig(rec_filter=1))
    # the surface path tracer still refuses media
    with pytest.raises(NotImplementedError):
        tpt.render(ts, 4, 4, 1, 0, tpt.PTConfig(media_modes=tmed.modes))
    cfg = tvol.specialize_media_config(tmed, tpt.PTConfig())
    assert cfg.media_modes == tm.static_modes(tmed) == (("scalar", 1, -1, (32, 32, 32)),)
