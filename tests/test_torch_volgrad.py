"""Volume gradients (bench config 4's transmittance gradients): the port's
autograd through `render_vol` against the JAX package's `jax.grad` on the
CPU, on the JAX package's TestVolumetric gradient cases
(tests/test_engines.py:131) and its emissive slab (:222), and on bench
config 4's plume in the Cornell box at 16x16, 2 spp, depth 4 ('scalar'
mode), each scene and medium built from the JAX package's arrays
(`scene_from_numpy`, `media_from_numpy`). The 6^3 voxel grid (:191) and the
per-channel grids are in test_torch_volgrad_grids.py, which uses this
file's helpers.

JAX is given the media's mode tuple explicitly (`PTConfig.media_modes`):
under `jax.grad` of a grid its host cache misses (the grid is a tracer) and
it would fall back to the generic lookups, where the port keeps the mode it
was built with. So both take the same specialised path, the one the bench
runs (JAX's own scalar-grid lookup is its one-hot contraction, whose
cotangent sums in another order than the port's row sum).

Tolerances, measured on this CPU and stated once:
  * the loss within 2e-6 relative (measured up to 4.8e-7);
  * every gradient entry within 1e-3 of itself plus 1e-4 of the field's
    largest entry (measured: the sigma_a slab 2.0e-7 of the largest, the
    6^3 grid 1.1e-7, le 1.6e-7, the per-channel grids 8.7e-6 and the plume's
    grid 1.0e-5: float32 sums in other orders);
  * remat on against off: the loss and the gradients bit-equal;
  * the tracking loop saves no tensor for the backward.
Alone this file takes about 45 s, most of it JAX compiling two gradients.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.render import volpath as jvol
from cudatracerlib_tpu.render.path_tracer import PTConfig as JPTConfig
from cudatracerlib_tpu.scene import media as jm
from cudatracerlib_tpu.scene.shapes import cornell_box as jcornell
from cudatracerlib_tpu.scene.shapes import furnace_scene as jfurnace
from cudatracerlib_tpu_torch.convert import (flatten, get_field, grads, media_from_numpy,
                                             scene_from_numpy, with_grad)
from cudatracerlib_tpu_torch.render import path_tracer as tpt
from cudatracerlib_tpu_torch.render import volpath as tvol
from cudatracerlib_tpu_torch.scene import media as tm

RTOL, FIELD_FRAC, LOSS_RTOL = 1e-3, 1e-4, 2e-6
SLAB_BOX = dict(box_min=[-2, -3, -2], box_max=[2, -1.5, 2])
# the homogeneous cases' fields: one set, so JAX compiles their gradient once
HOMOGENEOUS_PATHS = ["sigma_a", "sigma_s", "le"]
GRID_PATHS = ["grid_data", "sigma_a", "sigma_s"]


def gradient_pair(jscene, records, paths, width, height, spp, seed, max_depth, rr_start):
    """(JAX loss, {path: JAX gradient}, port loss, {path: port gradient}) of
    mean(render_vol) with respect to the media fields `paths`."""
    jmed = jm.Media.build(records)
    jcfg = JPTConfig(max_depth=max_depth, rr_start=rr_start, media_modes=jm.static_modes(jmed))

    def loss(*xs):
        m = jmed._replace(**dict(zip(paths, xs)))
        return jnp.mean(jvol.render_vol(jscene, m, width, height, spp, seed, jcfg))

    jloss, jg = jax.value_and_grad(loss, argnums=tuple(range(len(paths))))(
        *(getattr(jmed, p) for p in paths))
    scene = scene_from_numpy(flatten(jscene), device="cpu")
    media = with_grad(media_from_numpy(flatten(jmed), device="cpu"), paths)
    tloss = tvol.render_vol(scene, media, width, height, spp, seed,
                            tpt.PTConfig(max_depth=max_depth, rr_start=rr_start)).mean()
    tloss.backward()
    return (float(jloss), {p: np.asarray(g) for p, g in zip(paths, jg)},
            float(tloss.detach()), grads(media, paths))


def assert_gradients_match(pair):
    jloss, jg, tloss, tg = pair
    assert abs(tloss - jloss) <= LOSS_RTOL * abs(jloss), (tloss, jloss)
    for path, want in jg.items():
        got = tg[path]
        assert got.shape == want.shape and np.isfinite(got).all(), path
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=FIELD_FRAC * np.abs(want).max(),
                                   err_msg=path)


@pytest.fixture(scope="module")
def slab_pair():
    """test_transmittance_gradient: an absorbing, weakly scattering slab in
    the white furnace, 16x16, 4 spp, seed 0, depth 3, no roulette."""
    return gradient_pair(jfurnace(albedo=0.7),
                         [dict(type=jm.HOMOGENEOUS, sigma_a=[0.3] * 3, sigma_s=[0.1] * 3,
                               **SLAB_BOX)],
                         HOMOGENEOUS_PATHS, 16, 16, 4, 0, 3, 99)


def test_transmittance_gradient_matches_jax(slab_pair):
    assert_gradients_match(slab_pair)
    g = slab_pair[3]["sigma_a"]
    assert (g < 0).all()  # a denser absorber darkens the image, as the JAX test asserts


def test_emission_gradient_matches_jax():
    """test_volume_emission's emissive slab (le 1) under a dim sky."""
    pair = gradient_pair(jfurnace(albedo=0.7, env_radiance=0.05),
                         [dict(type=jm.HOMOGENEOUS, sigma_a=[0.6] * 3, sigma_s=[0.05] * 3,
                               le=[1.0] * 3, **SLAB_BOX)],
                         HOMOGENEOUS_PATHS, 16, 16, 4, 0, 3, 99)
    assert_gradients_match(pair)
    assert (pair[3]["le"] > 0).all()  # more emission, a brighter image


def test_plume_gradient_matches_jax():
    js = jcornell()
    pair = gradient_pair(js, tm.plume_records(np.asarray(js.bvh.world_min),
                                              np.asarray(js.bvh.world_max)),
                         GRID_PATHS, 16, 16, 2, 3, 4, 5)
    assert_gradients_match(pair)
    g = pair[3]
    assert g["grid_data"][0] == 0 and np.abs(g["grid_data"]).max() > 0
    assert (g["sigma_a"] < 0).all()


def _plume_port(width=8, height=8):
    js = jcornell()
    scene = scene_from_numpy(flatten(js), device="cpu")
    media = tm.Media.build(tm.plume_records(np.asarray(js.bvh.world_min),
                                            np.asarray(js.bvh.world_max)), device="cpu")
    return scene, media


def test_remat_is_bit_equal_on_the_grid():
    scene, media = _plume_port()
    out = []
    for remat in (False, True):
        m = with_grad(media, ["grid_data", "sigma_s"])
        loss = tvol.render_vol(scene, m, 8, 8, 1, 3, tpt.PTConfig(max_depth=3, remat=remat)).mean()
        loss.backward()
        out.append((loss.detach(), grads(m)))
    assert torch.equal(out[0][0], out[1][0])
    for path in ("grid_data", "sigma_s"):
        np.testing.assert_array_equal(out[0][1][path], out[1][1][path])
    assert np.abs(out[0][1]["grid_data"]).max() > 0


def test_tracking_saves_no_tensor(monkeypatch):
    """The tracking trips record no graph: no tensor is packed for the
    backward while `delta_track` runs inside a differentiable render; the
    same trip with a graph recorded packs many."""
    real = tm.delta_track
    packed = {"loop": 0, "with_graph": 0}

    def pack_into(key):
        def pack(t):
            packed[key] += 1
            return t
        return pack

    def counted(*args):
        with torch.autograd.graph.saved_tensors_hooks(pack_into("loop"), lambda t: t):
            out = real(*args)
        if packed["with_graph"] == 0:  # the control: one trip with autograd on
            media, modes, o, d, u_near, u_far, maj, in_vol, state = args
            with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                    pack_into("with_graph"), lambda t: t):
                tm._track(media, modes, o, d, maj, u_far,
                          tm._Track(t=u_near, tracking=in_vol, real=torch.zeros_like(in_vol),
                                    state=state))
        return out

    monkeypatch.setattr(tm, "delta_track", counted)
    scene, media = _plume_port()
    m = with_grad(media, ["grid_data"])
    tvol.render_vol(scene, m, 6, 6, 1, 3, tpt.PTConfig(max_depth=2)).mean().backward()
    assert packed["loop"] == 0 and packed["with_graph"] > 0, packed
    assert np.abs(grads(m)["grid_data"]).max() > 0


def test_with_grad_and_grads_on_media():
    _, media = _plume_port()
    m = with_grad(media, ["grid_data", "sigma_a", "le"])
    assert m.modes == media.modes and m.modes[0][0] == "scalar"
    assert all(get_field(m, p).requires_grad for p in ("grid_data", "sigma_a", "le"))
    assert not m.sigma_s.requires_grad
    g = grads(m)
    assert set(g) == {"grid_data", "sigma_a", "le"}
    assert all((v == 0).all() and v.shape == tuple(get_field(m, k).shape) for k, v in g.items())
