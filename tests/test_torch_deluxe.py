"""`cornell_box_deluxe` (a checkerboard floor, a COATING sphere, a
roughconductor box and a back wall normal-mapped by an IMAGE texture)
through the port against the JAX package: its arrays, its first hits, the
megakernel and wavefront renders, the shade-pack path against the per-lane
gathers with the ray cone's footprint, and the gradients with respect to
the atlas and the texture colours against JAX's in
tools/texture_grad_reference.npz.

Tolerances:
  * arrays bit-equal (the BVH nodes' child codes are int32 bit patterns in
    float32 lanes); first hits lane-exact: hit or miss and the triangle hit
    equal on every lane (the SBVH's spatial splits reference a triangle from
    several Woop rows, equal bit for bit, and the two packages break such a
    tie between rows differently: the port takes the lowest row), t within
    2 ulps and the barycentrics within 2e-5 (JAX refines t, u, v from the
    Woop row in another order; on the sphere's small triangles u and v
    differ by up to 1.1e-5, tests/test_torch_scene.py's Cornell box by
    under 1e-5);
  * renders: at least 99% of pixels within 1e-3 relative (+1e-6) on every
    channel, the means within 0.5% (tests/test_torch_render.py's), rays
    within 0.1%;
  * the pack path: masks equal, floats within 1e-5 relative + 2e-6
    (tests/test_torch_glossy.py's);
  * gradients: each entry within 1e-3 of the field's largest (+1e-6), the
    loss within 1e-5 relative (the float32 sums of 16,384 lanes run in
    another order; chip_smoke.py holds the card to the same reference).
"""
import os

import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.render import path_tracer as jpt
from cudatracerlib_tpu.render import wavefront as jwf
from cudatracerlib_tpu.scene import scene as jsc
from cudatracerlib_tpu.scene.shapes import cornell_box_deluxe as jdeluxe
from cudatracerlib_tpu_torch.convert import flatten, grads, with_grad
from cudatracerlib_tpu_torch.render import path_tracer as tpt
from cudatracerlib_tpu_torch.render import wavefront as twf
from cudatracerlib_tpu_torch.scene import scene as tsc
from cudatracerlib_tpu_torch.scene import sensors as tsensors
from cudatracerlib_tpu_torch.scene import shade_pack as tsp
from cudatracerlib_tpu_torch.scene.shapes import cornell_box_deluxe as tdeluxe

GRAD_REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                        "texture_grad_reference.npz")


@pytest.fixture(scope="module")
def scenes():
    return jdeluxe(), tdeluxe(device="cpu")


def _bits(x):
    return x.view(np.int32) if x.dtype == np.float32 else x


def _assert_images_close(port, ref, frac=0.99, rel=1e-3):
    port, ref = port.numpy(), np.asarray(ref)
    assert port.shape == ref.shape and np.isfinite(port).all()
    ok = (np.abs(port - ref) <= rel * np.abs(ref) + 1e-6).all(-1)
    assert ok.mean() >= frac, f"only {ok.mean():.4f} of pixels within {rel}"
    assert abs(port.mean() - ref.mean()) <= 5e-3 * abs(ref.mean())


def test_arrays_equal(scenes):
    js, ts = scenes
    a, b = flatten(js), flatten(ts)
    assert set(a) == set(b)
    for k in sorted(a):
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]), err_msg=k)
    assert ts.bvh.woop.shape == (1428, 12) and ts.textures.atlas.shape == (1, 87381, 3)
    spec = tpt.specialize_config(ts, tpt.PTConfig())
    assert spec.tex_types == (0, 1, 2) and spec.bsdf_types == (0, 6, 11)
    assert spec.normal_maps and not (spec.height_maps or spec.alpha_test or spec.sss)


def test_first_hits_lane_exact(scenes):
    """The camera rays of a 32x32, 2-spp pass, lane for lane: hit or miss,
    the triangle (the Woop row's `tri_index`), t and the barycentrics."""
    js, ts = scenes
    o, d, _, _ = tpt.camera_rays(ts, 32, 32, 2, 3)
    jh = jsc.scene_intersect(js, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    th = tsc.scene_intersect(ts, o, d)
    np.testing.assert_array_equal(th.valid.numpy(), np.asarray(jh.valid))
    v = th.valid.numpy()
    tri = ts.bvh.tri_index.numpy()
    np.testing.assert_array_equal(tri[th.prim.numpy()[v]], tri[np.asarray(jh.prim)[v]])
    np.testing.assert_array_max_ulp(th.t.numpy()[v], np.asarray(jh.t)[v], maxulp=2)
    np.testing.assert_allclose(th.bary.numpy()[v], np.asarray(jh.bary)[v], rtol=0, atol=2e-5)


def test_megakernel_render(scenes):
    js, ts = scenes
    cfg = dict(max_depth=5)
    want, want_rays = jpt.render_counted(js, 16, 16, 4, 3, jpt.PTConfig(**cfg))
    got, rays = tpt.render_counted(ts, 16, 16, 4, 3, tpt.PTConfig(**cfg))
    assert abs(int(rays) - float(want_rays)) <= 1e-3 * float(want_rays)
    _assert_images_close(got, want)


def test_wavefront_render(scenes):
    js, ts = scenes
    cfg = dict(max_depth=5)
    want, want_rays = jwf.render_wavefront_counted(js, 16, 16, 4, 3, jpt.PTConfig(**cfg))
    got, rays = twf.render_wavefront_counted(ts, 16, 16, 4, 3, tpt.PTConfig(**cfg))
    assert abs(int(rays) - float(want_rays)) <= 1e-3 * float(want_rays)
    _assert_images_close(got, want)


@pytest.mark.parametrize("depth", [0, 2])
def test_pack_path_equals_gathers(scenes, depth):
    """`surface_bounce` with the deluxe shade pack (1,428 rows, in the
    pack's band: what the card runs) against the per-lane gathers, with the
    ray cone: the pack's uv_density column gives the same footprint."""
    _, ts = scenes
    cfg = tpt.specialize_config(ts, tpt.PTConfig(max_depth=5))
    o, d, _, smp = tpt.camera_rays(ts, 32, 32, 2, 3)
    n = o.shape[0]
    rng = np.random.default_rng(depth)
    kw = dict(o=o, d=d, active=torch.from_numpy(rng.random(n) < 0.9),
              throughput=torch.from_numpy(rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32)),
              prev_pdf=torch.from_numpy(rng.uniform(0, 2, n).astype(np.float32)),
              prev_delta=torch.from_numpy(rng.random(n) < 0.5), eta_scale=torch.ones(n),
              path_len=torch.from_numpy(rng.uniform(0, 3, n).astype(np.float32)),
              sampler=smp, depth=depth, cone=tsensors.pixel_spread(ts.camera, 32, 32))
    take = tpt.surface_bounce(ts, cfg, pack=None, **kw)
    packed = tpt.surface_bounce(ts, cfg, pack=tsp.build_shade_pack(ts), **kw)
    c = take.cont
    for f in ("cont", "delta_now"):
        assert torch.equal(getattr(packed, f), getattr(take, f)), f
    assert 0.3 < float(c.float().mean()) < 0.95
    for f in ("L_add", "bs_pdf", "eta_scale", "path_len"):
        torch.testing.assert_close(getattr(packed, f), getattr(take, f), rtol=1e-5, atol=2e-6)
    for f in ("o", "d", "throughput"):
        torch.testing.assert_close(getattr(packed, f)[c], getattr(take, f)[c], rtol=1e-5,
                                   atol=2e-6)
    assert torch.equal(packed.sampler.state, take.sampler.state)


def test_gradients_against_jax_reference(scenes):
    """d mean(render(deluxe, 64x64, 4 spp, seed 0, depth 4, no roulette))
    with respect to textures.atlas and textures.color_a against the JAX
    package's (tools/texture_grad_reference.py wrote them)."""
    ref = np.load(GRAD_REF)
    _, ts = scenes
    paths = ["textures.atlas", "textures.color_a"]
    tg = with_grad(ts, paths)
    loss = tpt.render(tg, 64, 64, 4, 0, tpt.PTConfig(max_depth=4, rr_start=99)).mean()
    loss.backward()
    ref_loss = float(ref["deluxe/loss"])
    assert abs(float(loss.detach()) - ref_loss) <= 1e-5 * ref_loss
    got = grads(tg, paths)
    for path in paths:
        want = ref[f"deluxe/{path}"]
        scale = float(np.abs(want).max())
        assert scale > 0 and np.isfinite(got[path]).all(), path
        np.testing.assert_allclose(got[path], want, rtol=0, atol=1e-3 * scale + 1e-6,
                                   err_msg=path)
    assert (got["textures.atlas"] != 0).sum() > 1000   # the normal map's texels
