"""The slice as a whole: the port's wavefront engine (and the megakernel on
the glossy scene) against the JAX package on the CPU.

Both render from identical scene arrays with the same per-lane random
streams, so they trace the same paths up to float32 rounding. Tolerances:
  * ray counts within 0.1%;
  * per-pixel images: at least 99% of pixels within 1e-3 relative on every
    channel (a path that grazes an edge or a lobe boundary may take the
    other side after a rounding difference, and the sun of radiance 120
    makes such a path visible), and the image means within 0.5%.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.render import path_tracer as jpt
from cudatracerlib_tpu.render import wavefront as jwf
from cudatracerlib_tpu.scene.shapes import cornell_box as jcornell
from cudatracerlib_tpu.scene.shapes import glossy_scene as jglossy
from cudatracerlib_tpu_torch.render import path_tracer as tpt
from cudatracerlib_tpu_torch.render import wavefront as twf
from cudatracerlib_tpu_torch.scene.shapes import cornell_box as tcornell
from cudatracerlib_tpu_torch.scene.shapes import glossy_scene as tglossy


@pytest.fixture(scope="module")
def glossy():
    return jglossy(), tglossy(device="cpu")


def _assert_images_close(port, ref, frac=0.99, rel=1e-3):
    port, ref = port.numpy(), np.asarray(ref)
    assert port.shape == ref.shape and np.isfinite(port).all()
    ok = (np.abs(port - ref) <= rel * np.abs(ref) + 1e-6).all(-1)
    assert ok.mean() >= frac, f"only {ok.mean():.4f} of pixels within {rel}"
    assert abs(port.mean() - ref.mean()) <= 5e-3 * abs(ref.mean())


def _assert_rays_close(rays, ref_rays):
    assert rays.dtype == torch.int64
    assert abs(int(rays) - float(ref_rays)) <= 1e-3 * float(ref_rays)


def test_wavefront_glossy_matches_jax(glossy):
    """The slice's main path at 32x32, 2 spp, depth 5, seed 3 (JAX: 7,883
    rays, mean 0.158875)."""
    js, ts = glossy
    ref, ref_rays = jwf.render_wavefront_counted(js, 32, 32, 2, 3, jpt.PTConfig(max_depth=5))
    img, rays = twf.render_wavefront_counted(ts, 32, 32, 2, 3, tpt.PTConfig(max_depth=5))
    _assert_rays_close(rays, ref_rays)
    _assert_images_close(img, ref)
    assert int(rays) > 7000 and float(img.mean()) > 0.1


def test_wavefront_refill_and_tail_drain(glossy):
    """A pool smaller than the camera-ray supply: lanes are refilled over
    several iterations and the tail drain fires."""
    js, ts = glossy
    cfg = dict(max_depth=5)
    ref, ref_rays = jwf.render_wavefront_counted(js, 24, 16, 4, 9, jpt.PTConfig(**cfg),
                                                 capacity=256)
    img, rays = twf.render_wavefront_counted(ts, 24, 16, 4, 9, tpt.PTConfig(**cfg),
                                             capacity=256)
    _assert_rays_close(rays, ref_rays)
    _assert_images_close(img, ref)
    plain = twf.render_wavefront(ts, 24, 16, 4, 9, tpt.PTConfig(**cfg), capacity=256)
    assert torch.equal(plain, img)


def test_megakernel_glossy_matches_jax(glossy):
    """The megakernel engine on the glossy scene: environment on escape,
    MIS and the microfacet BSDFs through `trace_radiance`."""
    js, ts = glossy
    ref, ref_rays = jpt.render_counted(js, 24, 24, 2, 5, jpt.PTConfig(max_depth=4))
    img, rays = tpt.render_counted(ts, 24, 24, 2, 5, tpt.PTConfig(max_depth=4))
    _assert_rays_close(rays, ref_rays)
    _assert_images_close(img, ref)


def test_wavefront_cornell_matches_jax():
    """The wavefront engine on the Cornell box (area light, dense band)."""
    ref, ref_rays = jwf.render_wavefront_counted(jcornell(), 32, 32, 2, 1,
                                                 jpt.PTConfig(max_depth=5))
    img, rays = twf.render_wavefront_counted(tcornell(device="cpu"), 32, 32, 2, 1,
                                             tpt.PTConfig(max_depth=5))
    _assert_rays_close(rays, ref_rays)
    _assert_images_close(img, ref)


def test_wavefront_seed_is_uint32(glossy):
    _, ts = glossy
    a = twf.render_wavefront(ts, 8, 8, 1, 2 ** 32 + 4, tpt.PTConfig(max_depth=2))
    b = twf.render_wavefront(ts, 8, 8, 1, 4, tpt.PTConfig(max_depth=2))
    assert torch.equal(a, b)
