"""The port's CUDA kernels on the card, against their plain PyTorch
versions: the dense and the BVH intersector, the shade-pack gather and the
photon density estimate.

Every test needs an NVIDIA GPU and skips without one. This file imports no
JAX, so it also runs where JAX is not installed:
    python -m pytest tests/test_torch_cuda.py -q --noconftest
Tolerances as in chip_smoke.py: `valid` agrees on every ray except
edge-grazing ones; on rays both versions hit at equal Woop rows, t within
1e-4 * max(1, t) and the barycentrics within 1e-4. The gather is exact.
The photon density within 1e-4 relative (+1e-6 of the largest sum): the
per-pair weights are bit-equal, the sums run in another order.
Renders on the card: mean within 1% of the CPU render, rays within 0.1%.
"""
import numpy as np
import pytest
import torch

from cudatracerlib_tpu_torch.accel.bvh import build_bvh, woop_transform
from cudatracerlib_tpu_torch.ops import intersect_bvh as bvh_ops
from cudatracerlib_tpu_torch.ops import intersect_dense as ops
from cudatracerlib_tpu_torch.ops import photon_gather as pg_ops
from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops
from cudatracerlib_tpu_torch.render import path_tracer as pt
from cudatracerlib_tpu_torch.render import ppm
from cudatracerlib_tpu_torch.render import wavefront as wf
from cudatracerlib_tpu_torch.scene import shade_pack
from cudatracerlib_tpu_torch.scene.shapes import caustic_scene, cornell_box, glossy_scene

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda:0")


def _soup(dev, n_tri, n_ray, seed):
    rng = np.random.default_rng(seed)
    tris = (rng.uniform(-1, 1, (n_tri, 1, 3)) + rng.normal(scale=0.1, size=(n_tri, 3, 3)))
    tris = tris.astype(np.float32)
    woop = torch.from_numpy(woop_transform(tris[:, 0], tris[:, 1], tris[:, 2])).to(dev)
    o = torch.from_numpy(rng.uniform(-1.5, 1.5, (n_ray, 3)).astype(np.float32)).to(dev)
    d = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(n_ray, 3)).astype(np.float32)).to(dev), dim=-1)
    return woop, o, d


def _assert_agree(woop, o, d, t_min, t_max):
    plain = ops.intersect_dense_plain(woop, o, d, t_min, t_max)
    for any_hit in (False, True):
        kern = ops.intersect_dense(woop, o, d, t_min, t_max, any_hit=any_hit)
        torch.cuda.synchronize()
        r = ops.compare_hits(kern, plain, woop, t_min, t_max, any_hit=any_hit)
        assert r["hits"] > 0
        assert r["valid_mismatch_not_grazing"] == 0, r
        assert r["valid_mismatch"] <= 1e-5 * r["rays"] + 1, r
        if not any_hit:
            assert r["prim_mismatch_not_grazing"] == 0, r
            t_scale = float(torch.clamp(plain.t[plain.valid].abs().max(), min=1.0))
            assert r["max_abs_err_t"] <= 1e-4 * t_scale and r["max_abs_err_bary"] <= 1e-4, r


@pytest.mark.parametrize("n_tri", [7, 60, 513, 4096])
def test_kernel_matches_plain_on_soups(dev, n_tri):
    woop, o, d = _soup(dev, n_tri, 1 << 16, n_tri)
    _assert_agree(woop, o, d, 1e-4, torch.inf)


def test_kernel_per_ray_ranges(dev):
    woop, o, d = _soup(dev, 700, 1 << 16, 5)
    g = torch.Generator(device="cpu").manual_seed(0)
    t_min = (torch.rand(o.shape[0], generator=g) * 0.2).to(dev)
    t_max = (t_min.cpu() + torch.rand(o.shape[0], generator=g) * 2.0).to(dev)
    _assert_agree(woop, o, d, t_min, t_max)


def test_kernel_on_cornell_camera_rays(dev):
    scene = cornell_box(device=dev)
    o, d, _, _ = pt.camera_rays(scene, 128, 128, 4, 3)
    _assert_agree(scene.bvh.woop, o, d, 1e-4, torch.inf)


def test_launch_counter_and_output_types(dev):
    woop, o, d = _soup(dev, 64, 1000, 1)
    before = dict(ops.launches)
    hit = ops.intersect_dense(woop, o, d)
    ops.intersect_dense(woop, o, d, t_max=1.0, any_hit=True)
    ops.intersect_dense_plain(woop, o, d)
    assert ops.launches["closest"] == before["closest"] + 1
    assert ops.launches["any_hit"] == before["any_hit"] + 1
    assert hit.t.device.type == "cuda" and hit.prim.dtype == torch.int32
    assert hit.bary.shape == (1000, 2) and (hit.t[~hit.valid] == 1e30).all()


def test_empty_batch_and_mixed_devices(dev):
    woop, o, d = _soup(dev, 8, 16, 2)
    empty = ops.intersect_dense(woop, o[:0], d[:0])
    assert empty.t.shape == (0,) and empty.bary.shape == (0, 2)
    with pytest.raises(ValueError):
        ops.intersect_dense(woop.cpu(), o, d)


def test_render_on_card_matches_cpu(dev):
    """The entry() shape (64x64, 2 spp, depth 5) on the card and on the CPU:
    99% of pixels within 1e-3 relative, ray counts within 0.1%."""
    scene = cornell_box(device="cpu")
    cfg = pt.PTConfig(max_depth=5)
    ref, ref_rays = pt.render_counted(scene, 64, 64, 2, 0, cfg)
    img, rays = pt.render_counted(scene.to(dev), 64, 64, 2, 0, cfg)
    img = img.cpu()
    ok = ((img - ref).abs() <= 1e-3 * ref.abs() + 1e-6).all(-1).float().mean()
    assert ok >= 0.99, float(ok)
    assert abs(int(rays) - int(ref_rays)) <= 1e-3 * int(ref_rays)


def _assert_bvh_agree(bvh, o, d, t_min, t_max):
    for any_hit in (False, True):
        plain = bvh_ops.intersect_bvh_plain(bvh, o, d, t_min, t_max, any_hit=any_hit)
        kern = bvh_ops.intersect_bvh(bvh, o, d, t_min, t_max, any_hit=any_hit)
        torch.cuda.synchronize()
        r = ops.compare_hits(kern, plain, bvh.woop, t_min, t_max, any_hit=any_hit)
        assert r["hits"] > 0
        assert r["valid_mismatch_not_grazing"] == 0, r
        if not any_hit:
            assert r["prim_mismatch_not_grazing"] == 0, r
            t_scale = float(torch.clamp(plain.t[plain.valid].abs().max(), min=1.0))
            assert r["max_abs_err_t"] <= 1e-4 * t_scale and r["max_abs_err_bary"] <= 1e-4, r


@pytest.fixture(scope="module")
def glossy(dev):
    return glossy_scene(device=dev)


def test_bvh_kernel_on_glossy_rays(dev, glossy):
    _, o, d, _ = wf._camera_ray(glossy, torch.arange(128 * 128 * 4, device=dev), 3, 128, 128)
    _assert_bvh_agree(glossy.bvh, o, d, 1e-4, torch.inf)
    _assert_bvh_agree(glossy.bvh, o, d, 1e-4, 6.0)


def test_bvh_kernel_on_soup(dev):
    rng = np.random.default_rng(3)
    tris = (rng.uniform(-1, 1, (20000, 1, 3)) + rng.normal(scale=0.05, size=(20000, 3, 3)))
    bvh = build_bvh(tris.astype(np.float32), device=dev)
    o = torch.from_numpy(rng.uniform(-1.5, 1.5, (1 << 16, 3)).astype(np.float32)).to(dev)
    d = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(1 << 16, 3)).astype(np.float32)).to(dev), dim=-1)
    _assert_bvh_agree(bvh, o, d, 1e-4, torch.inf)


def test_bvh_launch_counter_and_output_types(dev, glossy):
    o = torch.tensor([[0.3, -5.5, 2.2]] * 4, device=dev)
    d = torch.nn.functional.normalize(torch.tensor([[0.0, 1.0, -0.2]] * 4, device=dev), dim=-1)
    before = dict(bvh_ops.launches)
    hit = bvh_ops.intersect_bvh(glossy.bvh, o, d)
    bvh_ops.intersect_bvh(glossy.bvh, o, d, t_max=1.0, any_hit=True)
    bvh_ops.intersect_bvh_plain(glossy.bvh, o, d)
    assert bvh_ops.launches["closest"] == before["closest"] + 1
    assert bvh_ops.launches["any_hit"] == before["any_hit"] + 1
    assert hit.t.device.type == "cuda" and hit.prim.dtype == torch.int32 and hit.valid.all()
    empty = bvh_ops.intersect_bvh(glossy.bvh, o[:0], d[:0])
    assert empty.t.shape == (0,) and empty.bary.shape == (0, 2)


def test_shade_gather_bit_equal(dev, glossy):
    pack = shade_pack.build_shade_pack(glossy)
    g = torch.Generator(device="cpu").manual_seed(0)
    idx = torch.randint(-100, pack.shape[0] + 100, (1 << 18,), generator=g,
                        dtype=torch.int32).to(dev)
    before = sg_ops.launches["gather"]
    out = sg_ops.packed_gather(pack, idx)
    torch.cuda.synchronize()
    assert sg_ops.launches["gather"] == before + 1
    assert torch.equal(out, sg_ops.packed_gather_plain(pack, idx))
    assert out.shape == (1 << 18, 64)


def test_glossy_wavefront_on_card_matches_cpu(dev):
    """Bench config 2's path at 32x32, 2 spp, depth 5, seed 3: both new
    kernels launch, and the render agrees with the CPU's."""
    cfg = pt.PTConfig(max_depth=5)
    ref, ref_rays = wf.render_wavefront_counted(glossy_scene(device="cpu"), 32, 32, 2, 3, cfg)
    before = dict(bvh_ops.launches), dict(sg_ops.launches)
    img, rays = wf.render_wavefront_counted(glossy_scene(device=dev), 32, 32, 2, 3, cfg)
    assert bvh_ops.launches["closest"] > before[0]["closest"]
    assert bvh_ops.launches["any_hit"] > before[0]["any_hit"]
    assert sg_ops.launches["gather"] > before[1]["gather"]
    assert abs(float(img.mean()) - float(ref.mean())) <= 1e-2 * float(ref.mean())
    assert abs(int(rays) - int(ref_rays)) <= 1e-3 * int(ref_rays)


def _photon_cloud(dev, n_ph, n_q, spread, seed):
    """Photons and cell-sorted queries on a floor patch of half-width
    `spread` around (0.5, 0.5), 10% of each invalid."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((n_ph, 3), np.float32)
    pos[:, :2] = 0.5 + rng.uniform(-spread, spread, (n_ph, 2))
    normal = np.tile(np.float32([[0, 0, 1]]), (n_ph, 1))
    wi = rng.normal(size=(n_ph, 3)).astype(np.float32) + normal
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    power = rng.uniform(0, 1, (n_ph, 3)).astype(np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    tiles, aabbs = pg_ops.build_photon_tiles(t(pos), t(power), t(normal),
                                             t(rng.random(n_ph) >= 0.1), [0, 0, -1], [1, 1, 1],
                                             14, wi=t(wi))
    q = np.zeros((n_q, 3), np.float32)
    q[:, :2] = 0.5 + rng.uniform(-spread, spread, (n_q, 2))
    qv = rng.random(n_q) >= 0.1
    key = np.where(qv, np.floor(q[:, 0] * 14) * 14 + np.floor(q[:, 1] * 14), 1e9)
    order = np.argsort(key, kind="stable")
    return tiles, aabbs, t(q[order]), t(np.tile(np.float32([[0, 0, 1]]), (n_q, 1))), t(qv[order])


@pytest.mark.parametrize("n_ph,n_q,spread", [(200_000, 20_000, 0.45), (50_000, 4_000, 0.02)],
                         ids=["cloud-391-tiles", "hotspot"])
def test_photon_density_kernel_matches_plain(dev, n_ph, n_q, spread):
    tiles, aabbs, q, qn, qv = _photon_cloud(dev, n_ph, n_q, spread, n_q)
    before = pg_ops.launches["density"]
    kf, kw = pg_ops.photon_density(tiles, aabbs, q, qn, qv, 0.07)
    pf, pw = pg_ops.photon_density_plain(tiles, aabbs, q, qn, qv, 0.07)
    torch.cuda.synchronize()
    assert pg_ops.launches["density"] == before + 1
    for k, p in ((kf, pf), (kw, pw)):
        assert ((k - p).abs() <= 1e-4 * p.abs() + 1e-6 * float(p.abs().max())).all()
    assert (kw[~qv] == 0).all() and (kf[~qv] == 0).all() and (kw[qv] > 0).float().mean() > 0.9


def test_ppm_pass_on_card_launches_its_kernels(dev):
    """The caustic scene's PPM pass at 32x32, 1 spp, 8,192 photons runs the
    photon-major kernel, both kinds of dense intersection and the gather, and
    its mean is within 2% of the CPU render (the CPU gathers at most 128
    photons per query, the card every photon)."""
    cfg = ppm.PPMConfig(n_photons=8192)
    ref = ppm.render_ppm_pass(caustic_scene(device="cpu"), 32, 32, 1, 3, 1, cfg)
    before = dict(pg_ops.launches), dict(ops.launches), dict(sg_ops.launches)
    img = ppm.render_ppm_pass(caustic_scene(), 32, 32, 1, 3, 1, cfg)
    torch.cuda.synchronize()
    assert pg_ops.launches["density"] == before[0]["density"] + 2
    assert ops.launches["closest"] > before[1]["closest"]
    assert ops.launches["any_hit"] > before[1]["any_hit"]
    assert sg_ops.launches["gather"] > before[2]["gather"]
    assert img.device.type == "cuda" and bool(torch.isfinite(img).all())
    assert abs(float(img.mean()) - float(ref.mean())) <= 2e-2 * float(ref.mean())
