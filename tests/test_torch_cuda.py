"""The port's CUDA kernels on the card, against their plain PyTorch
versions: the dense intersector (chunk-culled sweep) and the BVH
intersector (persistent while-while walk), the shade-pack gather and its
backward, and the photon density estimate.

Every test needs an NVIDIA GPU and skips without one. This file imports no
JAX, so it also runs where JAX is not installed:
    python -m pytest tests/test_torch_cuda.py -q --noconftest
Tolerances as in chip_smoke.py: `valid` agrees on every ray except
edge-grazing ones; on rays both versions hit at equal Woop rows, t within
1e-4 * max(1, t) and the barycentrics within 1e-4. The gather is exact.
Its backward is deterministic: bit-equal to the plain emulation of its
summation order and to itself, within 1e-5 relative of the float64 plain
version on positive cotangents.
The photon density within 1e-4 relative (+1e-6 of the largest sum): the
per-pair weights are bit-equal, the sums run in another order; two
launches are bit-equal.
The BVH kernel's t, u, v are bit-equal to its oracle's on every ray whose
two hits name the same Woop row content.
Renders on the card: mean within 1% of the CPU render, rays within 0.1%;
the volume render within 7.5% and 1% (its test says why). The sharded
render on one NCCL rank: rays within 1e-3 and the mean within 1e-4
relative of one CPU rank's (the same lanes and seed). The filtered
film's splat sum as the gather backward's. The port's TestFurnace runs
here at the JAX test's sizes (on the CPU it is `slow`). The textured and
subsurface renders and their gradients (the atlas, the colours, the
sigmas) against the CPU's: means within 1%, gradients within 1% of the
largest entry. The spectral renders and their cauchy gradient, the guided
render and its deposit's row sum, the realtime and AOV tracers and
generate_fits' quadrature against the CPU port's as each test states.
A 'scalar' volume's transmittance kernel is bit-equal to its plain version
on the plume's 2^20 segment and shadow rays, its backward within 1e-5 of
the largest entry and bit-equal to itself, one launch a call.
The tracking kernel's t, real and T equal the eager loop's on each of a
1024^2 plume pass's six calls (2^20 lanes), a 256^2 plume image is
bit-equal on the two paths, and on the kernel's path a bounce launches it
once, reads nothing back and counts the T its sampler states imply.
The sharded volume step on four NCCL ranks (skips with fewer than four
cards): the summed gradient bit-equal on every rank, and within 1e-5 of
each leaf's largest entry of one card's step over the same four blocks of
lanes, each traced as its own batch (the sums run in another order).
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import numpy as np
import pytest
import torch

from cudatracerlib_tpu_torch.accel.bvh import build_bvh, vertex_rows, woop_transform
from cudatracerlib_tpu_torch.convert import grads, with_grad
from cudatracerlib_tpu_torch.ops import intersect_bvh as bvh_ops
from cudatracerlib_tpu_torch.ops import intersect_dense as ops
from cudatracerlib_tpu_torch.ops import photon_gather as pg_ops
from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops
from cudatracerlib_tpu_torch.parallel import shard
from cudatracerlib_tpu_torch.parallel.distributed import run_ranks
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
    verts = vertex_rows(torch.from_numpy(tris)).to(dev)
    o = torch.from_numpy(rng.uniform(-1.5, 1.5, (n_ray, 3)).astype(np.float32)).to(dev)
    d = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(n_ray, 3)).astype(np.float32)).to(dev), dim=-1)
    return woop, verts, o, d


def _assert_agree(woop, verts, o, d, t_min, t_max, boxes=None):
    plain = ops.intersect_dense_plain(woop, o, d, t_min, t_max, verts=verts)
    for any_hit in (False, True):
        kern = ops.intersect_dense(woop, o, d, t_min, t_max, any_hit=any_hit, boxes=boxes,
                                   verts=verts)
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
    woop, verts, o, d = _soup(dev, n_tri, 1 << 16, n_tri)
    _assert_agree(woop, verts, o, d, 1e-4, torch.inf)


def test_kernel_per_ray_ranges(dev):
    woop, verts, o, d = _soup(dev, 700, 1 << 16, 5)
    g = torch.Generator(device="cpu").manual_seed(0)
    t_min = (torch.rand(o.shape[0], generator=g) * 0.2).to(dev)
    t_max = (t_min.cpu() + torch.rand(o.shape[0], generator=g) * 2.0).to(dev)
    _assert_agree(woop, verts, o, d, t_min, t_max)


def test_kernel_on_cornell_camera_rays(dev):
    scene = cornell_box(device=dev)
    o, d, _, _ = pt.camera_rays(scene, 128, 128, 4, 3)
    _assert_agree(scene.bvh.woop, scene.bvh.tri_verts, o, d, 1e-4, torch.inf)


def _caustic_photon_rays(dev):
    """The caustic scene (on the card) and its photon walk's rays of the
    first two bounces, 2^15 lanes each, captured at the dense intersector."""
    scene = caustic_scene(device=dev)
    seen = []
    real = ops.intersect_dense

    def capture(woop, o, d, *args, **kw):
        seen.append((o.clone(), d.clone()))
        return real(woop, o, d, *args, **kw)

    ops.intersect_dense = capture
    try:
        cfg = pt.specialize_config(scene, ppm.PPMConfig().base._replace(max_depth=2))
        ppm.trace_photons(scene, 1 << 15, 3, cfg)
    finally:
        ops.intersect_dense = real
    return scene, seen


def test_kernel_on_caustic_rays(dev):
    """3,160 rows (99 chunk boxes, the BVH's): photon rays of two bounces
    and camera rays, closest and any-hit."""
    scene, seen = _caustic_photon_rays(dev)
    o, d, _, _ = pt.camera_rays(scene, 64, 64, 4, 3)
    for ro, rd in (*seen, (o, d)):
        _assert_agree(scene.bvh.woop, scene.bvh.tri_verts, ro, rd, 1e-4, torch.inf,
                      boxes=scene.bvh.chunk_boxes)


def test_kernel_empty_ranges(dev):
    """Lanes with t_min >= t_max test nothing and return t_max; the others
    agree with the plain version."""
    scene, seen = _caustic_photon_rays(dev)
    o, d = seen[0]
    n = o.shape[0]
    g = torch.Generator(device="cpu").manual_seed(1)
    t_max = (torch.rand(n, generator=g) * 4 + 0.1).to(dev)
    k = torch.arange(n, device=dev)
    empty = k % 3 == 0
    t_min = torch.where(empty, t_max + 0.5 * (k % 2), 1e-4)
    _assert_agree(scene.bvh.woop, scene.bvh.tri_verts, o, d, t_min, t_max,
                  boxes=scene.bvh.chunk_boxes)
    for any_hit in (False, True):
        hit = ops.intersect_dense(scene.bvh.woop, o, d, t_min, t_max, any_hit=any_hit,
                                  boxes=scene.bvh.chunk_boxes, verts=scene.bvh.tri_verts)
        assert not hit.valid[empty].any() and torch.equal(hit.t[empty], t_max[empty])
        assert hit.valid[~empty].float().mean() > 0.2


def test_launch_counter_and_output_types(dev):
    woop, verts, o, d = _soup(dev, 64, 1000, 1)
    before = dict(ops.launches)
    hit = ops.intersect_dense(woop, o, d, verts=verts)
    ops.intersect_dense(woop, o, d, t_max=1.0, any_hit=True, verts=verts)
    ops.intersect_dense_plain(woop, o, d, verts=verts)
    assert ops.launches["closest"] == before["closest"] + 1
    assert ops.launches["any_hit"] == before["any_hit"] + 1
    assert hit.t.device.type == "cuda" and hit.prim.dtype == torch.int32
    assert hit.bary.shape == (1000, 2) and (hit.t[~hit.valid] == 1e30).all()


def test_empty_batch_and_mixed_devices(dev):
    woop, verts, o, d = _soup(dev, 8, 16, 2)
    empty = ops.intersect_dense(woop, o[:0], d[:0], verts=verts)
    assert empty.t.shape == (0,) and empty.bary.shape == (0, 2)
    with pytest.raises(ValueError):
        ops.intersect_dense(woop.cpu(), o, d, verts=verts.cpu())


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


@pytest.mark.parametrize("n", [0, 1, 31, 33, 1000, 1 << 18])
def test_persistent_bvh_kernel_batches(dev, glossy, n):
    """Ray counts around the warp's batch of 32, one not a multiple of it,
    and 2^18 rays, more than the card keeps resident (132 SMs x 32 warps x
    32 lanes = 135,168): against the oracle, t / u / v bit-equal where the
    two hits name the same Woop row content."""
    g = torch.Generator(device="cpu").manual_seed(n)
    ids = torch.randperm(512 * 512, generator=g)[:n].to(dev)
    _, o, d, _ = wf._camera_ray(glossy, ids, 3, 512, 512)
    woop = glossy.bvh.woop
    for any_hit in (False, True):
        plain = bvh_ops.intersect_bvh_plain(glossy.bvh, o, d, 1e-4, torch.inf, any_hit=any_hit)
        kern = bvh_ops.intersect_bvh(glossy.bvh, o, d, 1e-4, torch.inf, any_hit=any_hit)
        torch.cuda.synchronize()
        assert kern.t.shape == (n,) and kern.bary.shape == (n, 2)
        if n == 0:
            continue
        r = ops.compare_hits(kern, plain, woop, 1e-4, torch.inf, any_hit=any_hit)
        assert r["valid_mismatch_not_grazing"] == 0, r
        if not any_hit:
            assert r["prim_mismatch_not_grazing"] == 0, r
            both = kern.valid & plain.valid
            same = both & (woop[kern.prim.clamp(min=0).long()]
                           == woop[plain.prim.clamp(min=0).long()]).all(-1)
            assert torch.equal(kern.t[same], plain.t[same])
            assert torch.equal(kern.bary[same], plain.bary[same])
            assert torch.equal(kern.t[~kern.valid & ~plain.valid],
                               plain.t[~kern.valid & ~plain.valid])


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


def _assert_density_agrees(args, radius=0.07):
    kf, kw = pg_ops.photon_density(*args, radius)
    pf, pw = pg_ops.photon_density_plain(*args, radius)
    torch.cuda.synchronize()
    assert kf.shape == pf.shape and kw.shape == pw.shape
    for k, p in ((kf, pf), (kw, pw)):
        if p.numel():
            assert ((k - p).abs() <= 1e-4 * p.abs() + 1e-6 * float(p.abs().max())).all()
    qv = args[4]
    assert (kw[~qv] == 0).all() and (kf[~qv] == 0).all()
    return kf, kw


@pytest.mark.parametrize("n_q", [0, 1, 33, 300, 4097])
def test_photon_density_ragged_batches(dev, n_q):
    """B = 0, below one warp, not a multiple of 32 or of the CTA's 256, and
    a block of 256 queries with no valid one (queries 256-511)."""
    tiles, aabbs, q, qn, qv = _photon_cloud(dev, 20_000, n_q, 0.3, 11)
    qv[256:512] = False
    kf, kw = _assert_density_agrees((tiles, aabbs, q, qn, qv))
    assert kf.shape == (n_q, 3) and kw.shape == (n_q,)
    if n_q > 256:
        assert (kw[256:512] == 0).all() and (kw[qv] > 0).float().mean() > 0.9


def test_photon_density_hot_block_and_many_tiles(dev):
    """One block of 256 queries that keeps every non-empty tile of 40 (the
    last ones hold only invalid photons), more than the splits times the
    ring's stages; then 1,100 tiles, more than one cull round of 1,024 and
    no multiple of 256."""
    tiles, aabbs, q, qn, qv = _photon_cloud(dev, 40 * 512, 256, 0.03, 5)
    non_empty = int((aabbs[:, 0] <= aabbs[:, 3]).sum())
    assert int(pg_ops.block_cull(aabbs, q, qv, 0.07).sum()) == non_empty > 16
    _assert_density_agrees((tiles, aabbs, q, qn, qv))
    tiles, aabbs, q, qn, qv = _photon_cloud(dev, 1100 * 512, 8192, 0.45, 3)
    assert tiles.shape[0] == 1100
    _assert_density_agrees((tiles, aabbs, q, qn, qv))


def test_photon_density_deterministic_and_counted(dev):
    """Two launches give the same bits; one estimate counts one launch of
    the density kernel and one of the reduction over its splits."""
    args = _photon_cloud(dev, 200_000, 20_000, 0.45, 7) + (0.07,)
    before = dict(pg_ops.launches)
    a = pg_ops.photon_density(*args)
    b = pg_ops.photon_density(*args)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert pg_ops.launches["density"] == before["density"] + 2
    assert pg_ops.launches["density_reduce"] == before["density_reduce"] + 2
    prepared, out = pg_ops.launch_args(*args)
    pg_ops.launch(prepared)
    torch.cuda.synchronize()
    assert torch.equal(out[:, 3], a[1]) and pg_ops.launches["density"] == before["density"] + 2
    info = pg_ops.kernel_info()
    assert info["local_bytes"] == 0 and info["ctas_per_sm"] >= 2


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


@pytest.mark.parametrize("n,cols", [(0, 64), (1, 64), (257, 64), (3000, 64), (3000, 12),
                                    (3000, 3), (3000, 33), (5003, 1), (70000, 64),
                                    (300000, 64)])
def test_shade_gather_bwd_matches_emulation(dev, n, cols):
    """The backward kernels against the plain emulation of their order (bit
    for bit) and the float64 plain version: duplicate, out-of-range and
    long-run indices, rows no lane hit, a tile plus one lane, tails that are
    not a 16-byte multiple (C = 33, C = 1), ranges of 32 tiles (70,000 x 64)
    and of 37 (300,000 x 64: past 1,024 tiles); C = 12 is the hit
    refinement's Woop-row cotangent, 3 a texture colour's."""
    rng = np.random.default_rng(n + cols)
    idx = rng.integers(-3, 40, n).astype(np.int32)
    idx[rng.random(n) < 0.4] = 7
    g = rng.random((n, cols), dtype=np.float32)
    tg, ti = torch.from_numpy(g).to(dev), torch.from_numpy(idx).to(dev)
    before = dict(sg_ops.launches)
    got = sg_ops.packed_gather_bwd(tg, ti, 37)
    again = sg_ops.packed_gather_bwd(tg, ti, 37)
    torch.cuda.synchronize()
    for k in ("gather_bwd_tile", "gather_bwd_range"):
        assert sg_ops.launches[k] == before[k] + 2 * (n > 0)
    assert sg_ops.launches["gather_bwd_final"] == before["gather_bwd_final"] + 2
    assert torch.equal(got, again) and got.shape == (37, cols)
    emu = sg_ops.packed_gather_bwd_emulated(torch.from_numpy(g), torch.from_numpy(idx), 37)
    assert torch.equal(got.cpu(), emu)
    plain = sg_ops.packed_gather_bwd_plain(torch.from_numpy(g), torch.from_numpy(idx), 37)
    assert ((got.cpu() - plain).abs() <= 1e-5 * plain.abs()).all()


def test_shade_gather_bwd_few_hot_rows(dev):
    """A texture lookup's shape: 2^20 lanes x 3 onto 5 rows in runs, one row
    hit by half the lanes, against the float64 plain version (1e-5
    relative), twice bit-equal, bit-equal to the emulation on 4,096 lanes;
    an unaligned view of g is copied, not refused."""
    rng = np.random.default_rng(5)
    n = 1 << 20
    idx = np.repeat(rng.integers(0, 5, n // 16), 16).astype(np.int32)
    idx[rng.random(n) < 0.5] = 2
    g = torch.rand(n, 3, generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    ti = torch.from_numpy(idx).to(dev)
    got = sg_ops.packed_gather_bwd(g, ti, 5)
    assert torch.equal(got, sg_ops.packed_gather_bwd(g, ti, 5))
    plain = sg_ops.packed_gather_bwd_plain(g, ti, 5)
    assert ((got - plain).abs() <= 1e-5 * plain.abs()).all()
    emu = sg_ops.packed_gather_bwd_emulated(g[:4096].cpu(), ti[:4096].cpu(), 5)
    assert torch.equal(sg_ops.packed_gather_bwd(g[:4096], ti[:4096], 5).cpu(), emu)
    flat = torch.rand(3 * 4096 + 1, device=dev)
    view = flat[1:].view(4096, 3)             # 4 bytes past a 16-byte boundary
    assert torch.equal(sg_ops.packed_gather_bwd(view, ti[:4096], 5).cpu(),
                       sg_ops.packed_gather_bwd_emulated(view.cpu(), ti[:4096].cpu(), 5))


def test_shade_gather_bwd_glossy_scale(dev, glossy):
    """2^20 lanes of glossy first-hit prims against the float64 plain version
    (1e-5 relative), twice bit-equal; the autograd path through
    `packed_gather` reaches the kernel."""
    pack = shade_pack.build_shade_pack(glossy)
    _, o, d, _ = wf._camera_ray(glossy, torch.arange(1 << 20, device=dev), 3, 256, 256)
    idx = torch.clamp(bvh_ops.intersect_bvh(glossy.bvh, o, d).prim, min=0)
    g = torch.rand(1 << 20, 64, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    got = sg_ops.packed_gather_bwd(g, idx, pack.shape[0])
    assert torch.equal(got, sg_ops.packed_gather_bwd(g, idx, pack.shape[0]))
    plain = sg_ops.packed_gather_bwd_plain(g, idx, pack.shape[0])
    assert ((got - plain).abs() <= 1e-5 * plain.abs()).all()
    table = pack.clone().requires_grad_()
    before = sg_ops.launches["gather_bwd_tile"]
    sg_ops.packed_gather(table, idx).backward(g)
    assert sg_ops.launches["gather_bwd_tile"] == before + 1
    assert torch.equal(table.grad, got)
    with pytest.raises(ValueError):
        sg_ops.packed_gather_bwd(torch.zeros(4, 66, device=dev), idx[:4], 5)


def test_gradient_render_on_card_matches_cpu(dev):
    """mean(render) and its gradient with respect to the Cornell albedos and
    light radiance, and the glossy roughness through the shade pack (which
    runs only on the card; its CPU counterpart is the per-lane path), at
    small sizes: values within 1% and gradients within 1% of the largest
    entry, as the renders above (one sunlit lane that grazes another way is
    1/16384 of the mean)."""
    for make, paths, size in (
            (cornell_box, ["textures.color_a", "lights.radiance"], 32),
            (glossy_scene, ["materials.alpha_u", "materials.alpha_v", "textures.color_a"], 32)):
        out = []
        for device in ("cpu", dev):
            s = with_grad(make(device=device), paths)
            loss = pt.render(s, size, size, 4, 0, pt.PTConfig(max_depth=4, rr_start=99)).mean()
            loss.backward()
            out.append((float(loss.detach()), grads(s, paths)))
        (l_cpu, g_cpu), (l_gpu, g_gpu) = out
        assert abs(l_gpu - l_cpu) <= 1e-2 * abs(l_cpu), (l_gpu, l_cpu)
        for k in paths:
            scale = np.abs(g_cpu[k]).max()
            assert scale > 0 and np.abs(g_gpu[k] - g_cpu[k]).max() <= 1e-2 * scale, k


def _texture_scenes(device):
    """cornell_box_deluxe, the maps case and the Marble sphere of
    tools/texture_cases.py on `device`."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "tools"))
    import texture_cases as tc
    from cudatracerlib_tpu_torch.scene import material_lib
    from cudatracerlib_tpu_torch.scene.scene import Materials, build_scene
    from cudatracerlib_tpu_torch.scene.sensors import Camera
    from cudatracerlib_tpu_torch.scene.shapes import cornell_box_deluxe
    from cudatracerlib_tpu_torch.scene.textures import Textures

    def build(case):
        return tc.build(case, build_scene, Materials, Textures, Camera, device=device)

    return {"deluxe": cornell_box_deluxe(device=device), "maps": build(tc.maps_case()),
            "sss": build(tc.sss_case(material_lib.sss_record))}


def test_textured_renders_on_card_match_cpu(dev):
    """cornell_box_deluxe (the shade pack and the dense kernel, an IMAGE
    normal map), the maps case (an IMAGE albedo through the ray cone, a
    height map with parallax, an alpha-tested quad) and the Marble sphere
    (8 walk steps a bounce) on the card against the CPU at 32x32, 4 spp:
    mean within 1%, rays within 0.1%; the sphere's pass launches depth x
    (1 + walk steps) closest-hit traces."""
    cpu, card = _texture_scenes("cpu"), _texture_scenes(dev)
    for name in cpu:
        cfg = pt.PTConfig(max_depth=4, rr_start=99, sss_steps=8)
        ref, ref_rays = pt.render_counted(cpu[name], 32, 32, 4, 3, cfg)
        before = dict(ops.launches)
        img, rays = pt.render_counted(card[name], 32, 32, 4, 3, cfg)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(img).all()), name
        assert abs(float(img.mean()) - float(ref.mean())) <= 1e-2 * float(ref.mean()), name
        assert abs(int(rays) - int(ref_rays)) <= 1e-3 * int(ref_rays), name
        if name == "sss":
            assert ops.launches["closest"] - before["closest"] == 4 * (1 + 8)


def test_texture_gradients_on_card_match_cpu(dev):
    """mean(render) and its gradient with respect to deluxe's atlas and
    texture colours (each texel fetch's cotangent summed by the backward
    kernels) and the sphere's sss_sigma_s, card against CPU at 32x32, 4 spp:
    the loss within 1%, gradients within 1% of the largest entry."""
    cpu, card = _texture_scenes("cpu"), _texture_scenes(dev)
    for name, paths, cfg in (
            ("deluxe", ["textures.atlas", "textures.color_a"], dict(max_depth=4, rr_start=99)),
            ("sss", ["materials.sss_sigma_s"], dict(max_depth=4, rr_start=99, sss_steps=8))):
        out = []
        for scenes in (cpu, card):
            s = with_grad(scenes[name], paths)
            loss = pt.render(s, 32, 32, 4, 0, pt.PTConfig(**cfg)).mean()
            loss.backward()
            out.append((float(loss.detach()), grads(s, paths)))
        (l_cpu, g_cpu), (l_gpu, g_gpu) = out
        assert abs(l_gpu - l_cpu) <= 1e-2 * abs(l_cpu), (name, l_gpu, l_cpu)
        for k in paths:
            scale = np.abs(g_cpu[k]).max()
            assert scale > 0 and np.abs(g_gpu[k] - g_cpu[k]).max() <= 1e-2 * scale, k


@pytest.mark.parametrize("n,n_px", [(1, 1), (40_000, 256), (5 * 65_536, 128 * 128),
                                    (1 << 20, 512 * 512)])
def test_splat_sum_matches_plain(dev, n, n_px):
    """The splat film's sum on the card (the gather's backward at C = 3):
    within 1e-5 relative of the float64 plain version on positive splats,
    0 where no splat lands, two launches bit-equal; the BDPT splat shape
    (5 x 65,536 onto 128^2) and 2^20 splats onto a 512^2 film, whose
    scratch the wrapper sizes by `bwd_scratch_floats`."""
    from cudatracerlib_tpu_torch.image import film

    rng = np.random.default_rng(n)
    pix = torch.from_numpy(rng.integers(0, n_px, n)).to(dev)
    val = torch.rand(n, 3, generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    before = sg_ops.launches["gather_bwd_tile"]
    got = film.splat_sum(pix, val, n_px)
    again = film.splat_sum(pix, val, n_px)
    torch.cuda.synchronize()
    assert sg_ops.launches["gather_bwd_tile"] == before + 2
    assert torch.equal(got, again) and got.shape == (n_px, 3)
    plain = sg_ops.packed_gather_bwd_plain(val, pix.to(torch.int32), n_px)
    hit = plain > 0
    assert bool((got[~hit] == 0).all())
    assert bool(((got - plain).abs()[hit] <= 1e-5 * plain[hit]).all())
    assert sg_ops.bwd_scratch_floats(3, n, n_px) * 4 < 1 << 30


def test_bvh_kernel_on_bigscene(dev):
    """intersect_bvh on a small bigscene (20,000-triangle target) against
    its oracle on camera rays, closest and any hit, and the bench-config-3
    engine on the card against the CPU at 32x32, 2 spp: mean within 1%,
    rays within 0.1%, both kinds of BVH launches."""
    from cudatracerlib_tpu_torch.scene.bigscene import build_big_scene

    big = build_big_scene(20_000, device=dev)
    _, o, d, _ = wf._camera_ray(big, torch.arange(128 * 128 * 4, device=dev), 3, 128, 128)
    _assert_bvh_agree(big.bvh, o, d, 1e-4, torch.inf)
    cfg = pt.PTConfig(max_depth=5)
    ref, ref_rays = wf.render_wavefront_counted(big.to("cpu"), 32, 32, 2, 3, cfg)
    before = dict(bvh_ops.launches)
    img, rays = wf.render_wavefront_counted(big, 32, 32, 2, 3, cfg)
    torch.cuda.synchronize()
    assert all(bvh_ops.launches[k] > before[k] for k in ("closest", "any_hit"))
    assert abs(float(img.mean()) - float(ref.mean())) <= 1e-2 * float(ref.mean())
    assert abs(int(rays) - int(ref_rays)) <= 1e-3 * int(ref_rays)


def test_bidirectional_engines_on_card_match_cpu(dev):
    """The light tracer, BDPT and VCM on the caustic scene at 32x32, 2 spp
    on the card against the CPU: means within 1%, BDPT's rays within 0.1%;
    each splats through the segment-sum kernel, and BDPT also launches both
    kinds of `intersect_dense` and the shade-pack gather (3,160 rows lie in
    the pack's band)."""
    from cudatracerlib_tpu_torch.render import bdpt, light_tracer, vcm

    cpu, card = caustic_scene(device="cpu"), caustic_scene()
    runs = {"lt": lambda s: (light_tracer.render_light_trace(s, 32, 32, 2048, 3), None),
            "bdpt": lambda s: bdpt.render_bdpt_counted(s, 32, 32, 2, 3),
            "vcm": lambda s: (vcm.render_vcm(s, 32, 32, 2, 3, 1), None)}
    for name, run in runs.items():
        ref, ref_rays = run(cpu)
        before = dict(sg_ops.launches), dict(ops.launches)
        img, rays = run(card)
        torch.cuda.synchronize()
        assert sg_ops.launches["gather_bwd_tile"] == before[0]["gather_bwd_tile"] + 1, name
        assert sg_ops.launches["gather"] > before[0]["gather"], name
        assert ops.launches["closest"] > before[1]["closest"], name
        assert ops.launches["any_hit"] > before[1]["any_hit"], name
        assert img.device.type == "cuda" and bool(torch.isfinite(img).all()), name
        assert abs(float(img.mean()) - float(ref.mean())) <= 1e-2 * float(ref.mean()), name
        if rays is not None:
            assert abs(int(rays) - int(ref_rays)) <= 1e-3 * int(ref_rays)


def test_volume_render_on_card_matches_cpu(dev):
    """Bench config 4's plume in the Cornell box at 64x64, 4 spp, depth 6,
    seed 3 on the card against the CPU port: the media build on the card,
    both kinds of `intersect_dense` launch, and the image mean is within
    7.5% of the CPU's, the rays within 1%. The card's transcendentals round
    otherwise, and a tracking decision one ulp flips on the slowest lane
    moves every later draw (scene/media.py), so the card's render may be
    another sample of the estimator: the gate is three times the mean's
    spread over seeds 3-5 (2.5%, tools/volume_reference_mean.py), as
    chip_smoke.py's phase 18 gates it."""
    from cudatracerlib_tpu_torch.render import volpath
    from cudatracerlib_tpu_torch.scene import media

    runs = []
    for device in ("cpu", "cuda"):
        scene = cornell_box(device=device)
        plume = media.Media.build(media.plume_records(scene.bvh.world_min, scene.bvh.world_max),
                                  device=device)
        before = dict(ops.launches)
        runs.append(volpath.render_vol_counted(scene, plume, 64, 64, 4, 3,
                                               pt.PTConfig(max_depth=6)))
    (ref, ref_rays), (img, rays) = runs
    torch.cuda.synchronize()
    assert ops.launches["closest"] > before["closest"] and ops.launches["any_hit"] > before["any_hit"]
    assert img.device.type == "cuda" and bool(torch.isfinite(img).all())
    assert abs(float(img.mean()) - float(ref.mean())) <= 0.075 * float(ref.mean())
    assert abs(int(rays) - int(ref_rays)) <= 1e-2 * int(ref_rays)


def _grid_corner_rows(dev, n_rays, steps=32, res=32, seed=3):
    """The rows a scalar grid's transmittance lookups read, as scene/media.py
    flattens them: 8 corners of `steps` points along each of `n_rays` random
    rays through a res^3 grid stored from row 1 (row 0: the dummy slot)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    o = torch.rand(n_rays, 1, 3, generator=gen, device=dev) * (res - 1)
    d = torch.nn.functional.normalize(torch.randn(n_rays, 1, 3, generator=gen, device=dev), dim=-1)
    t = (torch.arange(steps, device=dev) + 0.5)[None, :, None]
    q = torch.clamp(o + d * t, 0.0, (res - 1) * (1 - 1e-6))
    i0 = q.floor().long()
    ii = torch.stack([i0, torch.clamp(i0 + 1, max=res - 1)], -1)       # (rays, steps, 3, 2)
    rows = 1 + (ii[..., 0, :, None, None] * res + ii[..., 1, None, :, None]) * res \
        + ii[..., 2, None, None, :]
    return rows.reshape(-1).to(torch.int32), 1 + res ** 3


def test_shade_gather_bwd_grid_shape(dev):
    """The gather backward at a volume grid's shape, reduced: the corner rows
    of 32 steps along 8,192 rays (2^21 lanes x 1 onto 32,769 rows, runs of
    nearby lanes on nearby rows). Signed cotangent: two launches bit-equal,
    rows no lane hit 0, each row within 1e-5 of its sum of |g| from the
    float64 plain version; bit-equal to the emulation of its order on two
    4,096-lane slices; a positive cotangent within 1e-5 relative."""
    idx, n_rows = _grid_corner_rows(dev, 8192)
    n = idx.shape[0]
    g = torch.randn(n, 1, generator=torch.Generator(device=dev).manual_seed(4), device=dev)
    got = sg_ops.packed_gather_bwd(g, idx, n_rows)
    assert torch.equal(got, sg_ops.packed_gather_bwd(g, idx, n_rows))
    plain = sg_ops.packed_gather_bwd_plain(g, idx, n_rows)
    scale = sg_ops.packed_gather_bwd_plain(g.abs(), idx, n_rows)
    hit = torch.bincount(idx.long(), minlength=n_rows) > 0
    assert bool((got[~hit] == 0).all()) and int(hit.sum()) > 10_000
    assert bool(((got - plain).abs() <= 1e-5 * scale).all())
    for a in (0, n // 2 + 77):
        gs, ids = g[a:a + 4096].contiguous(), idx[a:a + 4096]
        assert torch.equal(sg_ops.packed_gather_bwd(gs, ids, n_rows).cpu(),
                           sg_ops.packed_gather_bwd_emulated(gs.cpu(), ids.cpu(), n_rows))
    pos = g.abs()
    got_p = sg_ops.packed_gather_bwd(pos, idx, n_rows)
    plain_p = sg_ops.packed_gather_bwd_plain(pos, idx, n_rows)
    assert bool(((got_p - plain_p).abs() <= 1e-5 * plain_p).all())


@pytest.mark.parametrize("n,n_rows,cols", [(1 << 20, 200_000, 4), (300_000, 70_000, 64),
                                            (655_360, 32_768, 1)])
def test_shade_gather_bwd_bands(dev, n, n_rows, cols):
    """The band kernel's bands of rows (tables past the word-mask rule): a
    table over several bands at C = 4 (200,000 rows) and at C = 64 (70,000
    rows), and the guiding deposit's shape, whose 32 ranges (fewer than the
    SMs) take 9 bands. A fifth of the lanes land on a band's first or last
    row or the row before a band, so rows start on every band edge. Two
    launches bit-equal, bit-equal to the emulation of the order on three
    4,096-lane slices, within 1e-5 relative of the float64 plain version."""
    n_tiles = -(-n // sg_ops.BWD_TILE)
    n_bands, band_rows = sg_ops.bwd_bands(n_tiles, n_rows, cols)
    n_ranges = -(-n_tiles // sg_ops.bwd_range_tiles(n_tiles))
    assert not sg_ops.bwd_word_masks(n_rows, cols)
    assert n_bands > 1 and n_bands * band_rows >= n_rows
    rng = np.random.default_rng(n_rows + cols)
    idx = np.repeat(rng.integers(0, n_rows, n // 8 + 1), 8)[:n].astype(np.int32)
    starts = np.arange(n_bands) * band_rows
    edges = np.unique(np.concatenate([starts, np.maximum(starts - 1, 0),
                                      np.minimum(starts + band_rows - 1, n_rows - 1)]))
    on_edge = rng.random(n) < 0.2
    idx[on_edge] = rng.choice(edges, int(on_edge.sum())).astype(np.int32)
    g = rng.random((n, cols), dtype=np.float32)
    tg, ti = torch.from_numpy(g).to(dev), torch.from_numpy(idx).to(dev)
    got = sg_ops.packed_gather_bwd(tg, ti, n_rows)
    assert torch.equal(got.view(torch.int32),
                       sg_ops.packed_gather_bwd(tg, ti, n_rows).view(torch.int32))
    plain = sg_ops.packed_gather_bwd_plain(tg, ti, n_rows)
    assert bool(((got - plain).abs() <= 1e-5 * plain.abs()).all())
    for a in (0, n // 2 + 77, n - 4096):
        gs, ids = tg[a:a + 4096].contiguous(), ti[a:a + 4096]
        assert torch.equal(sg_ops.packed_gather_bwd(gs, ids, n_rows).cpu(),
                           sg_ops.packed_gather_bwd_emulated(gs.cpu(), ids.cpu(), n_rows))
    if n_rows == 32_768:
        assert n_ranges < 132 and n_bands * n_ranges >= 132


def test_volume_gradient_on_card_matches_cpu(dev):
    """d mean(render_vol) with respect to the plume's grid_data, sigma_a and
    sigma_s (Cornell, 32x32, 2 spp, depth 4, seed 3) on the card against the
    CPU port: the grid's cotangent summed by the backward kernels (their
    launch counts rise), the loss within 1e-4 and every entry within 1e-3
    relative + 1e-3 of the field's largest where the tracking trips agree
    (phase 19's gate), else finite with the CPU's sign on sigma_a."""
    from cudatracerlib_tpu_torch.render import volpath
    from cudatracerlib_tpu_torch.scene import media

    paths = ["grid_data", "sigma_a", "sigma_s"]
    cfg = pt.PTConfig(max_depth=4)
    runs = []
    for device in ("cpu", "cuda"):
        scene = cornell_box(device=device)
        plume = with_grad(media.Media.build(
            media.plume_records(scene.bvh.world_min, scene.bvh.world_max), device=device), paths)
        before = dict(sg_ops.launches)
        loss = volpath.render_vol(scene, plume, 32, 32, 2, 3, cfg).mean()
        loss.backward()
        c = volpath._specialize(scene, plume, cfg)
        _, o, d, _, smp = volpath._camera_batch(scene, 32, 32, 2, 3)
        carry, trips = volpath.init_vol_carry(o, d, smp), []
        with torch.no_grad():
            for k in range(cfg.max_depth):
                s0 = int(carry.sampler.state[0])
                carry = volpath.vol_bounce(scene, plume, c, carry, k)
                trips.append(volpath.tracking_trips(s0, carry.sampler.state[0]))
        runs.append((float(loss.detach()), grads(plume, paths), trips))
    torch.cuda.synchronize()
    assert sg_ops.launches["gather_bwd_tile"] > before["gather_bwd_tile"]
    (ref_loss, ref, ref_trips), (loss, got, trips) = runs
    assert all(np.isfinite(v).all() for v in got.values())
    if trips == ref_trips:
        assert abs(loss - ref_loss) <= 1e-4 * ref_loss
        for p in paths:
            np.testing.assert_allclose(got[p], ref[p], rtol=1e-3, atol=1e-3 * np.abs(ref[p]).max())
    else:
        assert (np.sign(got["sigma_a"]) == np.sign(ref["sigma_a"])).all()


def test_sppm_on_card_matches_cpu(dev):
    """An SPPM pass on the card against the CPU port: the caustic scene
    (32x32, 2^12 photons; its mean within 1e-3, launching intersect_dense
    and packed_gather) and the plume with VOL_BEAMBEAM (32x32, 2^11 photons;
    within 15%, three times the pinned run's spread over seeds, as a flipped
    tracking decision re-draws every lane)."""
    from cudatracerlib_tpu_torch.render import sppm
    from cudatracerlib_tpu_torch.scene import media

    for name, tol in (("caustic", 1e-3), ("plume", 0.15)):
        out = []
        for device in ("cpu", "cuda"):
            if name == "caustic":
                scene, med, vol = caustic_scene(device=device), None, sppm.VOL_NONE
                photons = 1 << 12
            else:
                scene = cornell_box(device=device)
                med = media.Media.build(media.plume_records(scene.bvh.world_min,
                                                            scene.bvh.world_max), device=device)
                vol, photons = sppm.VOL_BEAMBEAM, 1 << 11
            before = (dict(ops.launches), dict(sg_ops.launches))
            img, state = sppm.render_sppm_pass(scene, 32, 32, 3, None,
                                               sppm.SPPMConfig(n_photons=photons,
                                                               vol_estimator=vol), media=med)
            out.append(float(img.mean()))
        torch.cuda.synchronize()
        assert img.device.type == "cuda" and bool(torch.isfinite(img).all())
        assert ops.launches["closest"] > before[0]["closest"]
        assert ops.launches["any_hit"] > before[0]["any_hit"]
        if name == "caustic":
            assert sg_ops.launches["gather"] > before[1]["gather"]
        assert abs(out[1] - out[0]) <= tol * out[0], (name, out)


def test_furnace_plastic_on_card_matches_cpu(dev):
    """A PLASTIC sphere in the furnace (2,208 triangles: the dense kernel
    and, in the pack's band, the shade-pack gather) on the card against the
    CPU at 32x32, 4 spp, depth 4: mean within 1%, rays within 0.1%."""
    from cudatracerlib_tpu_torch.scene import bsdf
    from cudatracerlib_tpu_torch.scene.shapes import furnace_scene

    cfg = pt.PTConfig(max_depth=4)
    ref, ref_rays = pt.render_counted(furnace_scene(albedo=0.8, bsdf_type=bsdf.PLASTIC,
                                                    device="cpu"), 32, 32, 4, 3, cfg)
    before = dict(sg_ops.launches), dict(ops.launches)
    img, rays = pt.render_counted(furnace_scene(albedo=0.8, bsdf_type=bsdf.PLASTIC), 32, 32, 4,
                                  3, cfg)
    torch.cuda.synchronize()
    assert sg_ops.launches["gather"] > before[0]["gather"]
    assert ops.launches["closest"] > before[1]["closest"]
    assert ops.launches["any_hit"] > before[1]["any_hit"]
    assert bool(torch.isfinite(img).all())
    assert abs(float(img.mean()) - float(ref.mean())) <= 1e-2 * float(ref.mean())
    assert abs(int(rays) - int(ref_rays)) <= 1e-3 * int(ref_rays)


def test_gaussian_filtered_cornell_on_card_matches_cpu(dev):
    """The Gaussian-filtered Cornell pass (64x64, 4 spp, depth 4) on the
    card against the CPU: mean within 1%, every pixel within 5% of the
    image's largest; its taps summed in one call of the splat sum."""
    cfg = pt.PTConfig(max_depth=4, rec_filter=1, rec_radius=1.5)
    ref = pt.render(cornell_box(device="cpu"), 64, 64, 4, 3, cfg)
    before = sg_ops.launches["gather_bwd_tile"]
    img = pt.render(cornell_box(), 64, 64, 4, 3, cfg)
    torch.cuda.synchronize()
    assert sg_ops.launches["gather_bwd_tile"] == before + 1
    assert bool(torch.isfinite(img).all())
    assert abs(float(img.mean()) - float(ref.mean())) <= 1e-2 * float(ref.mean())
    assert float((img.cpu() - ref).abs().max()) <= 5e-2 * float(ref.max())


@pytest.mark.parametrize("n,support", [(4096, 1), (1 << 18, 1), (1 << 16, 2)])
def test_filter_splat_sum_matches_plain(dev, n, support):
    """The filtered film's taps (rgb w, w onto the pixels plus the dropped
    row) summed on the card: within 1e-5 relative of the float64 plain
    version where positive, 0 where no tap lands, two launches bit-equal;
    the film equal to the CPU film within 1e-5 relative."""
    from cudatracerlib_tpu_torch.image import film, pipeline

    h, w = 96, 128
    g = torch.Generator(device="cpu").manual_seed(n)
    sx, sy = torch.rand(n, generator=g) * w, torch.rand(n, generator=g) * h
    val = torch.rand(n, 3, generator=g)
    pid, rows = film.filter_taps(sx, sy, val, pipeline.GAUSSIAN, 1.5, support, h, w)
    pid_d, rows_d = pid.to(dev), rows.to(dev)
    got = film.splat_sum(pid_d, rows_d, h * w + 1)
    again = film.splat_sum(pid_d, rows_d, h * w + 1)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and got.shape == (h * w + 1, 4)
    plain = sg_ops.packed_gather_bwd_plain(rows, pid, h * w + 1)
    hit = plain > 0
    got = got.cpu()
    assert bool((got[~hit] == 0).all())
    assert bool(((got - plain).abs()[hit] <= 1e-5 * plain[hit]).all())
    cpu_film = film.add_samples_filtered(film.Film.create(h, w, device="cpu"), sx, sy, val,
                                         pipeline.GAUSSIAN, 1.5, support)
    card_film = film.add_samples_filtered(film.Film.create(h, w, device=dev), sx.to(dev),
                                          sy.to(dev), val.to(dev), pipeline.GAUSSIAN, 1.5, support)
    for f in ("rgb", "weight"):
        a, b = getattr(card_film, f).cpu(), getattr(cpu_film, f)
        assert bool(((a - b).abs() <= 1e-5 * b.abs() + 1e-7).all()), f


def test_filtered_film_at_1024_in_runs(dev):
    """The filtered film at 1024x1024, 16 spp, in the path tracer's sample
    order: one call would take 12.8 GB of the gather backward's scratch
    (its range partials: 576 ranges x 2^20 rows x 4), so the samples go in
    runs, none over SPLAT_SCRATCH_FLOATS, and the film
    equals the float64 plain sum of every tap at once within 1e-5 relative;
    a Gaussian-filtered Cornell pass at that size renders."""
    from cudatracerlib_tpu_torch.image import film, pipeline

    h = w = 1024
    pix = torch.from_numpy(pt.block_order_pixels_np(w, h)).to(dev).repeat(16)
    g = torch.Generator(device=dev).manual_seed(5)
    sx = (pix % w).float() + torch.rand(pix.shape[0], generator=g, device=dev)
    sy = (pix // w).float() + torch.rand(pix.shape[0], generator=g, device=dev)
    val = torch.rand(pix.shape[0], 3, generator=g, device=dev)
    runs = list(film.splat_runs(sy, 9, 1, h, w))
    assert len(runs) > 1
    assert max(sg_ops.bwd_scratch_floats(4, 9 * (b1 - b0), (y1 + 1 - y0) * w + 1)
               for b0, b1, y0, y1 in runs) <= film.SPLAT_SCRATCH_FLOATS
    f = film.add_samples_filtered(film.Film.create(h, w, device=dev), sx, sy, val,
                                  pipeline.GAUSSIAN, 1.5, 1)
    got = torch.cat([f.rgb.reshape(-1, 3), f.weight.reshape(-1, 1)], 1)
    pid, taps = film.filter_taps(sx, sy, val, pipeline.GAUSSIAN, 1.5, 1, h, w)
    plain = sg_ops.packed_gather_bwd_plain(taps, pid, h * w + 1)[:h * w]
    assert bool(((got - plain).abs() <= 1e-5 * plain).all())
    del pid, taps, plain
    cfg = pt.PTConfig(max_depth=5, rec_filter=1, rec_radius=1.5)
    img = pt.render(cornell_box(), w, h, 16, 7, cfg)
    assert img.shape == (h, w, 3) and bool(torch.isfinite(img).all())


# ---- the port's TestFurnace (tests/test_render.py:18-60) at its sizes, on the card ----

def test_port_furnace_diffuse_on_card(dev):
    from cudatracerlib_tpu_torch.scene import bsdf
    from cudatracerlib_tpu_torch.scene.shapes import furnace_scene

    img = pt.render(furnace_scene(albedo=0.7, bsdf_type=bsdf.DIFFUSE), 48, 48, 32, 0,
                    pt.PTConfig(max_depth=6)).cpu().numpy()
    assert abs(img[0:4, 0:4].mean() - 1.0) < 0.02
    assert abs(img[18:30, 18:30].mean() - 0.7) < 0.03
    img = pt.render(furnace_scene(albedo=1.0, bsdf_type=bsdf.DIFFUSE), 32, 32, 32, 0,
                    pt.PTConfig(max_depth=16)).cpu().numpy()
    assert abs(img.mean() - 1.0) < 0.03


@pytest.mark.parametrize("bt,kw", [
    (6, dict(alpha_u=0.3, alpha_v=0.3)), (7, {}), (8, dict(alpha_u=0.3, alpha_v=0.3)), (9, {}),
    (10, dict(alpha_u=0.3, alpha_v=0.3)), (4, dict(alpha_u=0.1, alpha_v=0.1, dist_type=0)),
    (2, {}), (4, dict(alpha_u=0.3, alpha_v=0.3)), (3, {}), (5, {}), (1, dict(alpha_u=0.3)),
])
def test_port_energy_conservation_on_card(dev, bt, kw):
    from cudatracerlib_tpu_torch.scene.shapes import furnace_scene

    spec = 0.2 if bt in (9, 10) else 1.0   # PHONG, WARD: kd + ks <= 1
    img = pt.render(furnace_scene(albedo=0.8, bsdf_type=bt, specular=spec, **kw), 32, 32, 16, 0,
                    pt.PTConfig(max_depth=8)).cpu().numpy()
    assert np.isfinite(img).all()
    assert img.mean() < 1.1, f"type {bt} gains energy: {img.mean()}"
    if bt in (2, 3, 4):   # DIELECTRIC, THINDIELECTRIC, ROUGHDIELECTRIC
        assert img.mean() > 0.85, f"type {bt} loses too much: {img.mean()}"


def _sharded_render_rank(rank, device):
    """One rank of a one-rank job: the sharded Cornell render at 64x64, 16
    spp, depth 5, seed 3, and the group's backend."""
    import torch.distributed as dist

    mesh = shard.make_mesh(1, 1, device=device)
    fn = shard.make_sharded_render(mesh, 64, 64, 16, pt.PTConfig(max_depth=5), with_stats=True)
    img, n_rays = fn(cornell_box(device=device), 3)
    return float(img.mean()), int(n_rays), bool(torch.isfinite(img).all()), dist.get_backend()


def test_sharded_render_one_nccl_rank_matches_cpu(dev):
    (mean, rays, finite, backend), = run_ranks(_sharded_render_rank, 1, device="cuda")
    (mean_c, rays_c, finite_c, _), = run_ranks(_sharded_render_rank, 1, device="cpu")
    assert backend == "nccl" and finite and finite_c
    assert abs(rays - rays_c) <= 1e-3 * rays_c, (rays, rays_c)
    assert abs(mean - mean_c) <= 1e-4 * mean_c, (mean, mean_c)


def _capture_intersects(fn):
    """The dense and BVH wrappers' arguments in one call of `fn`."""
    seen, real_dense, real_bvh = [], ops.intersect_dense, bvh_ops.intersect_bvh

    def dense(woop, o, d, t_min=1e-4, t_max=ops.T_MAX_CLAMP, any_hit=False, boxes=None, *,
              verts):
        seen.append(("dense", woop, o.clone(), d.clone(), t_min, t_max, boxes, verts))
        return real_dense(woop, o, d, t_min, t_max, any_hit=any_hit, boxes=boxes, verts=verts)

    def bvh(b, o, d, t_min=1e-4, t_max=torch.inf, any_hit=False):
        seen.append(("bvh", b, o.clone(), d.clone(), t_min, t_max, None, None))
        return real_bvh(b, o, d, t_min, t_max, any_hit=any_hit)

    ops.intersect_dense, bvh_ops.intersect_bvh = dense, bvh
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        ops.intersect_dense, bvh_ops.intersect_bvh = real_dense, real_bvh
    return seen


def _instanced_spheres(device):
    """Two meshes instanced: a 5,248-triangle sphere (a BLAS above the dense
    band) three times and a floor, built by DynamicScene(instancing=True)."""
    from cudatracerlib_tpu_torch.scene.dynamic import DynamicScene
    from cudatracerlib_tpu_torch.scene.sensors import Camera
    from cudatracerlib_tpu_torch.scene.shapes import quad, sphere

    ds = DynamicScene(device=device)
    ball = ds.create_mesh(sphere([0, 0, 0], 0.5, 42, 64))
    for i in range(3):
        m = np.eye(4)
        m[:3, 3] = [1.2 * (i - 1), 0.3 * i, 0.5]
        ds.create_node(ball, m)
    floor = ds.create_mesh(quad([-3, -3, 0], [3, -3, 0], [3, 3, 0], [-3, 3, 0]))
    ds.create_node(floor, np.eye(4))
    ds.create_light({"type": 5, "radiance": [1.0, 1.0, 1.0]})
    ds.set_camera(Camera.look_at([0, -4, 2.0], [0, 0, 0.4], up=[0, 0, 1], fov_deg=45.0))
    return ds.update(instancing=True)


def test_instanced_scene_kernels_match_plain(dev):
    """Each instance's call of the instance loop (object-space rays, per-lane
    t ranges from the box cull, many empty) through both kernels, against
    their plain versions; and the instanced render on the card against the
    CPU's: mean within 1%, rays within 0.1%."""
    scene = _instanced_spheres(dev)
    assert int(scene.blas[0].bvh.woop.shape[0]) > 4096
    o, d, _, _ = pt.camera_rays(scene, 64, 64, 4, 3)
    seen = _capture_intersects(lambda: pt.render_counted(scene, 64, 64, 4, 3,
                                                         pt.PTConfig(max_depth=2)))
    kinds = {k for k, *_ in seen}
    assert kinds == {"dense", "bvh"}
    for kind, table, o_c, d_c, t_min, t_max, boxes, verts in seen[:4]:   # the camera rays' 4
        assert isinstance(t_max, torch.Tensor) and t_max.shape == (o_c.shape[0],)
        if kind == "dense":
            _assert_agree(table, verts, o_c, d_c, t_min, t_max, boxes)
        elif bool((t_max > t_min).any()):
            _assert_bvh_agree(table, o_c, d_c, t_min, t_max)
    cfg = pt.PTConfig(max_depth=4)
    img, rays = pt.render_counted(scene, 64, 64, 4, 3, cfg)
    ref, ref_rays = pt.render_counted(_instanced_spheres("cpu"), 64, 64, 4, 3, cfg)
    assert abs(float(img.mean()) - float(ref.mean())) <= 0.01 * float(ref.mean())
    assert abs(int(rays) - int(ref_rays)) <= 1e-3 * int(ref_rays)


@pytest.mark.parametrize("n_theta,n_phi", [(24, 48), (64, 128)])
def test_refitted_mesh_kernels_match_plain(dev, n_theta, n_phi):
    """A sphere deformed and refitted on the card (in the dense band, and
    above it): the dense kernel on the refitted chunk boxes and the BVH
    kernel on the refitted nodes against their plain versions, and the
    refitted hits against a rebuilt tree's."""
    from cudatracerlib_tpu_torch.accel import refit
    from cudatracerlib_tpu_torch.accel.traversal import intersect_auto
    from cudatracerlib_tpu_torch.scene.shapes import sphere

    tris = sphere([0, 0, 0], 1.0, n_theta, n_phi).astype(np.float32)
    bvh, host = build_bvh(tris, with_host=True, device=dev)
    plan = refit.build_refit_plan(host["nodes"], host["root"], device=dev)
    leaf = torch.from_numpy(host["tris"]).to(dev)
    bent = leaf * torch.tensor([1.4, 0.7, 1.0], device=dev)
    bent[..., 2] += 0.3 * torch.sin(3.0 * leaf[..., 0])
    new = refit.refit_bvh(bvh, plan, bent)
    rng = np.random.default_rng(9)
    o = torch.from_numpy(rng.uniform(-2, 2, (1 << 16, 3)).astype(np.float32)).to(dev)
    d = torch.nn.functional.normalize(-o + torch.from_numpy(
        rng.normal(scale=0.3, size=(1 << 16, 3)).astype(np.float32)).to(dev), dim=-1)
    if new.woop.shape[0] <= 4096:
        _assert_agree(new.woop, new.tri_verts, o, d, 1e-4, torch.inf, new.chunk_boxes)
    else:
        _assert_bvh_agree(new, o, d, 1e-4, torch.inf)
    rebuilt = build_bvh(bent.cpu().numpy(), device=dev)
    a, b = intersect_auto(new, o, d), intersect_auto(rebuilt, o, d)
    torch.cuda.synchronize()
    agree = (a.valid == b.valid).float().mean()
    both = a.valid & b.valid
    assert agree >= 0.9999 and int(both.sum()) > 1000
    assert float(((a.t - b.t).abs()[both] / b.t[both].abs().clamp(min=1.0)).max()) <= 1e-4



def _tools_on_path():
    """Put tools/ (engines_cases.py, numpy only) on sys.path."""
    import os
    import sys

    tools = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)

def test_spectral_renders_on_card_match_cpu(dev):
    """`render_spectral` on Cornell and the dispersive caustic scene
    (cauchy_c 0.03), 32x32, 4 spp, depth 5, seed 3, and `render_spectral_vol`
    with a homogeneous medium filling the Cornell box: the card's means
    within 1% of the CPU port's (the dense kernel is bit-equal to its plain
    version; the card's transcendentals round otherwise), launching both
    kinds of `intersect_dense`."""
    from cudatracerlib_tpu_torch.render import spectral as sr
    from cudatracerlib_tpu_torch.scene import media

    _tools_on_path()
    import engines_cases as ec

    means = {}
    for device in ("cpu", "cuda"):
        cornell, caustic = cornell_box(device=device), caustic_scene(device=device)
        med = media.Media.build(ec.cornell_medium(cornell), device=device)
        before = dict(ops.launches)
        means[device] = [float(sr.render_spectral(s, 32, 32, 4, 3, pt.PTConfig(max_depth=5)).mean())
                         for s in (cornell, ec.with_cauchy(caustic, ec.DISP_C))]
        means[device].append(float(sr.render_spectral_vol(cornell, med, 32, 32, 4, 3,
                                                          pt.PTConfig(max_depth=5)).mean()))
    torch.cuda.synchronize()
    assert ops.launches["closest"] > before["closest"] and ops.launches["any_hit"] > before["any_hit"]
    for got, ref in zip(means["cuda"], means["cpu"]):
        assert abs(got - ref) <= 0.01 * ref, (means)



def test_spectral_gradient_on_card_matches_cpu(dev):
    """d (ramp-weighted mean) / d cauchy_c on the caustic scene (16x16, 4
    spp, depth 5, rr_start 99, seed 3) on the card within 1% of the CPU
    port's, its cotangents summed by the gather backward's kernels."""
    from cudatracerlib_tpu_torch.render import spectral as sr

    _tools_on_path()
    import engines_cases as ec

    grads_ = {}
    for device in ("cpu", "cuda"):
        caustic = caustic_scene(device=device)
        c = torch.tensor(0.01, device=device, requires_grad=True)
        img = sr.render_spectral(ec.with_cauchy(caustic, c), 16, 16, 4, 3,
                                 pt.PTConfig(max_depth=5, rr_start=99))
        before = sg_ops.launches["gather_bwd_tile"]
        (img * torch.from_numpy(ec.weight_ramp(16)).to(device)).mean().backward()
        grads_[device] = float(c.grad)
    assert sg_ops.launches["gather_bwd_tile"] > before
    assert abs(grads_["cuda"] - grads_["cpu"]) <= 0.01 * abs(grads_["cpu"]), grads_


def test_guiding_on_card_matches_cpu(dev):
    """Guiding on the caustic scene (res 8): the deposit's row sum at its
    shape (2^14 photons x 5 slots x 1 onto 32,768 rows) on the card within
    1e-5 relative of the float64 plain sum, twice bit-equal; a batch trained
    on the card within 1e-4 of the CPU's histogram sum; the guided render
    from the CPU's histogram (32x32, 4 spp) within 1% of the CPU's, through
    the pack gather and both kinds of `intersect_dense`."""
    from cudatracerlib_tpu_torch.render import guided
    from cudatracerlib_tpu_torch.render import ppm as ppm_mod

    cfg_t = pt.PTConfig(max_depth=5, rr_start=2)
    caustic = caustic_scene(device="cuda")
    gd = guided.make_guiding(caustic, res=8)
    pm = ppm_mod.trace_photons(caustic, 1 << 14, 0, pt.specialize_config(caustic, cfg_t))
    flat, lum = guided.deposit_rows(gd, pm)
    g = lum.reshape(-1, 1).contiguous()
    k1 = sg_ops.packed_gather_bwd(g, flat, gd.hist.numel())
    k2 = sg_ops.packed_gather_bwd(g, flat, gd.hist.numel())
    plain = sg_ops.packed_gather_bwd_plain(g, flat, gd.hist.numel())
    assert torch.equal(k1, k2)
    assert float((k1 - plain).abs().max()) <= 1e-5 * float(plain.abs().max())
    gd = guided.train_guiding(caustic, gd, 1 << 14, 0, cfg_t)
    cpu = caustic_scene(device="cpu")
    gd_cpu = guided.train_guiding(cpu, guided.make_guiding(cpu, res=8), 1 << 14, 0, cfg_t)
    assert abs(float(gd.hist.sum()) - float(gd_cpu.hist.sum())) <= 1e-4 * float(gd_cpu.hist.sum())
    moved = gd_cpu._replace(grid=gd.grid, hist=gd_cpu.hist.to("cuda"))
    cfg = pt.PTConfig(max_depth=5, rr_start=99)
    before = dict(sg_ops.launches)
    img = guided.render_guided(caustic, moved, 32, 32, 4, 3, cfg)
    ref = guided.render_guided(cpu, gd_cpu, 32, 32, 4, 3, cfg)
    torch.cuda.synchronize()
    assert sg_ops.launches["gather"] > before["gather"]
    assert abs(float(img.mean()) - float(ref.mean())) <= 0.01 * float(ref.mean())


def test_realtime_and_aovs_on_card_match_cpu(dev, glossy):
    """`render_fast` on the glossy scene (the BVH kernel, 6,624 rows) at
    128x128 against the plain route on the card (image and depth within
    1e-5 on all but 4 pixels); 3 `render_game` frames and `render_aovs` on
    Cornell at 64x64 against the CPU port's means: the frame within 1e-3,
    each AOV channel within 1e-7 (7.3e-8 read on an H100; the watertight
    test decides the pixel-centre rays on a quad's diagonal alike on both
    devices, where the Woop test's crack moved mat_id's mean by 1.8e-3)."""
    from cudatracerlib_tpu_torch.render import prim_tracer, realtime

    img, depth = realtime.render_fast(glossy, 128, 128)
    real = bvh_ops.intersect_bvh
    bvh_ops.intersect_bvh = bvh_ops.intersect_bvh_plain
    try:
        img_p, depth_p = realtime.render_fast(glossy, 128, 128)
    finally:
        bvh_ops.intersect_bvh = real
    off = ((img - img_p).abs().amax(-1) > 1e-5) | ((depth - depth_p).abs() > 1e-5)
    assert int(off.sum()) <= 4
    means = {}
    for device in ("cpu", "cuda"):
        scene = cornell_box(device=device)
        psf = None
        for f in range(3):
            frame, psf = realtime.render_game(scene, psf, 64, 64, f)
        aovs = prim_tracer.render_aovs(scene, 64, 64, 0)
        means[device] = {"frame": float(frame.mean()),
                         **{k: float(v.double().mean()) for k, v in aovs.items()}}
    rel = {k: abs(means["cuda"][k] - ref) / max(abs(ref), 1e-3) for k, ref in means["cpu"].items()}
    assert rel["frame"] <= 1e-3, rel
    assert max(v for k, v in rel.items() if k != "frame") <= 1e-7, rel


def test_transmittance_grid_on_card_matches_cpu(dev):
    """generate_fits' quadrature on a reduced grid (2 x 2 x 3 at 16^2
    strata) on the card within 1e-5 of the CPU's."""
    import numpy as np
    from cudatracerlib_tpu_torch.math import rough_transmittance as rt

    args = (np.asarray([1.3, 1.8]), np.asarray([0.1, 0.45]), np.asarray([0.2, 0.6, 0.95]), 16)
    np.testing.assert_allclose(rt._transmittance_grid(*args, device="cuda"),
                               rt._transmittance_grid(*args, device="cpu"), rtol=0, atol=1e-5)


def test_kernels_watertight_on_crack_rays(dev):
    """Both intersect kernels against the watertight plain test (bit for
    bit) on the rays of the Woop test's crack: Cornell's 256x256
    pixel-centre rays, none through a wall, and rays aimed at the shared
    diagonals of random quads at three scales, each hitting its own quad."""
    _tools_on_path()
    import crack_cases as cc
    from cudatracerlib_tpu_torch.scene import sensors

    def same(a, b):
        v = a.valid & b.valid
        return bool(torch.equal(a.prim, b.prim) and torch.equal(a.t[v], b.t[v])
                    and torch.equal(a.bary[v], b.bary[v]))

    scene = cornell_box(device=dev)
    n = 256
    pid = torch.arange(n * n, device=dev)
    uv = torch.stack([((pid % n).float() + 0.5) / n, ((pid // n).float() + 0.5) / n], -1)
    o, d, _ = sensors.sample_ray(scene.camera, uv, torch.full_like(uv, 0.5))
    b = scene.bvh
    kd = ops.intersect_dense(b.woop, o, d, boxes=b.chunk_boxes, verts=b.tri_verts)
    kb = bvh_ops.intersect_bvh(b, o, d)
    torch.cuda.synchronize()
    assert same(kd, ops.intersect_dense_plain(b.woop, o, d, verts=b.tri_verts))
    assert same(kb, bvh_ops.intersect_bvh_plain(b, o, d))
    covered = torch.from_numpy(cc.through_wall(scene.shading.verts.cpu().numpy(),
                                               o.cpu().numpy(), d.cpu().numpy())).to(dev)
    assert int((covered & ~kd.valid).sum()) == 0 and int((covered & ~kb.valid).sum()) == 0
    for k, scale in enumerate(cc.SCALES):
        tris, qo, qd, quad = cc.diagonal_quads(64, 32, scale, 20 + k)
        woop = torch.from_numpy(woop_transform(tris[:, 0], tris[:, 1], tris[:, 2])).to(dev)
        verts = vertex_rows(torch.from_numpy(tris)).to(dev)
        qo, qd, own = (torch.from_numpy(x).to(dev) for x in (qo, qd, quad))
        hd = ops.intersect_dense(woop, qo, qd, verts=verts)
        qb = build_bvh(tris, device=dev)
        hb = bvh_ops.intersect_bvh(qb, qo, qd)
        torch.cuda.synchronize()
        assert bool(hd.valid.all()) and torch.equal(hd.prim.long() // 2, own)
        assert bool(hb.valid.all()) and torch.equal(qb.tri_index[hb.prim.long()].long() // 2, own)
        assert same(hd, ops.intersect_dense_plain(woop, qo, qd, verts=verts))
        assert same(hb, bvh_ops.intersect_bvh_plain(qb, qo, qd))


def test_mitsuba_scene_on_card_matches_cpu(dev, tmp_path):
    """tools/io_cases.py's media-and-maps XML loaded on the card: its arrays
    equal the CPU load's (the loader runs on the host); render and render_vol
    at 32x32, 4 spp against the CPU port's: means within 1% and 2% (the
    volume's tracking decisions round otherwise on the card)."""
    _tools_on_path()
    import io_cases
    from cudatracerlib_tpu_torch.convert import flatten
    from cudatracerlib_tpu_torch.io.mitsuba import load_mitsuba_full
    from cudatracerlib_tpu_torch.render import volpath

    path = io_cases.write_media_maps(str(tmp_path))
    (sc, mc), (sh, mh) = load_mitsuba_full(path), load_mitsuba_full(path, device="cpu")
    assert sc.bvh.woop.device.type == "cuda" and mc.sigma_s.device.type == "cuda"
    for a, b in ((flatten(sc), flatten(sh)), (flatten(mc), flatten(mh))):
        assert set(a) == set(b)
        for k in a:
            assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes(), k
    cfg = pt.PTConfig(max_depth=5)
    before = dict(ops.launches)
    img, ref = pt.render(sc, 32, 32, 4, 3, cfg), pt.render(sh, 32, 32, 4, 3, cfg)
    vol = volpath.render_vol(sc, mc, 32, 32, 4, 3, pt.PTConfig(max_depth=6))
    vref = volpath.render_vol(sh, mh, 32, 32, 4, 3, pt.PTConfig(max_depth=6))
    torch.cuda.synchronize()
    assert ops.launches["closest"] > before["closest"]
    assert abs(float(img.mean()) - float(ref.mean())) <= 0.01 * float(ref.mean())
    assert abs(float(vol.mean()) - float(vref.mean())) <= 0.02 * float(vref.mean())


@pytest.fixture(scope="module")
def plume_tr_calls(dev):
    """The 'scalar' transmittance calls of a plume pass on the card at
    1024x1024, 1 spp, depth 1 (2^20 lanes each): the sampled segment's of
    `sample_distance` and the shadow rays' (clones of the arguments)."""
    from cudatracerlib_tpu_torch.ops import transmittance as tr_op
    from cudatracerlib_tpu_torch.render import volpath
    from cudatracerlib_tpu_torch.scene import media

    scene = cornell_box(device=dev)
    plume = media.Media.build(media.plume_records(scene.bvh.world_min, scene.bvh.world_max),
                              device=dev)
    calls, real = [], tr_op.transmittance
    keep = lambda x: x.clone() if isinstance(x, torch.Tensor) else x  # noqa: E731

    def record(vol, grid, st, o, d, t_min, t_max):
        calls.append((vol, grid, keep(st), keep(o), keep(d), keep(t_min), keep(t_max)))
        return real(vol, grid, st, o, d, t_min, t_max)

    tr_op.transmittance = record
    try:
        with torch.no_grad():
            volpath.render_vol(scene, plume, 1024, 1024, 1, 3, pt.PTConfig(max_depth=1))
        torch.cuda.synchronize()
    finally:
        tr_op.transmittance = real
    assert len(calls) == 2 and all(c[3].shape == (1 << 20, 3) for c in calls)
    return calls


def test_transmittance_kernel_bit_equal_to_plain(dev, plume_tr_calls):
    """The transmittance kernel against its plain version (the eager path's
    arithmetic) on the plume's segment and shadow rays: the factor and the
    step sum bit-equal; one launch a call."""
    from cudatracerlib_tpu_torch.ops import transmittance as tr_op

    for vol, grid, st, o, d, t_min, t_max in plume_tr_calls:
        before = tr_op.launches["fwd"]
        out, acc = tr_op._forward(vol, grid, st, o, d, t_min, t_max, keep_acc=True)
        torch.cuda.synchronize()
        assert tr_op.launches["fwd"] == before + 1
        ref, ref_acc = tr_op.transmittance_plain(vol, grid, st, o, d, t_min, t_max)
        assert torch.equal(out, ref) and torch.equal(acc, ref_acc)
        assert bool((out < 1).any()) and bool((out == 1).any())


def test_transmittance_backward_on_card(dev, plume_tr_calls):
    """The backward kernel, then the gather backward, against the plain
    closed form on the plume's rays with a seeded cotangent: the grid's and
    st's gradients within 1e-5 of the largest entry; two launches bit-equal;
    one backward launch a call."""
    from cudatracerlib_tpu_torch.ops import transmittance as tr_op

    for k, (vol, grid, st, o, d, t_min, t_max) in enumerate(plume_tr_calls):
        out, acc = tr_op._forward(vol, grid, st, o, d, t_min, t_max, keep_acc=True)
        gen = torch.Generator(device=dev).manual_seed(k)
        g = torch.randn(out.shape, generator=gen, device=dev)
        before = tr_op.launches["bwd"]
        got = tr_op._backward(vol, grid.shape[0], st, o, d, t_min, t_max, g, out, acc)
        again = tr_op._backward(vol, grid.shape[0], st, o, d, t_min, t_max, g, out, acc)
        torch.cuda.synchronize()
        assert tr_op.launches["bwd"] == before + 2
        ref = tr_op.transmittance_bwd_plain(vol, grid.shape[0], st, o, d, t_min, t_max, g, out,
                                            acc)
        for a, b, r in zip(got, again, ref):
            assert torch.equal(a, b)
            assert float((a - r).abs().max()) <= 1e-5 * float(r.abs().max())
        assert float(got[0].abs().max()) > 0


def test_transmittance_gradient_through_media_on_card(dev):
    """d/d(grid_data, sigma_a, sigma_s) of a weighted sum of the plume's
    transmittance on the card (the kernel pair) against the CPU port's eager
    path on the same rays: within 1e-5 of each field's largest entry."""
    from cudatracerlib_tpu_torch.scene import media

    rng = np.random.default_rng(3)
    o = rng.uniform(-1.2, 1.2, (1 << 16, 3)).astype(np.float32)
    d = rng.normal(size=(1 << 16, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = rng.uniform(0.0, 3.0, 1 << 16).astype(np.float32)
    w = rng.normal(size=(1 << 16, 3)).astype(np.float32)
    paths = ["grid_data", "sigma_a", "sigma_s"]
    out = []
    for device in ("cpu", "cuda"):
        m = with_grad(media.Media.build(media.plume_records([-1] * 3, [1] * 3), device=device),
                      paths)
        args = [torch.from_numpy(x).to(device) for x in (o, d, t_max, w)]
        if device == "cpu":
            tr = torch.ones(o.shape[0], 3)
            tr = tr * media._eager_factor(m, 0, "scalar", m.modes, args[0], args[1], 1e-3, args[2])
        else:
            tr = media.transmittance(m, args[0], args[1], 1e-3, args[2], m.modes)
        (tr * args[3]).sum().backward()
        out.append(grads(m, paths))
    for p in paths:
        scale = np.abs(out[0][p]).max()
        assert np.abs(out[1][p] - out[0][p]).max() <= 1e-5 * scale, p


@pytest.mark.parametrize("res", [5, 40])
def test_transmittance_kernel_grid_sizes(dev, res):
    """A grid staged in shared memory (5^3) and one past a block's shared
    memory (40^3 floats, 256 KB: the read-only path), 2^18 random rays:
    the kernel bit-equal to its plain version."""
    from cudatracerlib_tpu_torch.ops import transmittance as tr_op
    from cudatracerlib_tpu_torch.scene import media

    m = media.Media.build(media.plume_records([-1] * 3, [1] * 3, res=res), device=dev)
    gen = torch.Generator(device=dev).manual_seed(res)
    n = 1 << 18
    o = torch.rand(n, 3, generator=gen, device=dev) * 3 - 1.5
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen, device=dev), dim=-1)
    t_max = torch.rand(n, generator=gen, device=dev) * 4
    vol = tr_op.Grid(m.box_min[0], m.box_max[0], m.active[0], m.modes[0][1], m.modes[0][3])
    st = m.sigma_a[0] + m.sigma_s[0]
    out, acc = tr_op._forward(vol, m.grid_data, st, o, d, 1e-3, t_max, keep_acc=True)
    ref, ref_acc = tr_op.transmittance_plain(vol, m.grid_data, st, o, d, 1e-3, t_max)
    assert torch.equal(out, ref) and torch.equal(acc, ref_acc)
    assert bool((out < 1).any())


def _plume_on(dev):
    from cudatracerlib_tpu_torch.scene import media

    scene = cornell_box(device=dev)
    return scene, media.Media.build(media.plume_records(scene.bvh.world_min,
                                                        scene.bvh.world_max), device=dev)


@pytest.fixture(scope="module")
def plume_track_calls(dev):
    """The tracking calls of a plume pass on the card at 1024x1024, 1 spp,
    depth 6 (2^20 lanes each): `delta_track`'s arguments, cloned."""
    from cudatracerlib_tpu_torch.render import volpath
    from cudatracerlib_tpu_torch.scene import media

    scene, plume = _plume_on(dev)
    calls, real = [], media.delta_track
    keep = lambda x: x.clone() if isinstance(x, torch.Tensor) else x  # noqa: E731

    def record(*args):
        calls.append(tuple(keep(a) for a in args))
        return real(*args)

    media.delta_track = record
    try:
        with torch.no_grad():
            volpath.render_vol(scene, plume, 1024, 1024, 1, 3, pt.PTConfig(max_depth=6))
        torch.cuda.synchronize()
    finally:
        media.delta_track = real
    assert len(calls) == 6 and all(c[2].shape == (1 << 20, 3) for c in calls)
    return calls


def test_tracking_kernel_equals_the_eager_loop(dev, plume_track_calls):
    """On each tracking call of the plume pass the kernel's t is bit-equal to
    the eager loop's (called directly), real and T equal; one launch a call."""
    from cudatracerlib_tpu_torch.ops import delta_track as dt_op
    from cudatracerlib_tpu_torch.scene import media

    for k, args in enumerate(plume_track_calls):
        before = dt_op.launches["fwd"]
        t, real, T = media.delta_track(*args)
        c, T_eager = media._track_eager(*args)
        torch.cuda.synchronize()
        assert dt_op.launches["fwd"] == before + 1, k
        assert T.dtype == torch.int64 and T.dim() == 0 and int(T) == int(T_eager) > 0, k
        assert torch.equal(t, c.t) and torch.equal(real, c.real), k
        assert bool(real.any()) and bool((args[7] & ~real).any()), k


def test_volume_render_bit_equal_on_both_tracking_paths(dev, monkeypatch):
    """A 256^2, 2-spp plume image with tracking in the kernel (six launches)
    and in the eager loop (none) is bit-equal."""
    from cudatracerlib_tpu_torch.ops import delta_track as dt_op
    from cudatracerlib_tpu_torch.render import volpath
    from cudatracerlib_tpu_torch.scene import media

    scene, plume = _plume_on(dev)
    cfg = pt.PTConfig(max_depth=6)
    imgs = []
    for kernel in (True, False):
        if not kernel:
            monkeypatch.setattr(media, "_kernel_tracks", lambda o, modes: False)
        before = dt_op.launches["fwd"]
        with torch.no_grad():
            imgs.append(volpath.render_vol(scene, plume, 256, 256, 2, 5, cfg))
        torch.cuda.synchronize()
        assert dt_op.launches["fwd"] == before + (6 if kernel else 0)
    assert bool(torch.isfinite(imgs[0]).all()) and float(imgs[0].mean()) > 0
    assert torch.equal(imgs[0], imgs[1])


def test_tracking_kernel_counters(dev, monkeypatch):
    """Under a profiler, each bounce of a plume pass on the card launches the
    tracking kernel once, reads nothing back for it, runs no eager loop and
    counts as `media.trips` the T its lanes' sampler states imply."""
    from torch.profiler import ProfilerActivity, profile

    from cudatracerlib_tpu_torch.render import volpath
    from cudatracerlib_tpu_torch.utils import timing

    scene, plume = _plume_on(dev)
    seen, inner = [], volpath.vol_bounce

    def bounce(scene, media, config, carry, depth):
        before = int(carry.sampler.state[0])
        timing.reset_counters()
        out = inner(scene, media, config, carry, depth)
        seen.append((before, int(out.sampler.state[0]), timing.counters(profiled=True)))
        return out

    monkeypatch.setattr(volpath, "vol_bounce", bounce)
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        volpath.render_vol(scene, plume, 256, 256, 2, 7, pt.PTConfig(max_depth=6))
    assert len(seen) == 6
    for before, after, c in seen:
        T = volpath.tracking_trips(before, after)
        assert c["launches.delta_track.fwd"] == 1 and c["media.track_calls"] == 1
        assert c.get("host_reads.media.delta_track", 0) == 0
        assert c.get("media.track.eager", 0) == 0
        assert c["media.trips"] == T
    assert max(volpath.tracking_trips(b, a) for b, a, _ in seen) > 0


VOL4_W, VOL4_SPP, VOL4_SEED, VOL4_LEAVES = 64, 4, 5, ("grid_data", "sigma_a", "sigma_s")


def _plume_parts(device):
    """The plume of perfbench/configs/plume.json as the program's scene,
    media and config, and an L2 target."""
    import json
    import os

    from perfbench.core import port
    from perfbench.scenes import plume

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "perfbench", "configs", "plume.json")) as f:
        data = plume.build(json.load(f))
    target = torch.full((VOL4_W, VOL4_W, 3), 0.1, device=device)
    return port.scene(data, device), port.media(data, device), port.config(data), target


def _sharded_vol_step_rank(rank, device):
    """One rank of a four-rank job: the sharded volume step's summed
    gradient and the group's backend."""
    import torch.distributed as dist

    sc, med, cfg, target = _plume_parts(device)
    mesh = shard.make_mesh(4, 1, device=device)
    leaves = {k: getattr(med, k).detach().clone().requires_grad_() for k in VOL4_LEAVES}
    img = shard.make_sharded_render_vol(mesh, VOL4_W, VOL4_W, VOL4_SPP, cfg)(
        sc, med._replace(**leaves), VOL4_SEED)
    ((img - target) ** 2).mean().backward()
    shard.all_reduce_grads(leaves.values())
    return {k: v.grad.cpu().numpy() for k, v in leaves.items()}, dist.get_backend()


def test_sharded_volume_step_on_four_nccl_ranks(dev):
    from cudatracerlib_tpu_torch.render import volpath

    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs four cards ({torch.cuda.device_count()} present)")
    runs = run_ranks(_sharded_vol_step_rank, 4, device="cuda")
    assert all(backend == "nccl" for _, backend in runs)
    for grads, _ in runs[1:]:
        for k in VOL4_LEAVES:
            np.testing.assert_array_equal(grads[k], runs[0][0][k])
    sc, med, cfg, target = _plume_parts(dev)
    cfg = volpath._specialize(sc, med, cfg)
    leaves = {k: getattr(med, k).detach().clone().requires_grad_() for k in VOL4_LEAVES}
    m = VOL4_W * VOL4_W // 4
    parts = []
    for r in range(4):   # rank r's block, traced as its own batch
        pix = torch.arange(r * m, (r + 1) * m, device=dev).repeat(VOL4_SPP)
        smp = torch.arange(VOL4_SPP, device=dev).repeat_interleave(m)
        L = volpath.lane_radiance(sc, med._replace(**leaves), pix, smp, VOL4_W, VOL4_W, VOL4_SEED,
                                  cfg)
        parts.append(volpath.sample_sum(L, VOL4_SPP, m))
    img = (torch.cat(parts) / VOL4_SPP).reshape(VOL4_W, VOL4_W, 3)
    ((img - target) ** 2).mean().backward()
    for k in VOL4_LEAVES:
        want = leaves[k].grad.cpu().numpy()
        assert np.abs(want).max() > 0, k
        np.testing.assert_allclose(runs[0][0][k], want, rtol=0, atol=1e-5 * np.abs(want).max())
