"""Multi-rank rendering and training: the port's parallel/ against the JAX
package's parallel/shard.py on the CPU (the conftest's 8-device CPU mesh),
at 16x16 and depth 3.

The port's ranks are spawned gloo CPU processes that import nothing of JAX.
One module fixture starts every local job at once (4 ranks: the sharded
render on a 2 x 2 mesh and the train step on 4 x 1; 1 rank: both on 1 x 1;
2 ranks: the sharded PPM pass on 2 x 1; 2 ranks: `dryrun_multichip`; 2
ranks whose rank 1 raises) while the JAX references compile.

Tolerances, stated once:
  * sharded render against JAX's `make_sharded_render` on make_mesh(2, 2),
    the same specialized config and seed: every pixel within 1e-4 relative
    + 1e-6 (the same lanes; float32 sums in another order), rays within
    1e-3 (equal measured);
  * the port on 1 rank against 4: every pixel within 1e-6 relative + 1e-7
    (only the film's summation order differs), rays equal;
  * train step, 2 steps, 4 ranks against 1 rank against JAX's
    `make_train_step` on make_mesh(4, 1): losses within 1e-5 relative;
    parameters after each step within 1e-5 relative + 1e-7, and each step's
    update (lr times the summed gradient) within 1e-3 relative + 1e-8 of
    JAX's on 1 and 4 ranks alike: a gradient scaled by the rank count
    would miss it by 300%;
  * sharded PPM on 2 ranks against JAX's `make_sharded_ppm` on a 2-device
    mesh, 4,096 photons: every pixel within 1e-3 relative + 1e-6, the image
    sums within 1e-5 relative (as tests/test_torch_ppm.py's query-major
    render);
  * the sharded volume render (`make_sharded_render_vol`, the plume of
    perfbench/configs/plume.json at depth 3, 4 spp, which the JAX package
    does not shard): on 1 x 1 equal to `render_vol` bit for bit, image and
    gradient; on 4 x 1, each rank's lanes those of
    perfbench/reference/volume_sharded.py, every lane once over the ranks,
    each rank's pixels within 1e-4 relative + 1e-6 of the reference's on the
    same lanes (the perfbench cells' CPU agreement is 3.4e-5) and the summed
    gradients within 1e-4 relative of the largest entry of each leaf, equal
    bit for bit on every rank.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import inspect
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.multiprocessing import ProcessRaisedException

from cudatracerlib_tpu_torch import entry as tentry
from cudatracerlib_tpu_torch.parallel import distributed as tdist
from cudatracerlib_tpu_torch.parallel import shard as tshard
from cudatracerlib_tpu_torch.render import path_tracer as tpt
from cudatracerlib_tpu_torch.render import ppm as tppm
from cudatracerlib_tpu_torch.render import volpath as tvol
from cudatracerlib_tpu_torch.scene import shapes as tshapes

W = H = 16
DEPTH = 3
RENDER_SPP, RENDER_SEED = 4, 3
TRAIN_SPP, TRAIN_SEEDS, LR, ALBEDO_SCALE = 4, (100, 101), 0.05, 0.5
PPM_SPP, PPM_SEED, PPM_PASS, PPM_PHOTONS = 2, 3, 1, 4096
VOL_SPP, VOL_SEED, VOL_DEPTH, VOL_LEAVES = 4, 5, 3, ("grid_data", "sigma_a", "sigma_s")
RANK_TIMEOUT_S = 240.0

# local jobs of the port: world size -> (job, n_dp, n_sp) in order
JOBS = {4: (("render", 2, 2), ("train", 4, 1), ("vol", 4, 1)),
        1: (("render", 1, 1), ("train", 1, 1), ("vol", 1, 1)),
        2: (("ppm", 2, 1),)}


def _target():
    return np.random.default_rng(0).uniform(0.0, 0.3, (H, W, 3)).astype(np.float32)


def _plume_data():
    """The plume's scene arrays (perfbench's generator and configuration) at
    depth VOL_DEPTH."""
    from perfbench.scenes import plume

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "perfbench", "configs", "plume.json")) as f:
        cfg = json.load(f)
    return plume.build(dict(cfg, max_depth=VOL_DEPTH))


def _vol_job(rank, device, mesh, n_dp, n_sp):
    """The sharded volume render and its summed gradient on this rank, and
    the plain reference's on the lanes its own rule gives the rank."""
    from perfbench.core import port
    from perfbench.reference import volume_sharded as vs
    from perfbench.reference.common import RefScene

    data = _plume_data()
    sc, med, cfg = port.scene(data, device), port.media(data, device), port.config(data)
    target = torch.from_numpy(_target())
    leaves = {k: getattr(med, k).detach().clone().requires_grad_() for k in VOL_LEAVES}
    img = tshard.make_sharded_render_vol(mesh, W, H, VOL_SPP, cfg)(sc, med._replace(**leaves),
                                                                    VOL_SEED)
    ((img - target) ** 2).mean().backward()
    tshard.all_reduce_grads(leaves.values())
    pix, smp = tshard._shard_lanes(mesh, W, H, VOL_SPP, device)
    out = {"img": img.detach().numpy(), "grads": {k: v.grad.numpy() for k, v in leaves.items()},
           "lanes": (pix.numpy(), smp.numpy())}
    if n_dp * n_sp == 1:
        plain = {k: getattr(med, k).detach().clone().requires_grad_() for k in VOL_LEAVES}
        pimg = tvol.render_vol(sc, med._replace(**plain), W, H, VOL_SPP, VOL_SEED, cfg)
        ((pimg - target) ** 2).mean().backward()
        out["plain"] = (pimg.detach().numpy(), {k: v.grad.numpy() for k, v in plain.items()})

    rpix, rsmp = vs.rank_lanes(n_dp, n_sp, rank, W, H, VOL_SPP, device)
    rs = RefScene(data, device)
    p = {k: getattr(med, k).detach().clone().requires_grad_() for k in VOL_LEAVES}
    rmed = vs.medium(data["media"][0], device, params=p)
    L, skips = vs.radiance_whole(rs, rmed, rpix, rsmp, W, H, VOL_SEED, 4096)
    part = torch.zeros(W * H, 3, dtype=torch.float64).index_add_(0, rpix, L.double()) / VOL_SPP
    whole = part.clone()
    dist.all_reduce(whole)
    cot = (2.0 / whole.numel() * (whole - target.reshape(-1, 3).double()))[rpix].float() / VOL_SPP
    g = vs.lane_gradient(rs, rmed, p, rpix, rsmp, W, H, VOL_SEED, 4096, skips, cot, 100)
    flat = torch.cat([g[k].reshape(-1) for k in VOL_LEAVES])
    dist.all_reduce(flat)
    out["ref"] = {"lanes": (rpix.numpy(), rsmp.numpy()), "part": part.reshape(H, W, 3).numpy(),
                  "grads": {k: x.view_as(p[k]).numpy() for k, x in
                            zip(VOL_LEAVES, flat.split([p[k].numel() for k in VOL_LEAVES]))}}
    return out


def _rank_program(rank, device, jobs):
    """One port rank: the results of `jobs` as numpy, from this rank."""
    out = {}
    for job, n_dp, n_sp in jobs:
        mesh = tshard.make_mesh(n_dp, n_sp, device=device)
        if job == "vol":
            out[job] = _vol_job(rank, device, mesh, n_dp, n_sp)
            continue
        if job == "ppm":
            scene = tshard.replicate_scene(tshapes.caustic_scene(device=device), mesh)
            fn = tshard.make_sharded_ppm(mesh, W, H, PPM_SPP,
                                         tppm.PPMConfig(n_photons=PPM_PHOTONS))
            out[job] = fn(scene, PPM_SEED, tppm.progressive_radius(0.07, PPM_PASS)).numpy()
            continue
        scene = tshard.replicate_scene(tshapes.cornell_box(device=device), mesh)
        if job == "render":
            fn = tshard.make_sharded_render(mesh, W, H, RENDER_SPP, tpt.PTConfig(max_depth=DEPTH),
                                            with_stats=True)
            img, n_rays = fn(scene, RENDER_SEED)
            out[job] = (img.numpy(), int(n_rays))
        else:
            step = tshard.make_train_step(mesh, W, H, TRAIN_SPP, torch.from_numpy(_target()),
                                          lr=LR, config=tpt.PTConfig(max_depth=DEPTH, rr_start=99))
            s = scene._replace(textures=scene.textures._replace(
                color_a=scene.textures.color_a * ALBEDO_SCALE))
            steps = []
            for seed in TRAIN_SEEDS:
                s, loss = step(s, seed)
                steps.append((float(loss), s.textures.color_a.numpy(), s.lights.radiance.numpy()))
            out[job] = steps
    return out


def _failing_rank(rank, device):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    tdist.sync_hosts(timeout=60.0)


@pytest.fixture(scope="module")
def port():
    """Futures of every local job of the port, started together."""
    with ThreadPoolExecutor(len(JOBS) + 2) as pool:
        futs = {n: pool.submit(tdist.run_ranks, _rank_program, n, (jobs,), device="cpu",
                               timeout=RANK_TIMEOUT_S) for n, jobs in JOBS.items()}
        futs["dryrun"] = pool.submit(tentry.dryrun_multichip, 2, device="cpu")
        futs["failing"] = pool.submit(tdist.run_ranks, _failing_rank, 2, device="cpu",
                                      timeout=RANK_TIMEOUT_S)
        yield futs


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's sharded render, train step and PPM pass (numpy)."""
    import jax.numpy as jnp

    from cudatracerlib_tpu.parallel import shard as jshard
    from cudatracerlib_tpu.render import path_tracer as jpt
    from cudatracerlib_tpu.render import ppm as jppm
    from cudatracerlib_tpu.scene.shapes import caustic_scene, cornell_box

    js = cornell_box()
    out = {}
    mesh = jshard.make_mesh(2, 2)
    fn = jshard.make_sharded_render(mesh, W, H, RENDER_SPP,
                                    jpt.specialize_config(js, jpt.PTConfig(max_depth=DEPTH)),
                                    with_stats=True)
    img, n_rays = fn(jshard.replicate_scene(js, mesh), jnp.uint32(RENDER_SEED))
    out["render"] = (np.asarray(img), int(n_rays))

    mesh = jshard.make_mesh(4, 1)
    cfg = jpt.specialize_config(js, jpt.PTConfig(max_depth=DEPTH, rr_start=99))
    step = jshard.make_train_step(mesh, W, H, TRAIN_SPP, jnp.asarray(_target()), lr=LR, config=cfg)
    s = jshard.replicate_scene(js, mesh)
    s = s._replace(textures=s.textures._replace(color_a=s.textures.color_a * ALBEDO_SCALE))
    steps = []
    for seed in TRAIN_SEEDS:
        s, loss = step(s, jnp.uint32(seed))
        steps.append((float(loss), np.asarray(s.textures.color_a), np.asarray(s.lights.radiance)))
    out["train"] = steps
    out["start"] = (np.asarray(js.textures.color_a) * np.float32(ALBEDO_SCALE),
                    np.asarray(js.lights.radiance))

    mesh = jshard.make_mesh(2, 1)
    jc = caustic_scene()
    fn = jshard.make_sharded_ppm(mesh, W, H, PPM_SPP, jppm.PPMConfig(n_photons=PPM_PHOTONS))
    radius = jppm.progressive_radius(jnp.float32(0.07), jnp.float32(PPM_PASS))
    out["ppm"] = np.asarray(fn(jshard.replicate_scene(jc, mesh), jnp.uint32(PPM_SEED), radius))
    return out


def test_single_process_starts_no_group(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    assert tdist.init_distributed(device="cpu") is False
    assert not dist.is_initialized()
    topo = tdist.process_topology()
    assert (topo["process_index"], topo["process_count"], topo["global_devices"]) == (0, 1, 1)
    tdist.sync_hosts()  # a no-op
    with pytest.raises(RuntimeError, match="init_distributed"):
        tdist.host_mesh(device="cpu")


def test_entry_points_default_to_the_card():
    for fn in (tdist.init_distributed, tdist.host_mesh, tdist.run_ranks, tshard.make_mesh,
               tentry.dryrun_multichip):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__


def test_sharded_render_matches_jax(port, jax_refs):
    (got, n_got), *rest = (r["render"] for r in port[4].result())
    want, n_want = jax_refs["render"]
    assert got.shape == want.shape == (H, W, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert abs(n_got - n_want) <= 1e-3 * n_want
    for img, n in rest:  # every rank holds the summed film
        np.testing.assert_array_equal(img, got)
        assert n == n_got


def test_sharded_render_one_rank_equals_four(port):
    four, n_four = port[4].result()[0]["render"]
    one, n_one = port[1].result()[0]["render"]
    np.testing.assert_allclose(one, four, rtol=1e-6, atol=1e-7)
    assert n_one == n_four and one.mean() > 0.05


@pytest.mark.parametrize("n_ranks", [1, 4])
def test_train_step_matches_jax(port, jax_refs, n_ranks):
    """Two SGD steps: the losses, the parameters and each step's update
    against JAX's; the update pins the gradient's scale."""
    runs = [r["train"] for r in port[n_ranks].result()]
    for other in runs[1:]:  # the same loss and parameters on every rank
        for (l0, ca0, rad0), (l1, ca1, rad1) in zip(runs[0], other):
            assert l0 == l1
            np.testing.assert_array_equal(ca0, ca1)
            np.testing.assert_array_equal(rad0, rad1)
    before = jax_refs["start"]
    for (loss, ca, rad), (jl, jca, jrad) in zip(runs[0], jax_refs["train"]):
        assert np.isfinite(loss) and abs(loss - jl) <= 1e-5 * jl
        for got, want, prev in ((ca, jca, before[0]), (rad, jrad, before[1])):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
            step_j = want - prev
            assert np.abs(step_j).max() > 1e-4   # the step moved the parameters
            np.testing.assert_allclose(got - prev, step_j, rtol=1e-3, atol=1e-8)
        before = (jca, jrad)


def test_train_step_one_rank_equals_four(port):
    one = port[1].result()[0]["train"]
    four = port[4].result()[0]["train"]
    for (l1, ca1, rad1), (l4, ca4, rad4) in zip(one, four):
        assert abs(l1 - l4) <= 1e-6 * l4
        np.testing.assert_allclose(ca1, ca4, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(rad1, rad4, rtol=1e-6, atol=1e-8)


def test_sharded_ppm_matches_jax(port, jax_refs):
    imgs = [r["ppm"] for r in port[2].result()]
    want = jax_refs["ppm"]
    got = imgs[0]
    assert got.shape == want.shape == (H, W, 3) and np.isfinite(got).all()
    np.testing.assert_array_equal(imgs[1], got)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6)
    assert abs(got.sum() - want.sum()) <= 1e-5 * abs(want.sum())
    assert want.mean() > 0.1


def test_dryrun_multichip(port):
    loss = port["dryrun"].result()
    assert np.isfinite(loss) and loss > 0


def test_failed_rank_fails_with_its_traceback(port):
    err = port["failing"].exception()
    assert isinstance(err, RuntimeError) and isinstance(err.__cause__, ProcessRaisedException)
    msg = str(err)
    assert msg.startswith("rank 1:") and "_failing_rank" in msg, msg
    assert "rank 1 fails on purpose" in msg.split("rank 0:")[0], msg


def test_sharded_vol_one_rank_equals_render_vol(port):
    vol = port[1].result()[0]["vol"]
    pimg, pgrads = vol["plain"]
    assert vol["img"].mean() > 0.05 and np.isfinite(vol["img"]).all()
    np.testing.assert_array_equal(vol["img"], pimg)
    for k in VOL_LEAVES:
        assert np.abs(pgrads[k]).max() > 0, k
        np.testing.assert_array_equal(vol["grads"][k], pgrads[k])


def test_sharded_vol_blocks_cover_every_lane_once(port):
    """The four ranks' lanes are the reference's rule's, and together hold
    every (pixel, sample) of the pass exactly once."""
    runs = [r["vol"] for r in port[4].result()]
    keys = []
    for vol in runs:
        (pix, smp), (rpix, rsmp) = vol["lanes"], vol["ref"]["lanes"]
        np.testing.assert_array_equal(pix, rpix)
        np.testing.assert_array_equal(smp, rsmp)
        keys.append(smp * (W * H) + pix)
    np.testing.assert_array_equal(np.sort(np.concatenate(keys)), np.arange(W * H * VOL_SPP))


def test_sharded_vol_matches_reference(port):
    """Each rank's pixels of the summed image against the reference's on the
    rank's own lanes, and the summed gradients against the reference's."""
    runs = [r["vol"] for r in port[4].result()]
    for rank, vol in enumerate(runs):
        rows = slice(rank * H // 4, (rank + 1) * H // 4)
        ref = vol["ref"]["part"]
        assert not ref[:rows.start].any() and not ref[rows.stop:].any()
        np.testing.assert_allclose(vol["img"][rows], ref[rows], rtol=1e-4, atol=1e-6)
        for k in VOL_LEAVES:
            want = vol["ref"]["grads"][k]
            assert np.abs(want).max() > 0, k
            np.testing.assert_allclose(vol["grads"][k], want, rtol=0,
                                       atol=1e-4 * np.abs(want).max())


def test_sharded_vol_gradient_same_on_every_rank(port):
    runs = [r["vol"] for r in port[4].result()]
    for vol in runs[1:]:
        np.testing.assert_array_equal(vol["img"], runs[0]["img"])
        for k in VOL_LEAVES:
            np.testing.assert_array_equal(vol["grads"][k], runs[0]["grads"][k])
