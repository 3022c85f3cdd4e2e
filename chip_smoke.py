#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments: `python3 chip_smoke.py`.
It imports nothing of JAX. Phases, each of which raises on failure:

  1. device: the card's name and power limit (nvidia-smi), the device count;
  2. build: the four CUDA kernels (nvcc, sm_90a, one process per source,
     all started together) and the SBVH builder (g++) from the sources in
     the checkout, each timed;
  3. kernel vs plain, `intersect_dense`: against its plain PyTorch version
     on the same CUDA tensors, closest-hit and any-hit, at the Cornell path's
     shapes (60 Woop rows vs the camera rays and first-bounce rays of a
     256x256, 16-spp pass) and at the top of the dense band (a random
     4096-triangle soup vs 2^20 random rays). Tolerance: `valid` agrees on
     >= 99.999% of rays and every disagreement is edge-grazing; on rays both
     hit at equal Woop rows, t within 1e-4 * max(1, t) and the barycentrics
     within 1e-4. Both versions are timed with CUDA events;
  4. Cornell path: the Cornell box at bench config 1 (256x256, 16 spp, depth
     5), built on the card by default: one counted pass at seed 3, whose
     image mean must be within 0.5% of 0.13256 (the JAX package's CPU value,
     pinned by tests/test_torch_render.py), then 5 passes through
     `render_progressive`, timed. The launch counts are reset just before
     those 5 passes, read just after, and must show closest-hit and
     shadow-ray launches of `intersect_dense`;
  5. kernel vs plain, `intersect_bvh`: against its plain version (the
     lockstep oracle) with the tolerances of 3, closest-hit and any-hit, on
     the glossy scene's camera rays of a 256x256, 16-spp pass (2^20) and
     their first-bounce rays, and on a random 65,536-triangle soup vs 2^20
     random rays (a deep tree). The oracle also counts node and leaf visits
     and the leaf rows that pass the t test, from which the kernel's bound
     is computed;
  6. kernel vs plain, `packed_gather`: the glossy shade pack at the first-hit
     prims of those 2^20 camera rays, plus indices out of range on purpose;
     the output must be bit-equal to `table[idx.clamp(0, Tr - 1)]`. The
     kernel, the plain version and `torch.index_select` are timed on the
     main path's indices;
  7. glossy path (bench config 2): `render_wavefront_counted` on the glossy
     scene at 128x128, 8 spp, depth 5, seed 3, whose mean must be within 1%
     of the JAX package's CPU value below; then 256x256 at 80 spp (16 spp x 5
     passes pooled), depth 5, warm at seed 0 and timed at seed 7. The launch
     counts are reset just before the timed render, read just after, and
     must show both kinds of `intersect_bvh` launches and `packed_gather`
     launches;
  8. kernel vs plain, `photon_density`: on the photon tiles and cell-sorted
     gather queries of one bench-config-5 PPM pass (both photon maps,
     captured from the warm seed-0 pass of 9), and on a synthetic hotspot
     where every query has thousands of photons within the radius. Every
     sum within 1e-4 relative (+1e-6 of the largest): the per-pair weights
     are bit-equal, the sums run in another order; invalid queries 0. Kernel
     and plain version timed with CUDA events; the bound counts the
     (query, photon) pairs of the tiles that survive the cull;
  9. PPM path (bench config 5's PPM half, `render_ppm_pass` on the caustic
     scene, built on the card by default): a pinned pass (64x64, 4 spp,
     2^15 photons, seed 3, pass 1) whose mean must be within 0.1% of the
     JAX package's CPU value below, then 128x128, 4 spp, `PPMConfig()`
     (2^17 photons, depth 6), pass 1, warm at seed 0 and timed at seed 7.
     Rays are counted as bench.py counts them: the photon walk's rays
     (`trace_photons` with_stats, seed 3) plus W*H*spp camera rays. The
     launch counts are reset just before the timed pass, read just after,
     and must show `photon_density`, both kinds of `intersect_dense`
     launches and `packed_gather`;
  10. profile: `torch.profiler` over one Cornell pass, one bench-config-2
     glossy render and one bench-config-5 PPM pass: wall, device kernel
     time, busy share, kernel launches, the top kernels by device time, and
     the port's own kernels' launches and shares.

Before its last line it prints one JSON object describing each kernel; the
last line is {"ok": true, "device": {...}}. Without a CUDA device, or without
the port package beside it, it exits non-zero and prints no result.
"""
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REF_MEAN_SEED3 = 0.13256   # JAX CPU render_counted(cornell, 256, 256, 16, seed 3, depth 5)
# JAX package on the CPU, computed once with
#   JAX_PLATFORMS=cpu python -c "from cudatracerlib_tpu.scene.shapes import glossy_scene;
#   from cudatracerlib_tpu.render.path_tracer import PTConfig;
#   from cudatracerlib_tpu.render.wavefront import render_wavefront_counted as r;
#   print(r(glossy_scene(), 128, 128, 8, 3, PTConfig(max_depth=5)))"
# -> mean 0.166997, 507,368 rays
REF_GLOSSY_MEAN = 0.166997
GLOSSY_PIN = dict(width=128, height=128, spp=8, seed=3)
GLOSSY_TOL = 0.01
# JAX package on the CPU with the neighbour cap lifted above every query's
# candidate count (max_gather 891), so the estimate is exhaustive like the
# port's kernel; computed once with
#   JAX_PLATFORMS=cpu python tools/ppm_reference_mean.py
# -> mean 0.326837 (render_ppm_pass(caustic_scene(), 64, 64, 4, seed 3,
#    pass 1, PPMConfig(n_photons=2**15)))
REF_PPM_MEAN = 0.326837
PPM_PIN = dict(width=64, height=64, spp=4, seed=3, pass_idx=1, n_photons=1 << 15)
PPM_TOL = 1e-3            # the CPU port's photon-major render agrees to 1e-6
PPM_W = PPM_H = 128        # bench config 5 (bench.py:289-340)
PPM_SPP, PPM_PASS = 4, 1
DENSITY_RTOL, DENSITY_ATOL = 1e-4, 1e-6
W = H = 256
SPP, DEPTH, N_PASS = 16, 5, 5
SOUP_RAYS = 1 << 20
SOUP_TRIS = 65536          # the deep-tree soup of phase 5
VALID_AGREE = 0.99999
ERR_TOL = 1e-4
# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# operations per unit of work, counted from the kernels' sources (a min,
# max or compare counts as one, as a multiply or an add does)
FLOPS_DENSE_PAIR = 30      # one ray / Woop-row test, t and u, v
FLOPS_BVH_INNER = 50       # two slab tests
FLOPS_WOOP_T = 17          # per leaf row: t and its test
FLOPS_WOOP_UV = 31         # per leaf row that passed the t test: u, v and their tests
FLOPS_PHOTON_PAIR = 32     # per (query, photon) pair of a surviving tile (an FMA counts two)
LEAF_SIZE = 4
PORT_KERNELS = ("dense_kernel", "bvh_kernel", "gather_kernel",
                "photon_kernel")  # __global__ names in csrc/


def _require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _time_ms(fn, reps):
    import torch

    fn()  # warm
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(flops, nbytes):
    """(bound_ms, bound_by): the larger of the two times at the card's peaks."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _check_hits(label, mode, r, t_scale):
    print(f"[kernel vs plain] {label} {mode}: {json.dumps(r)}")
    _require(r["valid_mismatch"] <= (1.0 - VALID_AGREE) * r["rays"],
             f"{label} {mode}: valid disagrees on {r['valid_mismatch']} of {r['rays']} rays")
    _require(r["valid_mismatch_not_grazing"] == 0,
             f"{label} {mode}: {r['valid_mismatch_not_grazing']} non-grazing valid mismatches")
    _require(r["hits"] > 0, f"{label} {mode}: no ray hit anything")
    if mode == "closest":
        _require(r["prim_mismatch_not_grazing"] == 0,
                 f"{label}: {r['prim_mismatch_not_grazing']} non-grazing prim mismatches")
        _require(r["max_abs_err_t"] <= ERR_TOL * t_scale and r["max_abs_err_bary"] <= ERR_TOL,
                 f"{label}: t/bary error {r['max_abs_err_t']}/{r['max_abs_err_bary']}")
        return max(r["max_abs_err_t"], r["max_abs_err_bary"])
    return 0.0


def _compare(label, woop, o, d, t_min, t_max, reps):
    """intersect_dense vs its plain version on the same CUDA tensors."""
    import torch
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops

    plain = ops.intersect_dense_plain(woop, o, d, t_min, t_max)
    t_scale = float(torch.clamp(plain.t[plain.valid].abs().max(), min=1.0))
    worst = 0.0
    for any_hit in (False, True):
        kern = ops.intersect_dense(woop, o, d, t_min, t_max, any_hit=any_hit)
        torch.cuda.synchronize()
        r = ops.compare_hits(kern, plain, woop, t_min, t_max, any_hit=any_hit)
        worst = max(worst, _check_hits(label, "any_hit" if any_hit else "closest", r, t_scale))
    ms = _time_ms(lambda: ops.intersect_dense(woop, o, d, t_min, t_max), reps)
    plain_ms = _time_ms(lambda: ops.intersect_dense_plain(woop, o, d, t_min, t_max),
                        max(1, reps // 10))
    print(f"[time] {label}: {o.shape[0]} rays x {woop.shape[0]} tris: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms")
    return worst, ms, plain_ms


def _compare_bvh(label, bvh, o, d, t_min, t_max, reps):
    """intersect_bvh vs the oracle on the same CUDA tensors, closest and
    any-hit; returns (worst error, kernel ms, plain ms, flops, bytes) of
    the closest-hit query, the work counted by the oracle."""
    import torch
    from cudatracerlib_tpu_torch.ops import intersect_bvh as bvh_ops
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops

    worst = 0.0
    for any_hit in (False, True):
        plain, n_inner, n_leaf, n_tpass = bvh_ops.intersect_bvh_plain(
            bvh, o, d, t_min, t_max, any_hit=any_hit, with_counts=True)
        if not any_hit:
            t_scale = float(torch.clamp(plain.t[plain.valid].abs().max(), min=1.0))
            flops = (FLOPS_BVH_INNER * int(n_inner.sum())
                     + FLOPS_WOOP_T * LEAF_SIZE * int(n_leaf.sum())
                     + FLOPS_WOOP_UV * int(n_tpass.sum()))
            print(f"[work] {label}: {o.shape[0]} rays, inner visits {int(n_inner.sum())} "
                  f"(mean {float(n_inner.double().mean()):.2f}), leaf visits "
                  f"{int(n_leaf.sum())} (mean {float(n_leaf.double().mean()):.2f}), rows "
                  f"past the t test {int(n_tpass.sum())} "
                  f"(mean {float(n_tpass.double().mean()):.2f}), {flops} operations")
        kern = bvh_ops.intersect_bvh(bvh, o, d, t_min, t_max, any_hit=any_hit)
        torch.cuda.synchronize()
        r = ops.compare_hits(kern, plain, bvh.woop, t_min, t_max, any_hit=any_hit)
        worst = max(worst, _check_hits(label, "any_hit" if any_hit else "closest", r, t_scale))
    ms = _time_ms(lambda: bvh_ops.intersect_bvh(bvh, o, d, t_min, t_max), reps)
    plain_ms = _time_ms(lambda: bvh_ops.intersect_bvh_plain(bvh, o, d, t_min, t_max), 1)
    nbytes = o.shape[0] * (24 + 8 + 16) + 4 * (bvh.nodes.numel() + bvh.woop.numel())
    print(f"[time] {label}: {o.shape[0]} rays x {bvh.woop.shape[0]} rows: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms")
    return worst, ms, plain_ms, flops, nbytes


def _check_density(label, args):
    """photon_density vs its plain version on the same CUDA tensors; returns
    the largest absolute difference and the surviving pairs of the cull."""
    import torch
    from cudatracerlib_tpu_torch.ops import photon_gather as pg_ops

    kf, kw = pg_ops.photon_density(*args)
    pf, pw = pg_ops.photon_density_plain(*args)
    torch.cuda.synchronize()
    err, rel = 0.0, 0.0
    for what, k, p in (("flux", kf, pf), ("sum_w", kw, pw)):
        diff = (k - p).abs()
        bad = diff > DENSITY_RTOL * p.abs() + DENSITY_ATOL * float(p.abs().max())
        _require(not bool(bad.any()), f"photon_density {label} {what}: {int(bad.sum())} sums "
                                      f"outside tolerance, worst {float(diff.max())}")
        err = max(err, float(diff.max()))
        big = p.abs() > 1e-3 * float(p.abs().max())
        rel = max(rel, float((diff[big] / p.abs()[big]).max()) if bool(big.any()) else 0.0)
    q_valid = args[4]
    _require(bool((kw[~q_valid] == 0).all()) and bool((kf[~q_valid] == 0).all()),
             f"photon_density {label}: an invalid query got a nonzero sum")
    pairs = pg_ops.surviving_pairs(args[1], args[2], q_valid, args[5])
    tiles = args[0]
    print(f"[kernel vs plain] photon_density {label}: {args[2].shape[0]} queries "
          f"({int(q_valid.sum())} valid) x {tiles.shape[0]} tiles, radius {float(args[5]):.6f}, "
          f"{pairs} surviving pairs, max abs err {err:.3g}, max rel err {rel:.3g}")
    return err, pairs


def _profile(label, fn):
    """Device kernel time, busy share and launches of one call of `fn`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:  # union of kernel intervals, in microseconds
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"[profile] {label}: wall {wall * 1e3:.3f} ms (profiled), device kernel time "
          f"{busy / 1e3:.3f} ms, busy {busy / 1e6 / wall:.3f}, idle {1 - busy / 1e6 / wall:.3f}, "
          f"{len(kernels)} kernel launches")
    for name, us in top:
        print(f"[profile] {label}:   {us / 1e3:9.3f} ms {100 * us / busy:5.1f}%  {name[:90]}")
    for kernel in PORT_KERNELS:  # the port's own kernels, wherever they rank
        mine = [e for e in kernels if e.name.startswith(f"(anonymous namespace)::{kernel}(")]
        us = sum(e.time_range.end - e.time_range.start for e in mine)
        n = len(mine)
        print(f"[profile] {label}: port kernel {kernel}: {n} launches, {us / 1e3:.3f} ms, "
              f"{100 * us / max(busy, 1e-9):.2f}% of device time, "
              f"{100 * us / 1e6 / wall:.2f}% of wall")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "cudatracerlib_tpu_torch")):
        print("chip_smoke: the cudatracerlib_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    import numpy as np

    from cudatracerlib_tpu_torch import native
    from cudatracerlib_tpu_torch.accel.bvh import build_bvh, woop_transform
    from cudatracerlib_tpu_torch.ops import intersect_bvh as bvh_ops
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops
    from cudatracerlib_tpu_torch.ops import photon_gather as pg_ops
    from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops
    from cudatracerlib_tpu_torch.render import path_tracer as pt
    from cudatracerlib_tpu_torch.render import ppm
    from cudatracerlib_tpu_torch.render import wavefront as wf
    from cudatracerlib_tpu_torch.scene import scene as scene_mod
    from cudatracerlib_tpu_torch.scene import shade_pack
    from cudatracerlib_tpu_torch.scene.shapes import caustic_scene, cornell_box, glossy_scene

    counters = (ops.launches, bvh_ops.launches, sg_ops.launches, pg_ops.launches)

    def reset_counts():
        for c in counters:
            for k in c:
                c[k] = 0

    # ---- 1. device ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"[device] {name}, {count} device(s), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    # ---- 2. build, every source at once ----
    def timed(get):
        t0 = time.perf_counter()
        get()
        return time.perf_counter() - t0

    builds = {"intersect_dense.cu": ops.get_lib, "intersect_bvh.cu": bvh_ops.get_lib,
              "shade_gather.cu": sg_ops.get_lib, "photon_gather.cu": pg_ops.get_lib,
              "bvh_builder.cpp (g++)": native.get_lib}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        secs = dict(zip(builds, pool.map(timed, builds.values())))
    print(f"[build] {', '.join(f'{k} {v:.2f} s' for k, v in secs.items())}; "
          f"all in {time.perf_counter() - t0:.2f} s (nvcc sm_90a, in parallel)")

    # ---- 3. intersect_dense vs plain at the Cornell path's shapes and at the band top ----
    scene = cornell_box()
    _require(scene.bvh.woop.device.type == "cuda", "cornell_box() did not build on the card")
    cfg = pt.specialize_config(scene, pt.PTConfig(max_depth=DEPTH))
    o, d, _, sampler = pt.camera_rays(scene, W, H, SPP, 3)
    woop = scene.bvh.woop
    err_cam, ms_cam, plain_ms_cam = _compare("cornell camera rays", woop, o, d, 1e-4,
                                             torch.inf, 50)
    n = o.shape[0]
    b0 = pt.surface_bounce(scene, cfg, o=o, d=d, active=torch.ones(n, dtype=torch.bool, device=dev),
                           throughput=torch.ones(n, 3, device=dev),
                           prev_pdf=torch.zeros(n, device=dev),
                           prev_delta=torch.ones(n, dtype=torch.bool, device=dev),
                           eta_scale=torch.ones(n, device=dev), sampler=sampler, depth=0)
    err_b1, _, _ = _compare("cornell first-bounce rays", woop, b0.o[b0.cont].contiguous(),
                            b0.d[b0.cont].contiguous(), 1e-4, torch.inf, 50)

    rng = np.random.default_rng(0)
    centers = rng.uniform(-1.0, 1.0, (4096, 1, 3))
    tris = (centers + rng.normal(scale=0.08, size=(4096, 3, 3))).astype(np.float32)
    soup = torch.from_numpy(woop_transform(tris[:, 0], tris[:, 1], tris[:, 2])).to(dev)
    so = torch.from_numpy(rng.uniform(-1.5, 1.5, (SOUP_RAYS, 3)).astype(np.float32)).to(dev)
    sd = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(SOUP_RAYS, 3)).astype(np.float32)).to(dev), dim=-1)
    err_soup, ms_soup, plain_ms_soup = _compare("soup4096", soup, so, sd, 1e-4, 2.0, 10)

    # ---- 4. the Cornell path at bench config 1 ----
    img1, rays = pt.render_counted(scene, W, H, SPP, 3, cfg)
    mean1 = float(img1.mean())
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    img = pt.render_progressive(scene, W, H, SPP, N_PASS, 7, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ops.launches)
    print(f"[main path] cornell launches {launches}")
    _require(launches["closest"] > 0 and launches["any_hit"] > 0,
             f"the Cornell path did not launch the kernel for both ray kinds: {launches}")
    _require(bool(torch.isfinite(img).all()) and tuple(img.shape) == (H, W, 3),
             "the progressive image is not finite or has the wrong shape")
    _require(bool(torch.isfinite(img1).all()), "the counted image is not finite")
    _require(abs(mean1 - REF_MEAN_SEED3) <= 5e-3 * REF_MEAN_SEED3,
             f"seed-3 image mean {mean1} is not within 0.5% of {REF_MEAN_SEED3}")
    rays_pass = int(rays)
    mrays = rays_pass * N_PASS / dt / 1e6
    print(f"[main path] cornell {W}x{H} spp {SPP} depth {DEPTH}: seed-3 mean {mean1:.6f} "
          f"(ref {REF_MEAN_SEED3}), rays/pass {rays_pass}, {N_PASS} passes in {dt:.4f} s, "
          f"{mrays:.3f} Mrays/s, progressive mean {float(img.mean()):.6f}")
    print(f"[summary] soup4096: kernel {ms_soup:.4f} ms, plain {plain_ms_soup:.4f} ms; "
          f"max abs err {max(err_cam, err_b1, err_soup):.3g}")
    dense_bound = _bound(FLOPS_DENSE_PAIR * n * woop.shape[0], n * (24 + 8 + 16) + woop.numel() * 4)

    # ---- 5. intersect_bvh vs its plain version on glossy rays and a deep soup ----
    glossy = glossy_scene()
    gcfg = pt.specialize_config(glossy, pt.PTConfig(max_depth=DEPTH))
    ids = torch.arange(W * H * SPP, device=dev)
    _, go, gd, gstate = wf._camera_ray(glossy, ids, 3, W, H)
    err_g, ms_bvh, plain_ms_bvh, bvh_flops, bvh_bytes = _compare_bvh(
        "glossy camera rays", glossy.bvh, go, gd, 1e-4, torch.inf, 20)
    gn = go.shape[0]
    g1 = pt.surface_bounce(glossy, gcfg, o=go, d=gd,
                           active=torch.ones(gn, dtype=torch.bool, device=dev),
                           throughput=torch.ones(gn, 3, device=dev),
                           prev_pdf=torch.zeros(gn, device=dev),
                           prev_delta=torch.ones(gn, dtype=torch.bool, device=dev),
                           eta_scale=torch.ones(gn, device=dev), sampler=pt.Sampler(state=gstate),
                           depth=0, pack=shade_pack.build_shade_pack(glossy))
    err_g1, ms_bvh_b1, plain_ms_bvh_b1, _, _ = _compare_bvh(
        "glossy first-bounce rays", glossy.bvh, g1.o[g1.cont].contiguous(),
        g1.d[g1.cont].contiguous(), 1e-4, torch.inf, 20)
    rng = np.random.default_rng(1)
    centers = rng.uniform(-1.0, 1.0, (SOUP_TRIS, 1, 3))
    tris = (centers + rng.normal(scale=0.03, size=(SOUP_TRIS, 3, 3))).astype(np.float32)
    t0 = time.perf_counter()
    soup_bvh = build_bvh(tris)
    print(f"[build] soup65536 BVH: {soup_bvh.nodes.shape[0]} nodes, "
          f"{soup_bvh.woop.shape[0]} rows, {time.perf_counter() - t0:.2f} s")
    so = torch.from_numpy(rng.uniform(-1.5, 1.5, (SOUP_RAYS, 3)).astype(np.float32)).to(dev)
    sd = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(SOUP_RAYS, 3)).astype(np.float32)).to(dev), dim=-1)
    err_s65, ms_s65, plain_ms_s65, s65_flops, s65_bytes = _compare_bvh(
        "soup65536", soup_bvh, so, sd, 1e-4, torch.inf, 5)
    bvh_bound = _bound(bvh_flops, bvh_bytes)
    s65_bound = _bound(s65_flops, s65_bytes)
    print(f"[bound] intersect_bvh glossy camera rays {bvh_bound[0]:.5f} ms ({bvh_bound[1]}), "
          f"soup65536 {s65_bound[0]:.5f} ms ({s65_bound[1]})")

    # ---- 6. packed_gather vs its plain version ----
    pack = shade_pack.build_shade_pack(glossy)
    first = scene_mod.scene_intersect(glossy, go, gd)
    idx_main = torch.clamp(first.prim, min=0)
    idx_odd = torch.cat([first.prim, torch.tensor([-7, pack.shape[0], pack.shape[0] + 999,
                                                   -(2 ** 31), 2 ** 31 - 1],
                                                  dtype=torch.int32, device=dev)])
    gather_err = 0.0
    for label, idx in (("first-hit prims", idx_main), ("with out-of-range indices", idx_odd)):
        kern = sg_ops.packed_gather(pack, idx)
        plain = sg_ops.packed_gather_plain(pack, idx)
        torch.cuda.synchronize()
        _require(torch.equal(kern, plain), f"packed_gather {label}: not bit-equal")
        gather_err = max(gather_err, float((kern - plain).abs().max()))
        print(f"[kernel vs plain] packed_gather {label}: {idx.shape[0]} rows of "
              f"{pack.shape[1]}, bit-equal")
    ms_g = _time_ms(lambda: sg_ops.packed_gather(pack, idx_main), 50)
    plain_ms_g = _time_ms(lambda: sg_ops.packed_gather_plain(pack, idx_main), 50)
    lib_ms_g = _time_ms(lambda: torch.index_select(pack, 0, idx_main), 50)
    gn_idx = idx_main.shape[0]
    gather_bound = _bound(0, gn_idx * pack.shape[1] * 4 + gn_idx * 4 + pack.numel() * 4)
    print(f"[time] packed_gather {gn_idx} x {pack.shape[1]}: kernel {ms_g:.4f} ms, plain "
          f"{plain_ms_g:.4f} ms, index_select {lib_ms_g:.4f} ms, bound "
          f"{gather_bound[0]:.5f} ms ({gather_bound[1]})")

    # ---- 7. the glossy path: bench config 2 ----
    gimg, grays = wf.render_wavefront_counted(glossy, GLOSSY_PIN["width"], GLOSSY_PIN["height"],
                                              GLOSSY_PIN["spp"], GLOSSY_PIN["seed"], gcfg)
    gmean = float(gimg.mean())
    _require(bool(torch.isfinite(gimg).all()), "the pinned glossy image is not finite")
    _require(abs(gmean - REF_GLOSSY_MEAN) <= GLOSSY_TOL * REF_GLOSSY_MEAN,
             f"glossy pinned mean {gmean} is not within 1% of {REF_GLOSSY_MEAN}")
    print(f"[main path] glossy pinned {GLOSSY_PIN}: mean {gmean:.6f} (ref {REF_GLOSSY_MEAN}, "
          f"{100 * (gmean / REF_GLOSSY_MEAN - 1):+.4f}%), rays {int(grays)} (ref 507368)")
    spp2 = SPP * N_PASS
    wf.render_wavefront_counted(glossy, W, H, spp2, 0, gcfg)   # warm
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    bimg, brays = wf.render_wavefront_counted(glossy, W, H, spp2, 7, gcfg)
    torch.cuda.synchronize()
    gdt = time.perf_counter() - t0
    glaunch = {"intersect_bvh": dict(bvh_ops.launches), "packed_gather": dict(sg_ops.launches),
               "intersect_dense": dict(ops.launches)}
    print(f"[main path] glossy launches {json.dumps(glaunch)}")
    _require(glaunch["intersect_bvh"]["closest"] > 0 and glaunch["intersect_bvh"]["any_hit"] > 0,
             f"the glossy path did not launch intersect_bvh for both ray kinds: {glaunch}")
    _require(glaunch["packed_gather"]["gather"] > 0,
             f"the glossy path did not launch packed_gather: {glaunch}")
    _require(bool(torch.isfinite(bimg).all()) and tuple(bimg.shape) == (H, W, 3),
             "the bench-config-2 image is not finite or has the wrong shape")
    print(f"[main path] glossy {W}x{H} spp {spp2} depth {DEPTH} seed 7: rays {int(brays)}, "
          f"{gdt:.4f} s, {int(brays) / gdt / 1e6:.3f} Mrays/s, mean {float(bimg.mean()):.6f}")

    # ---- 8. photon_density vs its plain version, on bench-config-5 inputs ----
    caustic = caustic_scene()
    _require(caustic.bvh.woop.device.type == "cuda", "caustic_scene() did not build on the card")
    pcfg = ppm.PPMConfig()
    captured = []
    real_density = pg_ops.photon_density

    def capture(*args):
        captured.append(args)
        return real_density(*args)

    pg_ops.photon_density = capture
    try:  # the warm pass of 9, at seed 0
        ppm.render_ppm_pass(caustic, PPM_W, PPM_H, PPM_SPP, 0, PPM_PASS, pcfg)
        torch.cuda.synchronize()
    finally:
        pg_ops.photon_density = real_density
    _require(len(captured) == 2, f"a PPM pass called photon_density {len(captured)} times, not 2")
    dens_err, pairs = 0.0, []
    for label, args in zip(("global map", "caustic map"), captured):
        e, n_pairs = _check_density(label, args)
        dens_err, pairs = max(dens_err, e), pairs + [n_pairs]
    rng = np.random.default_rng(2)
    n_hot = 1 << 15
    hpos = np.zeros((n_hot, 3), np.float32)
    hpos[:, :2] = rng.normal(scale=0.03, size=(n_hot, 2))
    hn = np.tile(np.float32([[0, 0, 1]]), (n_hot, 1))
    hwi = rng.normal(size=(n_hot, 3)).astype(np.float32) + hn
    hwi /= np.linalg.norm(hwi, axis=-1, keepdims=True)
    hq = np.zeros((1 << 14, 3), np.float32)
    hq[:, :2] = rng.normal(scale=0.03, size=(1 << 14, 2))
    hqv = rng.random(1 << 14) >= 0.05
    hq = hq[np.argsort(np.where(hqv, np.floor(hq[:, 0] / 0.05) * 1e3 + np.floor(hq[:, 1] / 0.05),
                                1e9), kind="stable")]
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    htiles, haabbs = pg_ops.build_photon_tiles(t(hpos), t(rng.uniform(0, 1, (n_hot, 3))
                                                         .astype(np.float32)),
                                               t(hn), t(rng.random(n_hot) >= 0.1), [-1, -1, -1],
                                               [1, 1, 1], 40, wi=t(hwi))
    e, _ = _check_density("hotspot", (htiles, haabbs, t(hq), t(np.tile(hn[:1], (1 << 14, 1))),
                                      t(hqv), np.float32(0.05)))
    dens_err = max(dens_err, e)
    main_args = captured[0]
    ms_pd = _time_ms(lambda: pg_ops.photon_density(*main_args), 20)
    plain_ms_pd = _time_ms(lambda: pg_ops.photon_density_plain(*main_args), 2)
    ms_pd_c = _time_ms(lambda: pg_ops.photon_density(*captured[1]), 20)
    n_q = main_args[2].shape[0]
    pd_bytes = (main_args[0].numel() + main_args[1].numel()) * 4 + n_q * (12 + 12 + 1) + n_q * 16
    pd_bound = _bound(FLOPS_PHOTON_PAIR * pairs[0], pd_bytes)
    print(f"[time] photon_density global map: kernel {ms_pd:.4f} ms, plain {plain_ms_pd:.4f} ms, "
          f"bound {pd_bound[0]:.5f} ms ({pd_bound[1]}: {FLOPS_PHOTON_PAIR * pairs[0]} operations, "
          f"{pd_bytes} bytes); caustic map: kernel {ms_pd_c:.4f} ms, bound "
          f"{_bound(FLOPS_PHOTON_PAIR * pairs[1], pd_bytes)[0]:.5f} ms")

    # ---- 9. the PPM path: pinned pass, then bench config 5's PPM half ----
    pin = PPM_PIN
    pin_img = ppm.render_ppm_pass(caustic, pin["width"], pin["height"], pin["spp"], pin["seed"],
                                  pin["pass_idx"], pcfg._replace(n_photons=pin["n_photons"]))
    pmean = float(pin_img.mean())
    _require(bool(torch.isfinite(pin_img).all()), "the pinned PPM image is not finite")
    _require(abs(pmean - REF_PPM_MEAN) <= PPM_TOL * REF_PPM_MEAN,
             f"pinned PPM mean {pmean} is not within {PPM_TOL:.1%} of {REF_PPM_MEAN}")
    print(f"[main path] ppm pinned {pin}: mean {pmean:.6f} (ref {REF_PPM_MEAN}, "
          f"{100 * (pmean / REF_PPM_MEAN - 1):+.4f}%)")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    pimg = ppm.render_ppm_pass(caustic, PPM_W, PPM_H, PPM_SPP, 7, PPM_PASS, pcfg)
    torch.cuda.synchronize()
    pdt = time.perf_counter() - t0
    plaunch = {"photon_density": dict(pg_ops.launches), "intersect_dense": dict(ops.launches),
               "packed_gather": dict(sg_ops.launches), "intersect_bvh": dict(bvh_ops.launches)}
    print(f"[main path] ppm launches {json.dumps(plaunch)}")
    _require(plaunch["photon_density"]["density"] > 0,
             f"the PPM path did not launch photon_density: {plaunch}")
    _require(plaunch["intersect_dense"]["closest"] > 0 and plaunch["intersect_dense"]["any_hit"] > 0,
             f"the PPM path did not launch intersect_dense for both ray kinds: {plaunch}")
    _require(plaunch["packed_gather"]["gather"] > 0,
             f"the PPM path did not launch packed_gather: {plaunch}")
    _require(bool(torch.isfinite(pimg).all()) and tuple(pimg.shape) == (PPM_H, PPM_W, 3),
             "the bench-config-5 PPM image is not finite or has the wrong shape")
    base5 = pt.specialize_config(caustic, pcfg.base)
    _, ph_rays = ppm.trace_photons(caustic, pcfg.n_photons, 3, base5, with_stats=True)
    rays5 = int(ph_rays) + PPM_W * PPM_H * PPM_SPP
    print(f"[main path] ppm {PPM_W}x{PPM_H} spp {PPM_SPP} {pcfg.n_photons} photons depth "
          f"{pcfg.base.max_depth} pass {PPM_PASS} seed 7: rays {rays5} ({int(ph_rays)} photon + "
          f"{PPM_W * PPM_H * PPM_SPP} camera), {pdt:.4f} s, {rays5 / pdt / 1e6:.3f} Mrays/s, "
          f"mean {float(pimg.mean()):.6f}")

    # ---- 10. profile ----
    _profile("cornell pass", lambda: pt.render(scene, W, H, SPP, 7, cfg))
    _profile("glossy bench config 2",
             lambda: wf.render_wavefront_counted(glossy, W, H, spp2, 7, gcfg))
    _profile("ppm bench config 5 pass",
             lambda: ppm.render_ppm_pass(caustic, PPM_W, PPM_H, PPM_SPP, 7, PPM_PASS, pcfg))

    print(json.dumps({"kernels": [
        {
            "name": "intersect_dense",
            "route": "cuda",
            "source": "cudatracerlib_tpu_torch/csrc/intersect_dense.cu",
            "replaces": "cudatracerlib_tpu/ops/intersect_pallas.py:89",
            "launches": launches["closest"] + launches["any_hit"],
            "max_abs_err": max(err_cam, err_b1, err_soup),
            "ms": ms_cam,
            "plain_ms": plain_ms_cam,
            "bound_ms": dense_bound[0],
            "bound_by": dense_bound[1],
            "library_ms": None,
        },
        {
            "name": "intersect_bvh",
            "route": "cuda",
            "source": "cudatracerlib_tpu_torch/csrc/intersect_bvh.cu",
            "replaces": "cudatracerlib_tpu/ops/cluster_trace.py:411",
            "launches": glaunch["intersect_bvh"]["closest"] + glaunch["intersect_bvh"]["any_hit"],
            "max_abs_err": max(err_g, err_g1, err_s65),
            "ms": ms_bvh,
            "plain_ms": plain_ms_bvh,
            "bound_ms": bvh_bound[0],
            "bound_by": bvh_bound[1],
            "library_ms": None,
        },
        {
            "name": "packed_gather",
            "route": "cuda",
            "source": "cudatracerlib_tpu_torch/csrc/shade_gather.cu",
            "replaces": "cudatracerlib_tpu/ops/shade_gather.py:69",
            "launches": glaunch["packed_gather"]["gather"],
            "max_abs_err": gather_err,
            "ms": ms_g,
            "plain_ms": plain_ms_g,
            "bound_ms": gather_bound[0],
            "bound_by": gather_bound[1],
            "library_ms": lib_ms_g,
        },
        {
            "name": "photon_density",
            "route": "cuda",
            "source": "cudatracerlib_tpu_torch/csrc/photon_gather.cu",
            "replaces": "cudatracerlib_tpu/ops/photon_gather.py:164",
            "launches": plaunch["photon_density"]["density"],
            "max_abs_err": dens_err,
            "ms": ms_pd,
            "plain_ms": plain_ms_pd,
            "bound_ms": pd_bound[0],
            "bound_by": pd_bound[1],
            "library_ms": None,
        },
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
