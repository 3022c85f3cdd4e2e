#!/usr/bin/env python3
"""Earlier and current intersection kernels side by side on one NVIDIA GPU.

Builds `intersect_dense.cu` and `intersect_bvh.cu` of an earlier version of
the port from a directory (with that version's C interface: the current one
without the vertex-row pointer, as at commit 1912d22, whose kernels decide a
hit by the Woop rows' u, v) beside the current kernels, and times each
kernel alone (ranges, outputs and ray counters made beforehand, CUDA
events) in turns at the main paths' shapes, the inputs made as
`chip_smoke.py` makes them:

- dense: Cornell camera and first-bounce rays (2^20 x 60 rows), the PPM
  pass's first photon-walk, eye and shadow launches (3,160 rows), a
  4096-triangle soup;
- BVH: glossy camera and first-bounce rays (2^20 x 6,624 rows), the
  bigscene's camera rays (2^20 x 825,956 rows, bench config 3), a
  65,536-triangle soup; and, as a yardstick, the BVH kernel on the PPM
  photon and eye rays over the caustic scene's BVH.

Order at each shape: earlier, current, current, earlier; the line also
counts the rays whose prim the two agree on. Run from the root of a
checkout, the earlier sources extracted first, e.g.

    mkdir -p .chipcheck/old
    for f in intersect_dense intersect_bvh; do
      git show <commit>:cudatracerlib_tpu_torch/csrc/$f.cu > .chipcheck/old/$f.cu
    done
    python3 tools/ab_intersect.py .chipcheck/old

It prints one line per shape, then all of them as one JSON object.
"""
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
OLD_ARGTYPES = {
    "intersect_dense": [_P, _I, _P, _P, _P, _F, _P, _F, _P, _I, _I, _P, _P, _P, _P],
    "intersect_bvh": [_P, _P, _I, _I, _P, _P, _F, _P, _F, _P, _I, _I, _I, _P, _P, _P, _P, _P],
}
# where the current launch arguments hold the vertex rows, which the earlier interface lacks
VERTS_ARG = {"intersect_dense": 1, "intersect_bvh": 2}


def _old_kernel(old_dir, name):
    from cudatracerlib_tpu_torch._build_util import NVCC_FLAGS, build_shared, load, nvcc_path

    lib = load(build_shared(os.path.join(old_dir, f"{name}.cu"), f"earlier_{name}",
                            [nvcc_path()] + NVCC_FLAGS))
    fn = getattr(lib, f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = OLD_ARGTYPES[name]
    return fn


def _launcher(fn):
    def launch(prepared):
        err = fn(*prepared[0])
        if err:
            raise RuntimeError(f"earlier kernel launch failed: cudaError {err}")
    return launch


def _earlier(name, prepared):
    """The current launch's prepared arguments in the earlier interface."""
    args, keep, device = prepared
    k = VERTS_ARG[name]
    return (args[:k] + args[k + 1:], keep, device)


def _bvh_prepared(bvh, o, d, t_min, t_max, n):
    """n launches' arguments, each with its own zeroed ray counter, and the
    first one's outputs."""
    import torch
    from cudatracerlib_tpu_torch.ops import intersect_bvh as bvh_ops

    counters = torch.zeros(n, dtype=torch.int32, device=o.device)
    runs = [bvh_ops.launch_args(bvh, o, d, t_min, t_max, next_ray=counters[k:k + 1])
            for k in range(n)]
    return [p for p, _ in runs], runs[0][1]


def main(old_dir):
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("ab_intersect: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from cudatracerlib_tpu_torch.ops import intersect_bvh as bvh_ops
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops
    from cudatracerlib_tpu_torch.render import path_tracer as pt
    from cudatracerlib_tpu_torch.render import ppm
    from cudatracerlib_tpu_torch.render import wavefront as wf
    from cudatracerlib_tpu_torch.accel.bvh import (build_bvh, chunk_boxes_from_woop,
                                                   vertex_rows, woop_transform)
    from cudatracerlib_tpu_torch.scene import shade_pack
    from cudatracerlib_tpu_torch.scene.bigscene import build_big_scene
    from cudatracerlib_tpu_torch.scene.shapes import caustic_scene, cornell_box, glossy_scene

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi}")
    with ThreadPoolExecutor(4) as pool:
        futs = [pool.submit(_old_kernel, old_dir, n) for n in OLD_ARGTYPES]
        futs += [pool.submit(ops.get_lib), pool.submit(bvh_ops.get_lib)]
        old_dense, old_bvh = (f.result() for f in futs[:2])
        for f in futs[2:]:
            f.result()

    shapes_dense, shapes_bvh = {}, {}
    scene = cornell_box()
    cfg = pt.specialize_config(scene, pt.PTConfig(max_depth=cs.DEPTH))
    o, d, _, sampler = pt.camera_rays(scene, cs.W, cs.H, cs.SPP, 3)
    boxes, verts = scene.bvh.chunk_boxes, scene.bvh.tri_verts
    shapes_dense["cornell camera rays"] = (scene.bvh.woop, o, d, 1e-4, torch.inf, boxes, verts)
    shapes_dense["cornell first-bounce rays"] = (
        scene.bvh.woop, *cs._first_bounce(scene, cfg, o, d, sampler), 1e-4, torch.inf, boxes,
        verts)
    caustic = caustic_scene()
    ppm_args, _ = cs._capture_ppm(caustic, ppm.PPMConfig())
    for label, c in ppm_args.items():
        shapes_dense[label] = (c[0], c[1], c[2], c[3], c[4], c[6], c[7])
    tris, so, sd = cs._soup(0, 4096, 0.08, dev)
    soup = torch.from_numpy(woop_transform(tris[:, 0], tris[:, 1], tris[:, 2])).to(dev)
    shapes_dense["soup4096"] = (soup, so, sd, 1e-4, 2.0, chunk_boxes_from_woop(soup),
                                vertex_rows(torch.from_numpy(tris).to(dev)))

    glossy = glossy_scene()
    gcfg = pt.specialize_config(glossy, pt.PTConfig(max_depth=cs.DEPTH))
    _, go, gd, gstate = wf._camera_ray(glossy, torch.arange(cs.W * cs.H * cs.SPP, device=dev),
                                       3, cs.W, cs.H)
    shapes_bvh["glossy camera rays"] = (glossy.bvh, go, gd, 1e-4, torch.inf)
    shapes_bvh["glossy first-bounce rays"] = (
        glossy.bvh, *cs._first_bounce(glossy, gcfg, go, gd, pt.Sampler(state=gstate),
                                      shade_pack.build_shade_pack(glossy)), 1e-4, torch.inf)
    big = build_big_scene()
    _, bo, bd, _ = wf._camera_ray(big, torch.arange(cs.BIG_CMP_LANES, device=dev), 3, cs.BIG_W,
                                  cs.BIG_H)
    shapes_bvh["bigscene camera rays"] = (big.bvh, bo, bd, 1e-4, torch.inf)
    tris, so, sd = cs._soup(1, cs.SOUP_TRIS, 0.03, dev)
    shapes_bvh["soup65536"] = (build_bvh(tris), so, sd, 1e-4, torch.inf)
    for label in ("ppm photon rays", "ppm eye rays"):
        c = ppm_args[label]
        shapes_bvh[f"caustic BVH, {label}"] = (caustic.bvh, c[1], c[2], c[3], c[4])

    results = {"device": smi, "dense": {}, "bvh": {}}
    for label, (woop, o, d, t_min, t_max, bx, vx) in shapes_dense.items():
        reps = 20
        new_p, new_out = ops.launch_args(woop, o, d, t_min, t_max, boxes=bx, verts=vx)
        old_p, old_out = ops.launch_args(woop, o, d, t_min, t_max, boxes=bx, verts=vx)
        old_p = _earlier("intersect_dense", old_p)
        old_l = _launcher(old_dense)
        seq = [("earlier", old_p, old_l), ("current", new_p, ops.launch),
               ("current", new_p, ops.launch), ("earlier", old_p, old_l)]
        times = {}
        for name, p, launch in seq:
            times.setdefault(name, []).append(cs._time_kernel_ms([p] * (reps + 1), launch))
        torch.cuda.synchronize()
        r = dict(rays=o.shape[0], rows=woop.shape[0], earlier_ms=times["earlier"],
                 current_ms=times["current"],
                 prim_equal=int((new_out[1] == old_out[1]).sum()))
        results["dense"][label] = r
        print(f"[dense] {label}: {json.dumps(r)}")
    for label, (bvh, o, d, t_min, t_max) in shapes_bvh.items():
        reps = 10
        old_ps, old_out = _bvh_prepared(bvh, o, d, t_min, t_max, 2 * reps + 2)
        old_ps = [_earlier("intersect_bvh", p) for p in old_ps]
        new_ps, new_out = _bvh_prepared(bvh, o, d, t_min, t_max, 2 * reps + 2)
        old_l = _launcher(old_bvh)
        seq = [("earlier", old_ps[:reps + 1], old_l),
               ("current", new_ps[:reps + 1], bvh_ops.launch),
               ("current", new_ps[reps + 1:], bvh_ops.launch),
               ("earlier", old_ps[reps + 1:], old_l)]
        times = {}
        for name, ps, launch in seq:
            times.setdefault(name, []).append(cs._time_kernel_ms(ps, launch))
        torch.cuda.synchronize()
        r = dict(rays=o.shape[0], rows=bvh.woop.shape[0], earlier_ms=times["earlier"],
                 current_ms=times["current"],
                 prim_equal=int((new_out[1] == old_out[1]).sum()))
        results["bvh"][label] = r
        print(f"[bvh] {label}: {json.dumps(r)}")
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
