#!/usr/bin/env python3
"""An earlier and the current backward of the shade-pack gather side by side
on one NVIDIA GPU.

Builds `shade_gather_bwd.cu` of an earlier version of the port from a
directory (with that version's C interface: the lanes stably sorted by row
in the wrapper, chunks of 256 sorted positions and a per-row combine)
beside the current kernels, and times each whole call as a caller makes it
(the earlier one with its `torch.sort`, clamp and casts; CUDA events over
20 calls) in turns, earlier, current, current, earlier, at the three shapes
`chip_smoke.py` phase 11 uses: the glossy pack (2^20 x 64 at the first-hit
prims of the glossy camera rays onto the pack's rows), a texture lookup
(2^20 x 3 onto Cornell's 5 texture rows at the ids captured in a Cornell
bench-config-1 gradient pass) and the hit refinement's Woop rows (2^20 x 12
onto the glossy Woop rows). Each line also gives both results' max
relative error against the float64 plain version and whether the current
result is bit-equal to its emulation on 4,096 lanes. Run from the root of a
checkout, the earlier source extracted first, e.g.

    mkdir -p .chipcheck/old
    git show <commit>:cudatracerlib_tpu_torch/csrc/shade_gather_bwd.cu \\
        > .chipcheck/old/shade_gather_bwd.cu
    python3 tools/ab_gather_bwd.py .chipcheck/old

It prints the current kernels' `-Xptxas -v` report, one line per shape,
then all of them as one JSON object.
"""
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_P, _I = ctypes.c_void_p, ctypes.c_int
OLD_ARGTYPES = [_P, _I, _P, _P, _I, _I, _I, _P, _P, _P]
OLD_CHUNK = 256
REPS = 20


def _old_kernel(old_dir):
    from cudatracerlib_tpu_torch._build_util import NVCC_FLAGS, build_shared, load, nvcc_path

    lib = load(build_shared(os.path.join(old_dir, "shade_gather_bwd.cu"),
                            "earlier_shade_gather_bwd", [nvcc_path()] + NVCC_FLAGS))
    fn = lib.shade_gather_bwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = OLD_ARGTYPES
    return fn


def _ptxas_report():
    """The current source's registers, spills and shared memory, as
    `nvcc -Xptxas -v` reports them."""
    from cudatracerlib_tpu_torch._build_util import BUILD_DIR, CSRC, nvcc_path

    os.makedirs(BUILD_DIR, exist_ok=True)
    r = subprocess.run([nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                        "-O3", "-Xptxas", "-v", "-cubin", "-o",
                        os.path.join(BUILD_DIR, "shade_gather_bwd_report.cubin"),
                        os.path.join(CSRC, "shade_gather_bwd.cu")],
                       capture_output=True, text=True)
    return [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln
            or "smem" in ln]


def _old_call(fn):
    """The earlier whole call, as its wrapper made it."""
    import torch

    def call(g, idx, n_rows):
        keys, order = torch.sort(torch.clamp(idx, 0, n_rows - 1), stable=True)
        keys, order = keys.to(torch.int32).contiguous(), order.to(torch.int32)
        n, C = g.shape
        grad = torch.empty(n_rows, C, dtype=torch.float32, device=g.device)
        partial = torch.empty(-(-n // OLD_CHUNK), 2, C, dtype=torch.float32, device=g.device)
        err = fn(g.data_ptr(), C, keys.data_ptr(), order.data_ptr(), n, n_rows, OLD_CHUNK,
                 grad.data_ptr(), partial.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"earlier kernel launch failed: cudaError {err}")
        return grad
    return call


def _breakdown(fn, calls=5):
    """Device time per call of each kernel that `fn` launches, by name, under
    torch.profiler (ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.split("::")[-1].split("(")[0][:40]
            out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / calls
    return out


def _host_us(fn, calls=200):
    """Host microseconds a call of `fn` takes to return, with no
    synchronisation between calls (the launches queue up behind the card)."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def _rel(out, plain):
    hit = plain > 0
    return float(((out - plain).abs()[hit] / plain[hit]).max())


def main(old_dir):
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("ab_gather_bwd: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops
    from cudatracerlib_tpu_torch.render import path_tracer as pt
    from cudatracerlib_tpu_torch.render import wavefront as wf
    from cudatracerlib_tpu_torch.scene import scene as scene_mod
    from cudatracerlib_tpu_torch.scene import shade_pack
    from cudatracerlib_tpu_torch.scene.shapes import cornell_box, glossy_scene

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi}")
    with ThreadPoolExecutor(3) as pool:
        f_old, f_new, f_rep = (pool.submit(_old_kernel, old_dir), pool.submit(sg_ops.get_bwd_lib),
                               pool.submit(_ptxas_report))
        old = _old_call(f_old.result())
        f_new.result()
        for ln in f_rep.result():
            print(f"[ptxas] {ln}")

    glossy = glossy_scene()
    pack = shade_pack.build_shade_pack(glossy)
    _, go, gd, _ = wf._camera_ray(glossy, torch.arange(cs.W * cs.H * cs.SPP, device=dev), 3,
                                  cs.W, cs.H)
    prims = torch.clamp(scene_mod.scene_intersect(glossy, go, gd).prim, min=0)
    cornell = cornell_box()
    tex_ids = cs._capture_texture_ids(cornell, pt.specialize_config(
        cornell, pt.PTConfig(max_depth=cs.DEPTH)))
    shapes = {"pack": (prims, pack.shape[0], pack.shape[1]),
              "texture": (tex_ids, cornell.textures.color_a.shape[0], 3),
              "woop": (prims, glossy.bvh.woop.shape[0], 12)}
    results = {"device": smi, "shapes": {}}
    for label, (idx, n_rows, cols) in shapes.items():
        n = idx.shape[0]
        g = torch.rand(n, cols, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
        new = sg_ops.packed_gather_bwd
        times = {}
        for name, fn in (("earlier", old), ("current", new), ("current", new),
                         ("earlier", old)):
            times.setdefault(name, []).append(
                cs._time_ms(lambda: fn(g, idx, n_rows), REPS))  # noqa: B023
        prepared, _ = sg_ops.bwd_launch_args(g, idx, n_rows)
        kernels_ms = cs._time_kernel_ms([prepared] * (REPS + 1), sg_ops.bwd_launch)
        by_kernel = {"current": _breakdown(lambda: new(g, idx, n_rows)),  # noqa: B023
                     "earlier": _breakdown(lambda: old(g, idx, n_rows))}  # noqa: B023
        host = {"current_call": _host_us(lambda: new(g, idx, n_rows)),  # noqa: B023
                "current_args": _host_us(lambda: sg_ops.bwd_launch_args(g, idx, n_rows)),  # noqa: B023
                "current_launch": _host_us(lambda: sg_ops.bwd_launch(prepared)),
                "earlier_call": _host_us(lambda: old(g, idx, n_rows))}  # noqa: B023
        plain = sg_ops.packed_gather_bwd_plain(g, idx, n_rows)
        a, b = old(g, idx, n_rows), new(g, idx, n_rows)
        emu = sg_ops.packed_gather_bwd_emulated(g[:4096].cpu(), idx[:4096].cpu(), n_rows)
        torch.cuda.synchronize()
        nbytes = n * cols * 4 + n * 4 + n_rows * cols * 4
        bound = cs._bound(n * cols, nbytes)[0]
        r = dict(lanes=n, cols=cols, rows=n_rows, earlier_ms=times["earlier"],
                 current_ms=times["current"], current_kernels_ms=kernels_ms, bound_ms=bound,
                 by_kernel=by_kernel, host_us=host,
                 speedup=min(times["earlier"]) / max(times["current"]),
                 current_share_of_bound=bound / max(times["current"]),
                 earlier_rel_err=_rel(a, plain), current_rel_err=_rel(b, plain),
                 current_deterministic=bool(torch.equal(b, new(g, idx, n_rows))),
                 current_equals_emulation=bool(torch.equal(
                     new(g[:4096].contiguous(), idx[:4096], n_rows).cpu(), emu)))
        results["shapes"][label] = r
        print(f"[gather_bwd] {label}: {json.dumps(r)}")
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
