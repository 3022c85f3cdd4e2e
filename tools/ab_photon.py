#!/usr/bin/env python3
"""An earlier and the current photon density kernel side by side on one
NVIDIA GPU.

Builds `photon_gather.cu` of an earlier version of the port from a
directory (with that version's C interface: no partial-sum scratch) beside
the current kernel, and times each kernel alone (arguments and outputs
made beforehand, CUDA events) in turns, earlier, current, current,
earlier, on the inputs `chip_smoke.py` phase 8 uses: the global and
caustic photon maps and gather queries captured in a warm bench-config-5
PPM pass at seed 0, and the synthetic hotspot. Each line also counts the
queries whose four sums are bit-equal to the earlier kernel's, checks that
two launches of the current kernel are bit-equal, and checks both kernels
against the plain version (1e-4 relative). Run from the root of a
checkout, the earlier source extracted first, e.g.

    mkdir -p .chipcheck/old
    git show <commit>:cudatracerlib_tpu_torch/csrc/photon_gather.cu \\
        > .chipcheck/old/photon_gather.cu
    python3 tools/ab_photon.py .chipcheck/old

It prints the current kernel's `-Xptxas -v` report and its residency, one
line per input, then all of them as one JSON object.
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
OLD_ARGTYPES = [_P, _I, _P, _P, _P, _P, _I, _F, _F, _P, _P]


def _old_kernel(old_dir):
    from cudatracerlib_tpu_torch._build_util import NVCC_FLAGS, build_shared, load, nvcc_path

    lib = load(build_shared(os.path.join(old_dir, "photon_gather.cu"), "earlier_photon_gather",
                            [nvcc_path()] + NVCC_FLAGS))
    fn = lib.photon_gather_launch
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
                        os.path.join(BUILD_DIR, "photon_gather_report.cubin"),
                        os.path.join(CSRC, "photon_gather.cu")],
                       capture_output=True, text=True)
    return [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def _launcher(fn, label):
    def launch(prepared):
        err = fn(*prepared[0])
        if err:
            raise RuntimeError(f"{label} kernel launch failed: cudaError {err}")
    return launch


def _agree(out, plain):
    """Sums outside 1e-4 relative (+1e-6 of the largest) of the plain version."""
    import torch

    p = torch.cat([plain[0], plain[1][:, None]], 1)
    return int(((out - p).abs() > 1e-4 * p.abs() + 1e-6 * float(p.abs().max())).sum())


def main(old_dir):
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("ab_photon: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from cudatracerlib_tpu_torch.ops import photon_gather as pg_ops
    from cudatracerlib_tpu_torch.render import ppm
    from cudatracerlib_tpu_torch.scene.shapes import caustic_scene

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi}")
    with ThreadPoolExecutor(3) as pool:
        f_old, f_new, f_rep = (pool.submit(_old_kernel, old_dir), pool.submit(pg_ops.get_lib),
                               pool.submit(_ptxas_report))
        old = f_old.result()
        f_new.result()
        for ln in f_rep.result():
            print(f"[ptxas] {ln}")
    print(f"[info] {json.dumps(pg_ops.kernel_info())}")

    _, captured = cs._capture_ppm(caustic_scene(), ppm.PPMConfig())
    inputs = {"global map": captured[0], "caustic map": captured[1], "hotspot": cs._hotspot(dev)}
    results = {"device": smi, "inputs": {}}
    old_l = _launcher(old, "earlier")
    reps = 20
    for label, args in inputs.items():
        tiles, aabbs, q, qn, qv, radius = args
        B = q.shape[0]
        new_p, new_out = pg_ops.launch_args(*args)
        old_out = torch.empty(B, 4, device=dev)
        r2, inv_r2 = pg_ops._radius2(radius)
        stream = torch.cuda.current_stream().cuda_stream
        qv8 = qv.contiguous().view(torch.uint8)
        base = (tiles.data_ptr(), tiles.shape[0], aabbs.data_ptr(), q.data_ptr(), qn.data_ptr(),
                qv8.data_ptr(), B, float(r2), float(inv_r2))
        old_p = (base + (old_out.data_ptr(), stream), (tiles, aabbs, q, qn, qv8, old_out))
        plain = pg_ops.photon_density_plain(*args)
        seq = [("earlier", old_p, old_l), ("current", new_p, pg_ops.launch),
               ("current", new_p, pg_ops.launch), ("earlier", old_p, old_l)]
        times = {}
        for name, p, launch in seq:
            times.setdefault(name, []).append(cs._time_kernel_ms([p] * (reps + 1), launch))
        torch.cuda.synchronize()
        again = new_out.clone()
        pg_ops.launch(new_p)
        torch.cuda.synchronize()
        r = dict(queries=B, tiles=tiles.shape[0], earlier_ms=times["earlier"],
                 current_ms=times["current"],
                 bit_equal=int((new_out == old_out).all(1).sum()),
                 deterministic=bool(torch.equal(new_out, again)),
                 current_off_plain=_agree(new_out, plain), earlier_off_plain=_agree(old_out, plain))
        results["inputs"][label] = r
        print(f"[photon_density] {label}: {json.dumps(r)}")
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
