#!/usr/bin/env python3
"""An earlier and the current port side by side on the wavefront engine:
bench config 2's render (the glossy scene, 256x256, 80 spp pooled through
a 2^20-lane pool, depth 5, seed 7) through `render_wavefront_counted`.

For each version it counts the PyTorch operations the render dispatches
and, among them, those that wait for the device: reads of a device value
on the host (`aten.item`, `aten.is_nonzero`, `aten._local_scalar_dense`)
and `aten.nonzero` (which reads its output's size); and on an NVIDIA GPU
the render's kernel launches (torch.profiler) and the median wall of 5
synchronised renders. On the CPU the render is 16x16 at 4 spp
through a 256-lane pool. Each version runs in a process of its own, in the
order earlier, current, current, earlier. Run from the root of a checkout,
an earlier commit unpacked into a git-ignored directory first:

    mkdir -p .chipcheck/parent && git archive <commit> | tar -x -C .chipcheck/parent
    python3 tools/ab_wavefront.py .chipcheck/parent [--cpu]

It prints one JSON line per run.
"""
import collections
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_READS = ("aten._local_scalar_dense", "aten.item", "aten.is_nonzero", "aten.nonzero")


def measure(root: str, device: str) -> dict:
    sys.path.insert(0, root)
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from cudatracerlib_tpu_torch.render import path_tracer as pt
    from cudatracerlib_tpu_torch.render import wavefront as wf
    from cudatracerlib_tpu_torch.scene.shapes import glossy_scene

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n[str(func)] += 1
            return func(*args, **(kwargs or {}))

    gpu = device == "cuda"
    size, spp, capacity = (256, 80, None) if gpu else (16, 4, 256)
    cfg = pt.PTConfig(max_depth=5)
    scene = glossy_scene(device=device)

    def run():
        return wf.render_wavefront_counted(scene, size, size, spp, 7, cfg, capacity=capacity)

    img, rays = run()
    with Count() as ops:
        run()
    reads = sum(v for k, v in ops.n.items() if k.startswith(HOST_READS))
    out = dict(root=root, device=torch.cuda.get_device_name(0) if gpu else "cpu",
               size=size, spp=spp, rays=int(rays), mean=float(img.mean()),
               ops=sum(ops.n.values()), host_reads=reads)
    if gpu:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        out["launches"] = sum(e.device_type == DeviceType.CUDA for e in prof.events())
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out["wall_ms"] = sorted(walls)[2]
        out["walls_ms"] = walls
    return out


def main():
    if sys.argv[1] == "--measure":
        print(json.dumps(measure(sys.argv[2], sys.argv[3])), flush=True)
        return
    earlier = os.path.abspath(sys.argv[1])
    device = "cpu" if "--cpu" in sys.argv[2:] else "cuda"
    for root in (earlier, ROOT, ROOT, earlier):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", root, device],
                       check=True, cwd=root)


if __name__ == "__main__":
    main()
