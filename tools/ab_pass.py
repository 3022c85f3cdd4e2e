#!/usr/bin/env python3
"""An earlier and the current port side by side on whole path-tracer
passes: the PyTorch operations a pass dispatches and, on an NVIDIA GPU, its
kernel launches and wall.

For the Cornell box (bench config 1) and the glossy scene (bench config 2),
each a PERSPECTIVE camera, it counts the operations of `camera_rays` and of
one `render_counted` pass (a TorchDispatchMode counter), and on the card
also the pass's kernel launches (torch.profiler) and the median wall of 5
synchronised passes. Sizes: 256x256, 16 spp, depth 5 on the card; 16x16,
1 spp, depth 3 on the CPU. Each version runs in a process of its own, in
the order earlier, current, current, earlier. Run from the root of a
checkout, an earlier commit unpacked into a git-ignored directory first:

    mkdir -p .chipcheck/parent && git archive <commit> | tar -x -C .chipcheck/parent
    python3 tools/ab_pass.py .chipcheck/parent [--cpu]

It prints one JSON line per run.
"""
import collections
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(root: str, device: str) -> dict:
    sys.path.insert(0, root)
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from cudatracerlib_tpu_torch.render import path_tracer as pt
    from cudatracerlib_tpu_torch.scene.shapes import cornell_box, glossy_scene

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n[str(func)] += 1
            return func(*args, **(kwargs or {}))

    gpu = device == "cuda"
    size, spp, depth = (256, 16, 5) if gpu else (16, 1, 3)
    cfg = pt.PTConfig(max_depth=depth)
    out = dict(root=root, device=torch.cuda.get_device_name(0) if gpu else "cpu")
    for name, make in (("cornell", cornell_box), ("glossy", glossy_scene)):
        scene = make(device=device)

        def run():
            return pt.render_counted(scene, size, size, spp, 7, cfg)  # noqa: B023

        img, rays = run()
        with Count() as cam:
            pt.camera_rays(scene, size, size, spp, 7)
        with Count() as ops:
            run()
        row = dict(camera_ops=sum(cam.n.values()), pass_ops=sum(ops.n.values()),
                   rays=int(rays), mean=float(img.mean()))
        if gpu:
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            row["launches"] = sum(e.device_type == DeviceType.CUDA for e in prof.events())
            walls = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            row["wall_ms"] = sorted(walls)[2]
        out[name] = row
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
