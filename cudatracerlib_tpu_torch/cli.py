"""The port's render CLI (port of examples/render_cli.py, the counterpart of
the reference's `main.cpp` demo app: data_path scene.xml n_passes
{direct,PT,PT_Wave,BDPT,PPPM}, main.cpp:67).

Usage:
  python -m cudatracerlib_tpu_torch.cli SCENE N_PASSES TRACER [--size 256] [--spp 4]
      [--depth 6] [--out out.png] [--filter box] [--filter-radius 1.5]
      [--checkpoint ckpt.npz] [--device cuda]

SCENE: a Mitsuba .xml file, an .obj file, or one of the built-ins
       {cornell, furnace, bigscene}.
TRACER: direct | PT | PT_Spectral | PT_Wave | BDPT | VCM | PPPM | SPPM | guided | LT | fast

It renders on the card; `--device cpu` runs the kernels' plain versions on
the CPU (for tests). Each pass prints its wall time; the running mean of the
passes is written as a PNG. With `--checkpoint`, the running mean and the
pass count are saved through `utils/checkpoint` (the JAX package's file
format) every CHECKPOINT_EVERY passes, as the JAX CLI does, and after the
last one; a run given an existing checkpoint resumes after its last pass:
2 passes resumed to 4 give the image of 4 straight passes. SPPM keeps its photon state in
memory only, so a resumed SPPM run starts a fresh state (as the JAX CLI).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

TRACERS = ["direct", "PT", "PT_Wave", "BDPT", "VCM", "PPPM", "SPPM", "guided", "LT", "fast",
           "PT_Spectral"]
FILTERS = ["box", "gaussian", "mitchell", "lanczos", "triangle"]
CHECKPOINT_EVERY = 8     # passes between checkpoints (examples/render_cli.py's)


def build_scene(name: str, device="cuda"):
    """A built-in scene, a Mitsuba XML or an OBJ (lit by a white constant
    environment, the camera looking at it from -y) on `device`."""
    if name == "cornell":
        from .scene.shapes import cornell_box

        return cornell_box(device=device)
    if name == "furnace":
        from .scene.shapes import furnace_scene

        return furnace_scene(device=device)
    if name == "bigscene":
        from .scene.bigscene import build_big_scene

        return build_big_scene(device=device)
    if name.endswith(".xml"):
        from .io.mitsuba import load_mitsuba

        return load_mitsuba(name, device=device)
    if name.endswith(".obj"):
        from .io.obj import load_obj, obj_to_scene_arrays
        from .scene import lights as L
        from .scene.scene import Materials, build_scene as bs
        from .scene.sensors import Camera
        from .scene.textures import Textures

        mesh = load_obj(name)
        v, n, uv, mid, mats, texs = obj_to_scene_arrays(mesh)
        center = v.reshape(-1, 3).mean(0)
        ext = np.abs(v.reshape(-1, 3) - center).max()
        cam = Camera.look_at(center + np.array([0, -3 * ext, ext]), center)
        return bs(v, n, uv, mid, Materials.build(mats), Textures.build(texs),
                  [{"type": L.CONSTANT_ENV, "radiance": [1.0, 1.0, 1.0]}], cam, device=device)
    raise SystemExit(f"unknown scene {name!r}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m cudatracerlib_tpu_torch.cli")
    ap.add_argument("scene")
    ap.add_argument("passes", type=int)
    ap.add_argument("tracer", choices=TRACERS)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--out", default="out.png")
    ap.add_argument("--filter", default="box", choices=FILTERS,
                    help="reconstruction filter applied at accumulation "
                         "time (filter-importance splatting)")
    ap.add_argument("--filter-radius", type=float, default=1.5)
    ap.add_argument("--checkpoint", default=None,
                    help="npz path for restartable accumulation")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu runs the kernels' plain versions (tests)")
    return ap.parse_args(argv)


def render_pass(tracer: str, scene, W: int, H: int, spp: int, p: int, cfg, state):
    """One pass of `tracer` at pass index / seed p: (image, new state);
    `state` is the SPPM state or the trained guiding."""
    if tracer in ("direct", "PT"):
        from .render.path_tracer import render

        return render(scene, W, H, spp, p, cfg), state
    if tracer == "PT_Spectral":
        from .render.spectral import render_spectral

        return render_spectral(scene, W, H, spp, p, cfg), state
    if tracer == "PT_Wave":
        from .render.wavefront import render_wavefront

        return render_wavefront(scene, W, H, spp, p, cfg), state
    if tracer == "BDPT":
        from .render.bdpt import BDPTConfig, render_bdpt

        return render_bdpt(scene, W, H, spp, p, BDPTConfig(base=cfg)), state
    if tracer == "VCM":
        from .render.vcm import VCMConfig, render_vcm

        return render_vcm(scene, W, H, spp, p, p, VCMConfig(base=cfg)), state
    if tracer == "PPPM":
        from .render.ppm import PPMConfig, render_ppm_pass

        return render_ppm_pass(scene, W, H, spp, p, p, PPMConfig(base=cfg)), state
    if tracer == "SPPM":
        from .render.sppm import SPPMConfig, render_sppm_pass

        return render_sppm_pass(scene, W, H, p, state, SPPMConfig(base=cfg))
    if tracer == "guided":
        from .render.guided import render_guided

        return render_guided(scene, state, W, H, spp, p, cfg), state
    if tracer == "LT":
        from .render.light_tracer import render_light_trace

        return render_light_trace(scene, W, H, W * H * spp, p, cfg), state
    from .render.realtime import render_fast

    return render_fast(scene, W, H, p)[0], state


def main(argv=None) -> int:
    args = parse_args(argv)
    from .io.image_io import write_png
    from .render.path_tracer import PTConfig
    from .utils.checkpoint import load_pytree, save_pytree
    from .utils.timing import PerformanceTimer

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the CLI renders on the card (--device cpu for tests)")
    timer = PerformanceTimer()
    t0 = time.perf_counter()
    scene = build_scene(args.scene, device=args.device)
    print(f"scene {args.scene}: {int(scene.bvh.woop.shape[0])} Woop rows, built in "
          f"{time.perf_counter() - t0:.2f} s on {args.device}", flush=True)
    W = H = args.size
    cfg = PTConfig(max_depth=1 if args.tracer == "direct" else args.depth,
                   rec_filter=FILTERS.index(args.filter), rec_radius=args.filter_radius)

    acc = torch.zeros(H, W, 3, device=args.device)
    start_pass = 0
    if args.checkpoint and os.path.exists(args.checkpoint):
        saved = load_pytree(args.checkpoint, {"acc": acc, "n": np.int32(0)})
        acc, start_pass = saved["acc"], int(saved["n"])
        print(f"resumed at pass {start_pass}", flush=True)

    state = None
    with torch.no_grad():
        if args.tracer == "guided":
            from .render.guided import make_guiding, train_guiding

            state = make_guiding(scene, res=8)
            for i in range(3):
                state = train_guiding(scene, state, 1 << 15, i, cfg)
            print("guiding trained (3 photon batches)", flush=True)

        for p in range(start_pass, args.passes):
            t0 = time.perf_counter()
            with timer.measure("pass", sync=True, sync_value=acc):
                img, state = render_pass(args.tracer, scene, W, H, args.spp, p, cfg, state)
                if args.tracer == "SPPM":
                    acc = img  # SPPM develops its own running estimate
                else:
                    acc = acc + (img - acc) / (p + 1)
            dt = time.perf_counter() - t0
            rays = W * H * args.spp * cfg.max_depth * 2
            print(f"pass {p + 1}/{args.passes}: {dt * 1e3:.0f} ms "
                  f"(~{rays / dt / 1e6:.1f} Mrays/s)", flush=True)
            if args.checkpoint and ((p + 1) % CHECKPOINT_EVERY == 0
                                    or p + 1 == args.passes):
                save_pytree(args.checkpoint, {"acc": acc, "n": np.int32(p + 1)})

    write_png(args.out, torch.clamp(acc, 0, 1))
    print(f"wrote {args.out}")
    print(timer.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
