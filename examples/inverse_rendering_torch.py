#!/usr/bin/env python
"""Inverse rendering demo on the PyTorch/CUDA port: recover wall albedos and
light radiance from a target (the loop of examples/inverse_rendering.py, in
torch autograd through `cudatracerlib_tpu_torch.entry.inverse_step`).

Optimizes texture colors and light emission by gradient descent on an L2
image loss: the target is the canonical Cornell box, the start grey walls
and a dim light. Renders on the card; `--device cpu` runs the kernels'
plain versions (for tests).

Usage:
  python examples/inverse_rendering_torch.py [--steps 60] [--device cuda]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from cudatracerlib_tpu_torch.entry import grey_start, inverse_step
    from cudatracerlib_tpu_torch.render.path_tracer import PTConfig, render
    from cudatracerlib_tpu_torch.scene.shapes import cornell_box

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the example renders on the card (--device cpu for tests)")
    W = H = args.size
    cfg = PTConfig(max_depth=4, rr_start=99)

    # ground truth: the canonical Cornell box
    with torch.no_grad():
        target = render(cornell_box(device=args.device), W, H, args.spp, 0, cfg)

    # start: gray walls, dim light
    scene = grey_start(device=args.device)
    params = (scene.textures.color_a, scene.lights.radiance)

    losses = []
    t0 = time.time()
    for step in range(args.steps):
        out = inverse_step(scene, params, target, step + 1, W, H, args.spp, cfg)
        params = out.params
        losses.append(float(out.loss))
        if step % 10 == 0 or args.steps <= 10:
            print(f"step {step:3d}: loss {losses[-1]:.6f}", flush=True)

    print(f"optimized in {time.time() - t0:.1f}s")
    ca = np.clip(params[0].detach().cpu().numpy(), 0, 1)
    print("recovered white wall:", ca[0], "(true ~0.725,0.71,0.68)")
    print("recovered red wall:  ", ca[1], "(true ~0.63,0.065,0.05)")
    print("recovered radiance:  ", params[1].detach().cpu().numpy()[0], "(true 17,12,4)")
    err = abs(ca[1][0] - 0.63)
    print("red-channel error:", err)
    print("losses:", " ".join(f"{x:.6f}" for x in losses))
    return losses


if __name__ == "__main__":
    main()
