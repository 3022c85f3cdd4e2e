"""The pinned small renders that chip_smoke.py phase 23 gates the card's
texture and subsurface renders on (TEXTURE_PINS there), each at 64x64,
4 spp:

  deluxe       render_counted(cornell_box_deluxe(), seed 3, depth 5): mean and rays;
  deluxe_wf    render_wavefront_counted of the same: mean and rays;
  maps         render_counted of tools/texture_cases.py's maps case (an IMAGE
               albedo through the ray cone, a height map with parallax, an
               alpha-tested quad), seed 3, depth 5: mean and rays;
  sss_3, sss_4, sss_5   render_counted of tests/test_sss.py's Marble sphere
               (texture_cases.sss_case) at depth 8, rr_start 99, 24 walk
               steps, seeds 3, 4 and 5, and their spread (max - min) over
               the mean of seed 3, the tolerance's unit.

By default the JAX package computes them on the CPU; with --port the port
computes the same renders on the CPU, for the agreement the gates rest on.
Each run imports one package only. Run from the root of the repository
(JAX about a minute; the port about a minute):
    JAX_PLATFORMS=cpu python tools/texture_reference_mean.py [--port] [case ...]
"""
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import texture_cases  # noqa: E402

W = H = 64
SPP, SEED, DEPTH = 4, 3, 5
SSS_CFG = dict(max_depth=8, rr_start=99, sss_steps=24)
SSS_SEEDS = (3, 4, 5)


def cases(port: bool):
    """{name: a function returning (image, rays)}."""
    if port:
        from cudatracerlib_tpu_torch.render import path_tracer, wavefront
        from cudatracerlib_tpu_torch.scene import material_lib
        from cudatracerlib_tpu_torch.scene.scene import Materials, build_scene
        from cudatracerlib_tpu_torch.scene.sensors import Camera
        from cudatracerlib_tpu_torch.scene.shapes import cornell_box_deluxe
        from cudatracerlib_tpu_torch.scene.textures import Textures

        kw = dict(device="cpu")
    else:
        from cudatracerlib_tpu.render import path_tracer, wavefront
        from cudatracerlib_tpu.scene import material_lib
        from cudatracerlib_tpu.scene.scene import Materials, build_scene
        from cudatracerlib_tpu.scene.sensors import Camera
        from cudatracerlib_tpu.scene.shapes import cornell_box_deluxe
        from cudatracerlib_tpu.scene.textures import Textures

        kw = {}

    def build(case):
        return texture_cases.build(case, build_scene, Materials, Textures, Camera, **kw)

    cfg = path_tracer.PTConfig(max_depth=DEPTH)
    sss_cfg = path_tracer.PTConfig(**SSS_CFG)
    out = {
        "deluxe": lambda: path_tracer.render_counted(cornell_box_deluxe(**kw), W, H, SPP, SEED,
                                                     cfg),
        "deluxe_wf": lambda: wavefront.render_wavefront_counted(cornell_box_deluxe(**kw), W, H,
                                                                SPP, SEED, cfg),
        "maps": lambda: path_tracer.render_counted(build(texture_cases.maps_case()), W, H, SPP,
                                                   SEED, cfg),
    }
    for seed in SSS_SEEDS:
        out[f"sss_{seed}"] = lambda seed=seed: path_tracer.render_counted(
            build(texture_cases.sss_case(material_lib.sss_record)), W, H, SPP, seed, sss_cfg)
    return out


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    port = "--port" in sys.argv[1:]
    who = "port (CPU)" if port else "JAX package (CPU)"
    if port:
        import torch

        torch.set_num_threads(os.cpu_count() or 1)
    sss = {}
    for name, run in cases(port).items():
        if args and name not in args:
            continue
        t0 = time.perf_counter()
        img, rays = run()
        img = np.asarray(img)
        if name.startswith("sss_"):
            sss[name] = float(img.mean())
        print(f"{who} {name}: mean {img.mean():.9f}, rays {int(rays)}, finite "
              f"{bool(np.isfinite(img).all())}, {time.perf_counter() - t0:.1f} s", flush=True)
    if len(sss) == len(SSS_SEEDS):
        spread = (max(sss.values()) - min(sss.values())) / sss[f"sss_{SSS_SEEDS[0]}"]
        print(f"{who} sss seeds {SSS_SEEDS}: spread {spread:.6f} of the seed-{SSS_SEEDS[0]} mean")


if __name__ == "__main__":
    main()
