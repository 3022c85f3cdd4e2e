"""The pinned bench-config-3 render that chip_smoke.py gates the port's card
render on (REF_BIG_MEAN there), at a size the JAX package's CPU path
renders in under a minute:

    render_wavefront_counted(build_big_scene(100_000), 64, 64, 4, seed 3,
                             PTConfig(max_depth=5))

By default the JAX package computes it on the CPU (its scene cache goes to
a temporary directory); with --port the port computes the same render on
the CPU, for the agreement the gate's tolerance rests on. Each run imports
one package only. Run from the root of the repository:
    JAX_PLATFORMS=cpu python tools/bigscene_reference_mean.py [--port]
"""
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_TRIS, W, H, SPP, SEED, DEPTH = 100_000, 64, 64, 4, 3, 5


def main():
    t0 = time.perf_counter()
    if "--port" in sys.argv[1:]:
        from cudatracerlib_tpu_torch.render.path_tracer import PTConfig
        from cudatracerlib_tpu_torch.render.wavefront import render_wavefront_counted
        from cudatracerlib_tpu_torch.scene.bigscene import build_big_scene

        scene = build_big_scene(N_TRIS, device="cpu")
        who = "port (CPU)"
    else:
        os.environ["CUDATRACERLIB_TPU_SCENE_CACHE"] = tempfile.mkdtemp()
        from cudatracerlib_tpu.render.path_tracer import PTConfig
        from cudatracerlib_tpu.render.wavefront import render_wavefront_counted
        from cudatracerlib_tpu.scene.bigscene import build_big_scene

        scene = build_big_scene(N_TRIS)
        who = "JAX package (CPU)"
    n_tris = int(scene.shading.verts.shape[0])
    img, rays = render_wavefront_counted(scene, W, H, SPP, SEED, PTConfig(max_depth=DEPTH))
    img = np.asarray(img)
    print(f"{who}: build_big_scene({N_TRIS}) {n_tris} Woop rows, {W}x{H} spp {SPP} seed {SEED} "
          f"depth {DEPTH}: mean {img.mean():.9f}, rays {int(rays)}, finite "
          f"{bool(np.isfinite(img).all())}, {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
