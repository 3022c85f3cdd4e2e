"""The pinned renders of the bidirectional engines that chip_smoke.py gates
the port's card renders on (REF_BDPT_MEAN, REF_LT_MEAN, REF_VCM_MEAN
there), on the caustic scene at 64x64 with one light path a sample:

    render_bdpt_counted(caustic_scene(), 64, 64, 4, seed 3, BDPTConfig())
    render_light_trace(caustic_scene(), 64, 64, 16384 paths, seed 3)
    render_vcm(caustic_scene(), 64, 64, 4, seed 3, pass 1, VCMConfig())

By default the JAX package computes them on the CPU; with --port the port
computes the same renders on the CPU, for the agreement the gates'
tolerances rest on. Each run imports one package only. Run from the root
of the repository (JAX on the CPU, about a minute):
    JAX_PLATFORMS=cpu python tools/bdpt_reference_mean.py [--port]
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

W = H = 64
SPP, SEED, PASS = 4, 3, 1


def main():
    if "--port" in sys.argv[1:]:
        from cudatracerlib_tpu_torch.render import bdpt, light_tracer, vcm
        from cudatracerlib_tpu_torch.scene.shapes import caustic_scene

        scene, who = caustic_scene(device="cpu"), "port (CPU)"
    else:
        from cudatracerlib_tpu.render import bdpt, light_tracer, vcm
        from cudatracerlib_tpu.scene.shapes import caustic_scene

        scene, who = caustic_scene(), "JAX package (CPU)"
    runs = (("bdpt", lambda: bdpt.render_bdpt_counted(scene, W, H, SPP, SEED, bdpt.BDPTConfig())),
            ("lt", lambda: (light_tracer.render_light_trace(scene, W, H, W * H * SPP, SEED),
                            None)),
            ("vcm", lambda: (vcm.render_vcm(scene, W, H, SPP, SEED, PASS, vcm.VCMConfig()),
                             None)))
    for name, run in runs:
        t0 = time.perf_counter()
        img, rays = run()
        img = np.asarray(img)
        extra = "" if rays is None else f", rays {int(rays)}"
        print(f"{who} {name} {W}x{H} spp {SPP} seed {SEED}: mean {img.mean():.9f}{extra}, "
              f"finite {bool(np.isfinite(img).all())}, {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
