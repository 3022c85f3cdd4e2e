"""The pins chip_smoke.py phase 26 (c) gates the port's Mitsuba loader on
(IO_PINS there): tools/io_cases.py's media-and-maps scene (a nested coating,
a PNG bump map, the sunsky, a heterogeneous `.vol` medium inside a shape),
written to a temporary directory and loaded by the package's
`load_mitsuba_full`, rendered at tools/io_cases.PIN's size:

  render      render(scene, 64, 64, 4, seed 3, PTConfig(max_depth=5)): the mean
  render_vol  render_vol(scene, media, 64, 64, 4, seed 3, PTConfig(max_depth=6)):
              the mean, at seeds 3, 4 and 5: seed 3's mean and (max - min) /
              mean over the three (the spread the volume gate is set from)

By default the JAX package computes them on the CPU; with --port the port
computes them on the CPU, for the agreement the gates rest on. Each run
imports one package only. Run from the root of the repository:
    JAX_PLATFORMS=cpu python tools/io_reference_mean.py [--port]
"""
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))
import io_cases as ic  # noqa: E402


def main(port: bool):
    if port:
        from cudatracerlib_tpu_torch.io.mitsuba import load_mitsuba_full
        from cudatracerlib_tpu_torch.render.path_tracer import PTConfig, render
        from cudatracerlib_tpu_torch.render.volpath import render_vol

        load = lambda p: load_mitsuba_full(p, device="cpu")  # noqa: E731
    else:
        from cudatracerlib_tpu.io.mitsuba import load_mitsuba_full
        from cudatracerlib_tpu.render.path_tracer import PTConfig, render
        from cudatracerlib_tpu.render.volpath import render_vol

        load = load_mitsuba_full
    p = ic.PIN
    n = p["size"]
    with tempfile.TemporaryDirectory() as d:
        scene, media = load(ic.write_media_maps(d))
    t0 = time.time()
    img = np.asarray(render(scene, n, n, p["spp"], p["seed"], PTConfig(max_depth=p["max_depth"])))
    print(f"render {float(img.mean()):.9f} ({time.time() - t0:.1f} s)", flush=True)
    means = []
    for seed in (p["seed"], p["seed"] + 1, p["seed"] + 2):
        t0 = time.time()
        vol = np.asarray(render_vol(scene, media, n, n, p["spp"], seed,
                                    PTConfig(max_depth=p["vol_depth"])))
        assert np.isfinite(vol).all()
        means.append(float(vol.mean()))
        print(f"render_vol seed {seed}: {means[-1]:.9f} ({time.time() - t0:.1f} s)", flush=True)
    print(f"render_vol {means[0]:.9f}, seeds {p['seed']}-{p['seed'] + 2} spread "
          f"{(max(means) - min(means)) / means[0]:.6f}")


if __name__ == "__main__":
    main("--port" in sys.argv[1:])
