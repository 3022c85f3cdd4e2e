"""The pins chip_smoke.py phase 25 gates the port's spectral, guided,
realtime and AOV engines on (ENGINE_PINS and the REF_* values there), at
the sizes of tools/engines_cases.PIN:

  spectral_cornell    render_spectral(cornell_box(), 64, 64, 4, 3, PTConfig(max_depth=5))
  spectral_caustic    the same on caustic_scene() with cauchy_c = 0.03 on its glass
  grad_radiance       jax.grad of render_spectral(...).mean() in lights.radiance
                      (Cornell 16x16, 8 spp, seed 1, depth 4, rr_start 99)
  grad_cauchy         value and grad of the ramp-weighted mean in cauchy_c at 0.01
                      (the caustic scene 16x16, 4 spp, seed 3, depth 5, rr_start 99)
  spectral_vol        render_spectral_vol(cornell_box(), the homogeneous medium,
                      64, 64, 4, seed, PTConfig(max_depth=6)) at seeds 3, 4, 5:
                      seed 3's mean and (max - min) / mean over the three
  guided              make_guiding(caustic, res=8), two train_guiding batches of
                      2^14 photons (seeds 0, 1; depth 5, rr_start 2): the
                      histogram's sum; then render_guided 64x64, 4 spp, seed 3,
                      depth 5, rr_start 99: its mean
  game                render_game on Cornell 64x64, frames 0-7 (seed = frame),
                      GTConfig(): the last frame's mean
  aovs                render_aovs(cornell_box(), 256, 256, 0): each channel's mean

By default the JAX package computes them on the CPU; with --port the port
computes them on the CPU, for the agreement the gates rest on. Each run
imports one package only. Run from the root of the repository:
    JAX_PLATFORMS=cpu python tools/engines_reference_mean.py [--port]
"""
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))
import engines_cases as ec  # noqa: E402


def _packages(port: bool):
    """(modules namespace, device kwargs, grad helpers) of one package."""
    if port:
        import torch

        from cudatracerlib_tpu_torch.render import guided, path_tracer, prim_tracer, realtime
        from cudatracerlib_tpu_torch.render import spectral
        from cudatracerlib_tpu_torch.scene import media, shapes

        dev = dict(device="cpu")

        def grad_rad(scene, fn):
            rad = scene.lights.radiance.clone().requires_grad_()
            fn(scene._replace(lights=scene.lights._replace(radiance=rad))).backward()
            return rad.grad.numpy()

        def grad_c(fn, c):
            c = torch.tensor(c, requires_grad=True)
            loss = fn(c)
            loss.backward()
            return float(loss), float(c.grad)

        ramp = lambda w: torch.from_numpy(ec.weight_ramp(w))  # noqa: E731
    else:
        import jax
        import jax.numpy as jnp

        from cudatracerlib_tpu.render import guided, path_tracer, prim_tracer, realtime
        from cudatracerlib_tpu.render import spectral
        from cudatracerlib_tpu.scene import media, shapes

        dev = {}

        def grad_rad(scene, fn):
            return np.asarray(jax.grad(lambda r: fn(scene._replace(
                lights=scene.lights._replace(radiance=r))))(scene.lights.radiance))

        def grad_c(fn, c):
            v, g = jax.value_and_grad(fn)(jnp.float32(c))
            return float(v), float(g)

        ramp = lambda w: jnp.asarray(ec.weight_ramp(w))  # noqa: E731
    return (guided, path_tracer, prim_tracer, realtime, spectral, media, shapes, dev, grad_rad,
            grad_c, ramp)


def main():
    port = "--port" in sys.argv[1:]
    (guided, pt, prim, rt, sr, media, shapes, dev, grad_rad, grad_c,
     ramp) = _packages(port)
    who = "port (CPU)" if port else "JAX (CPU)"
    t0 = time.perf_counter()
    cornell, caustic = shapes.cornell_box(**dev), shapes.caustic_scene(**dev)
    disp = ec.with_cauchy(caustic, ec.DISP_C)
    PTC = pt.PTConfig

    p = ec.PIN["spectral"]
    for name, scene in (("spectral_cornell", cornell), ("spectral_caustic", disp)):
        img = sr.render_spectral(scene, p["size"], p["size"], p["spp"], p["seed"],
                                 PTC(max_depth=p["max_depth"]))
        print(f"{who} {name}: mean {float(np.asarray(img).mean()):.9f}", flush=True)

    q = ec.PIN["grad_radiance"]
    cfg = PTC(max_depth=q["max_depth"], rr_start=q["rr_start"])
    g = grad_rad(cornell, lambda s: sr.render_spectral(s, q["size"], q["size"], q["spp"],
                                                       q["seed"], cfg).mean())
    print(f"{who} grad_radiance: {np.asarray(g).reshape(-1).tolist()}", flush=True)
    q = ec.PIN["grad_cauchy"]
    cfg = PTC(max_depth=q["max_depth"], rr_start=q["rr_start"])
    loss, gc = grad_c(lambda c: (sr.render_spectral(ec.with_cauchy(caustic, c), q["size"],
                                                    q["size"], q["spp"], q["seed"], cfg)
                                 * ramp(q["size"])).mean(), q["c"])
    print(f"{who} grad_cauchy: loss {loss:.9f}, d/dc {gc:.9g}", flush=True)

    q = ec.PIN["spectral_vol"]
    med = media.Media.build(ec.cornell_medium(cornell), **dev)
    means = [float(np.asarray(sr.render_spectral_vol(cornell, med, q["size"], q["size"], q["spp"],
                                                     s, PTC(max_depth=q["max_depth"]))).mean())
             for s in q["seeds"]]
    print(f"{who} spectral_vol: seed {q['seeds'][0]} mean {means[0]:.9f}, seeds {q['seeds']} "
          f"{[round(m, 9) for m in means]}, spread {(max(means) - min(means)) / means[0]:.6f}",
          flush=True)

    q = ec.PIN["guided"]
    gd = guided.make_guiding(caustic, res=q["res"])
    for i in range(q["batches"]):
        gd = guided.train_guiding(caustic, gd, q["n_photons"], i, PTC(**ec.TRAIN_CFG))
    img = guided.render_guided(caustic, gd, q["size"], q["size"], q["spp"], q["seed"],
                               PTC(**ec.GUIDED_CFG))
    print(f"{who} guided: histogram sum {float(np.asarray(gd.hist).sum()):.7f}, "
          f"{int((np.asarray(gd.hist).sum(1) > 0).sum())} cells with data, image mean "
          f"{float(np.asarray(img).mean()):.9f}", flush=True)

    q = ec.PIN["game"]
    psf = None
    for f in range(q["frames"]):
        frame, psf = rt.render_game(cornell, psf, q["size"], q["size"], f)
    print(f"{who} game: frame {q['frames'] - 1} mean {float(np.asarray(frame).mean()):.9f}",
          flush=True)

    q = ec.PIN["aovs"]
    aovs = prim.render_aovs(cornell, q["size"], q["size"], q["seed"])
    print(f"{who} aovs: " + ", ".join(f'"{k}": {float(np.asarray(v).mean()):.9g}'
                                      for k, v in sorted(aovs.items())), flush=True)
    print(f"{who} done in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
