"""The pins that chip_smoke.py phase 22 gates the port's sharded paths on
(REF_SHARD_* there), each on one device (a 1 x 1 mesh), as the card's
one-rank runs are:

  render  `make_sharded_render` of the Cornell box at bench config 1's size
          (256x256, 16 spp, depth 5, seed 3), the config specialized to the
          scene as bench.py runs it: the image mean and the rays traced;
  train   `make_train_step` at examples/inverse_rendering.py's size (64x64,
          8 spp, depth 4, rr_start 99, lr 0.05): the target is `render` of
          the Cornell box at seed 0, the start the example's grey walls and
          dim light, one step at seed 1: the loss, and the parameters' update
          (-lr times the gradient, which pins its scale);
  ppm     `make_sharded_ppm` at chip_smoke.py's PPM_PIN size (the caustic
          scene, 64x64, 4 spp, 2^15 photons, seed 3, pass 1, grid_res 64 as
          the sharded pass keeps it):
            capped      the pass as the JAX package computes it on the CPU
                        (the query-major estimate, 128 neighbours a query);
            exhaustive  the same photons and eye lanes with every photon
                        within the radius summed, the estimate the port's
                        photon-major kernel computes on the card: the
                        neighbour cap lifted above every query's candidate
                        count, on a grid whose cells are no smaller than the
                        radius (at grid_res 64 the caustic scene's cells are
                        0.0469 high against a radius of 0.0655, so the 27
                        cells around a query miss part of the sphere; that
                        figure is printed too). The eye pass runs in chunks
                        of lanes: the lifted cap's (B, 27, K) table does not
                        fit at once. On one device the sharded pass traces
                        the photons at the seed itself, so this is
                        tools/ppm_reference_mean.py's pass.

By default the JAX package computes them on the CPU; with --port the port
computes render, train and the capped ppm on one spawned CPU rank, for the
agreement the gates rest on. Run from the root of the repository (JAX on
the CPU about 70 s, the port about 90 s):
    JAX_PLATFORMS=cpu python tools/sharded_reference_mean.py [--port] [render|train|ppm ...]
"""
import os
import sys
import time
from functools import partial

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RENDER = dict(width=256, height=256, spp=16, seed=3, max_depth=5)
TRAIN = dict(width=64, height=64, spp=8, max_depth=4, rr_start=99, lr=0.05, target_seed=0,
             seed=1)
PPM = dict(width=64, height=64, spp=4, seed=3, pass_idx=1, n_photons=1 << 15)
GREY = dict(light_radiance=(5.0, 5.0, 5.0), white=(0.5, 0.5, 0.5), red=(0.5, 0.5, 0.5),
            green=(0.5, 0.5, 0.5))


def _report_train(loss, ca0, rad0, ca1, rad1):
    print(f"train: loss {loss:.9g}")
    print(f"train: update of color_a {np.array2string(ca1 - ca0, precision=9, separator=', ')}")
    print(f"train: update of radiance {np.array2string(rad1 - rad0, precision=9, separator=', ')}")


def jax_render():
    import jax.numpy as jnp

    from cudatracerlib_tpu.parallel.shard import make_mesh, make_sharded_render
    from cudatracerlib_tpu.render.path_tracer import PTConfig, specialize_config
    from cudatracerlib_tpu.scene.shapes import cornell_box

    r = RENDER
    scene = cornell_box()
    cfg = specialize_config(scene, PTConfig(max_depth=r["max_depth"]))
    fn = make_sharded_render(make_mesh(1, 1), r["width"], r["height"], r["spp"], cfg,
                             with_stats=True)
    img, n_rays = fn(scene, jnp.uint32(r["seed"]))
    img = np.asarray(img)
    print(f"render: mean {img.mean():.9f} rays {int(n_rays)} finite {bool(np.isfinite(img).all())}")


def jax_train():
    import jax.numpy as jnp

    from cudatracerlib_tpu.parallel.shard import make_mesh, make_train_step
    from cudatracerlib_tpu.render.path_tracer import PTConfig, render, specialize_config
    from cudatracerlib_tpu.scene.shapes import cornell_box

    t = TRAIN
    W, H = t["width"], t["height"]
    truth = cornell_box()
    cfg = specialize_config(truth, PTConfig(max_depth=t["max_depth"], rr_start=t["rr_start"]))
    target = render(truth, W, H, t["spp"], t["target_seed"], cfg)
    start = cornell_box(**GREY)
    step = make_train_step(make_mesh(1, 1), W, H, t["spp"], target, lr=t["lr"], config=cfg)
    new, loss = step(start, jnp.uint32(t["seed"]))
    _report_train(float(loss), np.asarray(start.textures.color_a),
                  np.asarray(start.lights.radiance), np.asarray(new.textures.color_a),
                  np.asarray(new.lights.radiance))


def jax_ppm():
    import jax
    import jax.numpy as jnp

    from cudatracerlib_tpu.image import film as film_mod
    from cudatracerlib_tpu.parallel.shard import make_mesh, make_sharded_ppm
    from cudatracerlib_tpu.render import ppm
    from cudatracerlib_tpu.render.path_tracer import specialize_config
    from cudatracerlib_tpu.scene.shapes import caustic_scene
    from tools.ppm_reference_mean import max_box_count

    p = PPM
    W, H, spp = p["width"], p["height"], p["spp"]
    scene = caustic_scene()
    config = ppm.PPMConfig(n_photons=p["n_photons"])
    radius = ppm.progressive_radius(jnp.float32(config.radius0), jnp.float32(p["pass_idx"]))
    seed = jnp.uint32(p["seed"])
    capped = np.asarray(make_sharded_ppm(make_mesh(1, 1), W, H, spp, config)(scene, seed, radius))
    print(f"ppm: capped (max_gather {config.max_gather}, grid_res {config.grid_res}) mean "
          f"{capped.mean():.9f} finite {bool(np.isfinite(capped).all())}")

    # the one-device shard body (parallel/shard.py:170-195) with the cap lifted, in chunks
    base = specialize_config(scene, config.base)
    assert not ppm.ppm_uses_kernel(base), "run on the CPU: the query-major branch"
    pm = ppm.trace_photons(scene, config.n_photons, seed ^ jnp.uint32(0), base)
    n_px = W * H
    pixel_id = jnp.tile(jnp.arange(n_px, dtype=jnp.uint32), spp)
    sample_idx = jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), n_px)
    extent = float(np.min(np.asarray(scene.bvh.world_max) - np.asarray(scene.bvh.world_min)))
    clamp_res = max(4, min(config.grid_res, int((extent + 2e-3) / max(config.radius0, 1e-6))))
    for label, res in ((f"uncapped at grid_res {config.grid_res}", config.grid_res),
                       (f"exhaustive (uncapped, grid_res {clamp_res})", clamp_res)):
        cfg = config._replace(base=base, grid_res=res)
        grids = ppm.build_photon_grids(scene, pm, cfg)
        cap = max(max_box_count(g) for g in grids)
        cfg = cfg._replace(max_gather=cap)
        eye = jax.jit(partial(ppm.ppm_eye_pass, width=W, height=H, config=cfg))
        chunk = max(256, (1 << 25) // (27 * cap)) // 256 * 256
        film = film_mod.Film.create(H, W)
        for s in range(0, n_px * spp, chunk):
            f = eye(scene, pm, grids, pixel_id[s:s + chunk], sample_idx[s:s + chunk], seed, radius)
            film = film._replace(rgb=film.rgb + f.rgb, weight=film.weight + f.weight)
        img = np.asarray(film_mod.develop(film))
        print(f"ppm: {label}, max_gather {cap}: mean {img.mean():.9f}")


def _port_rank(rank, device, cases):
    """The port's counterparts on one CPU rank: printed lines."""
    import torch

    from cudatracerlib_tpu_torch.parallel import shard
    from cudatracerlib_tpu_torch.render import ppm
    from cudatracerlib_tpu_torch.render.path_tracer import PTConfig, render
    from cudatracerlib_tpu_torch.scene.shapes import caustic_scene, cornell_box

    mesh = shard.make_mesh(1, 1, device=device)
    lines = []
    if "render" in cases:
        r = RENDER
        fn = shard.make_sharded_render(mesh, r["width"], r["height"], r["spp"],
                                       PTConfig(max_depth=r["max_depth"]), with_stats=True)
        img, n_rays = fn(cornell_box(device=device), r["seed"])
        lines.append(f"render: mean {float(img.mean()):.9f} rays {int(n_rays)} finite "
                     f"{bool(torch.isfinite(img).all())}")
    if "train" in cases:
        t = TRAIN
        W, H = t["width"], t["height"]
        cfg = PTConfig(max_depth=t["max_depth"], rr_start=t["rr_start"])
        target = render(cornell_box(device=device), W, H, t["spp"], t["target_seed"], cfg)
        start = cornell_box(**GREY, device=device)
        step = shard.make_train_step(mesh, W, H, t["spp"], target, lr=t["lr"], config=cfg)
        new, loss = step(start, t["seed"])
        lines.append((float(loss), start.textures.color_a.numpy(), start.lights.radiance.numpy(),
                      new.textures.color_a.numpy(), new.lights.radiance.numpy()))
    if "ppm" in cases:
        p = PPM
        config = ppm.PPMConfig(n_photons=p["n_photons"])
        fn = shard.make_sharded_ppm(mesh, p["width"], p["height"], p["spp"], config)
        img = fn(caustic_scene(device=device), p["seed"],
                 ppm.progressive_radius(config.radius0, p["pass_idx"]))
        lines.append(f"ppm: capped (max_gather {config.max_gather}, grid_res {config.grid_res}) "
                     f"mean {float(img.mean()):.9f} finite {bool(torch.isfinite(img).all())}")
    return lines


def main(argv):
    port = "--port" in argv
    cases = [a for a in argv if not a.startswith("--")] or ["render", "train", "ppm"]
    t0 = time.perf_counter()
    if port:
        from cudatracerlib_tpu_torch.parallel.distributed import run_ranks

        for line in run_ranks(_port_rank, 1, (cases,), device="cpu", timeout=3600)[0]:
            if isinstance(line, tuple):
                _report_train(*line)
            else:
                print(line)
    else:
        for case in cases:
            {"render": jax_render, "train": jax_train, "ppm": jax_ppm}[case]()
    print(f"({'port' if port else 'JAX'} on the CPU, {time.perf_counter() - t0:.0f} s)")


if __name__ == "__main__":
    main(sys.argv[1:])
