"""The pinned bench-config-4 render that chip_smoke.py gates the port's card
render on (REF_VOL_MEAN and REF_VOL_RAYS there), and the spread of its mean
over seeds 3-5 that the gate's tolerance is set from:

    render_vol_counted(cornell_box(), bench config 4's plume, 64, 64, 4,
                       seed, PTConfig(max_depth=6))    seeds 3, 4, 5

The plume is bench.py's (bench.py:261-275): a 32^3 grid, the sum of 6
Gaussians from np.random.default_rng(0), one GRID volume spanning the scene
box inset by 0.05. By default the JAX package computes the renders on the
CPU; with --port the port computes them on the CPU, for the agreement the
gate rests on. It also prints seed 3's delta-tracking trip counts, bounce by
bounce (REF_VOL_TRIPS there): every lane's sampler moves by 2 T + 10 draws in
a bounce whose slowest lane tracked T trips, so T comes from one lane's
sampler state before and after each bounce, stepped as the JAX package's
render_vol_stepwise steps. Each run imports one package only. Run from the
root of the repository:
    JAX_PLATFORMS=cpu python tools/volume_reference_mean.py [--port]
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

W, H, SPP, DEPTH, SEEDS = 64, 64, 4, 6, (3, 4, 5)
GOLDEN = 0x9E3779B9
BOUNCE_DRAWS = 10  # a bounce's draws besides tracking: NEE 3, phase 2, BSDF 3, RR 1, volume 1


def trips(state0, state1):
    """A bounce's tracking trip count from one lane's sampler states (the
    port's volpath.tracking_trips, kept here so a JAX run imports no torch)."""
    draws = (int(state1) - int(state0)) % (1 << 32) * pow(GOLDEN, -1, 1 << 32) % (1 << 32)
    return (draws - BOUNCE_DRAWS) // 2


def plume(lo, hi, res=32):
    """bench.py's smoke plume as one Media.build record."""
    g = np.stack(np.meshgrid(*[np.linspace(0, 1, res)] * 3, indexing="ij"), -1)
    rng = np.random.default_rng(0)
    dens = np.zeros((res,) * 3, np.float32)
    for _ in range(6):
        c = rng.uniform(0.2, 0.8, 3)
        s = rng.uniform(0.05, 0.2)
        dens += np.exp(-np.sum((g - c) ** 2, -1) / (2 * s * s)).astype(np.float32)
    return [dict(type=1, sigma_a=[0.05] * 3, sigma_s=[0.6, 0.7, 0.8], box_min=lo + 0.05,
                 box_max=hi - 0.05, phase_g=0.3, density=dens)]


def main():
    t0 = time.perf_counter()
    if "--port" in sys.argv[1:]:
        from cudatracerlib_tpu_torch.render import volpath
        from cudatracerlib_tpu_torch.render.path_tracer import PTConfig
        from cudatracerlib_tpu_torch.render.volpath import render_vol_counted
        from cudatracerlib_tpu_torch.scene.media import Media
        from cudatracerlib_tpu_torch.scene.shapes import cornell_box

        scene = cornell_box(device="cpu")
        build = lambda recs: Media.build(recs, device="cpu")  # noqa: E731
        who = "port (CPU)"

        def bounce_trips(media, cfg):
            cfg = volpath._specialize(scene, media, cfg)
            _, o, d, _, smp = volpath._camera_batch(scene, W, H, SPP, SEEDS[0])
            carry, out = volpath.init_vol_carry(o, d, smp), []
            for depth in range(cfg.max_depth):
                s0 = carry.sampler.state[0]
                carry = volpath.vol_bounce(scene, media, cfg, carry, depth)
                out.append(trips(s0, carry.sampler.state[0]))
            return out
    else:
        import jax.numpy as jnp

        from cudatracerlib_tpu.render import volpath
        from cudatracerlib_tpu.render.path_tracer import PTConfig
        from cudatracerlib_tpu.render.volpath import render_vol_counted
        from cudatracerlib_tpu.scene.media import Media
        from cudatracerlib_tpu.scene.shapes import cornell_box

        scene = cornell_box()
        build = Media.build
        who = "JAX package (CPU)"

        def bounce_trips(media, cfg):
            cfg = volpath.specialize_media_config(media, cfg)
            _, _, carry = volpath._vol_pass_setup(scene, media, W, H, SPP, jnp.uint32(SEEDS[0]),
                                                  cfg)
            out = []
            for depth in range(cfg.max_depth):
                s0 = np.asarray(carry.sampler.state[0])
                carry = volpath._vol_step(scene, media, cfg, carry, jnp.int32(depth))
                out.append(trips(s0, np.asarray(carry.sampler.state[0])))
            return out
    media = build(plume(np.asarray(scene.bvh.world_min), np.asarray(scene.bvh.world_max)))
    means = []
    for seed in SEEDS:
        img, rays = render_vol_counted(scene, media, W, H, SPP, seed, PTConfig(max_depth=DEPTH))
        img = np.asarray(img)
        means.append(float(img.mean()))
        print(f"{who}: cornell + plume {W}x{H} spp {SPP} depth {DEPTH} seed {seed}: mean "
              f"{means[-1]:.9f}, rays {int(rays)}, finite {bool(np.isfinite(img).all())}")
    print(f"{who}: seed {SEEDS[0]} tracking trips by bounce "
          f"{bounce_trips(media, PTConfig(max_depth=DEPTH))}")
    spread = (max(means) - min(means)) / means[0]
    print(f"{who}: seeds {SEEDS} spread (max - min) / mean(seed {SEEDS[0]}) {spread:.6f}, "
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
