"""The pinned SPPM runs that chip_smoke.py's phase 20 gates the port's card
passes on (REF_SPPM there), on the JAX package on the CPU by default or,
with --port, on the port on the CPU (for the agreement the gates rest on):

  cornell    4 passes of render_sppm_pass(cornell_box(), 64, 64, seed i,
             SPPMConfig(n_photons=2**15)) on one state, seeds i = 0, 1, 2, 3;
  caustic    the same on caustic_scene();
  beambeam   2 passes (seeds 0, 1) on the Cornell box with bench config 4's
             plume (bench.py:261-275), SPPMConfig(n_photons=2**13,
             vol_estimator=VOL_BEAMBEAM);
  point      the same with VOL_POINT.

For each it prints the image mean after the last pass, the mean r^2 over
the pixels, the gathered share (the pixels whose adaptive state holds a
photon, n_acc > 0) and, for the volume runs, the delta-tracking trip count
of the photon walk's first bounce (every photon lane draws 2 T + 1 numbers
in `sample_distance`, T the slowest lane's trips: read from lane 0's
sampler state). For the volume runs it also prints the means of the same
run started at seeds 3, 4 and 5 and their spread, (max - min) / the seed-3
mean, which sets the card's tolerance (three times it: a tracking decision
that an ulp flips on the card re-draws every lane). Each run imports one
package only. Run from the root of the repository:
    JAX_PLATFORMS=cpu python tools/sppm_reference_mean.py [--port]
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

W = H = 64
GOLDEN = 0x9E3779B9
RUNS = {  # name: (scene, vol estimator, photons, passes)
    "cornell": ("cornell", 0, 1 << 15, 4),
    "caustic": ("caustic", 0, 1 << 15, 4),
    "beambeam": ("cornell", 3, 1 << 13, 2),
    "point": ("cornell", 1, 1 << 13, 2),
}
SPREAD_SEEDS = (3, 4, 5)


def trips(state0, state1, other_draws=1):
    """Tracking trips T from one lane's sampler states around sample_distance."""
    draws = (int(state1) - int(state0)) % (1 << 32) * pow(GOLDEN, -1, 1 << 32) % (1 << 32)
    return (draws - other_draws) // 2


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


def packages(port):
    """(who, scenes {name: scene}, media, render(scene, seed, state, cfg,
    media) -> (img, state), config(vol, photons), first-bounce trips(scene,
    media, photons, seed))."""
    if port:
        import torch

        from cudatracerlib_tpu_torch.render import path_tracer as pt
        from cudatracerlib_tpu_torch.render import sppm
        from cudatracerlib_tpu_torch.render.light_tracer import emit_particles
        from cudatracerlib_tpu_torch.sampling.rng import Sampler
        from cudatracerlib_tpu_torch.scene import media as M
        from cudatracerlib_tpu_torch.scene import scene as scene_mod
        from cudatracerlib_tpu_torch.scene.shapes import caustic_scene, cornell_box

        scenes = {"cornell": cornell_box(device="cpu"), "caustic": caustic_scene(device="cpu")}
        build = lambda recs: M.Media.build(recs, device="cpu")  # noqa: E731

        def first_trips(scene, media, n, seed):
            cfg = pt.specialize_config(scene, sppm.SPPMConfig().base)
            smp = Sampler.create(seed, torch.arange(n), 0xF00D)
            o, d, _, _, _, smp = emit_particles(scene, n, smp, cfg)
            hit = scene_mod.scene_intersect(scene, o, d)
            s = M.sample_distance(media, o, d, cfg.ray_eps, torch.where(hit.valid, hit.t, 1e8),
                                  smp)[0]
            return trips(smp.state[0], s.state[0])

        who = "port (CPU)"
    else:
        import jax.numpy as jnp

        from cudatracerlib_tpu.render import path_tracer as pt
        from cudatracerlib_tpu.render import sppm
        from cudatracerlib_tpu.sampling.rng import Sampler
        from cudatracerlib_tpu.scene import lights as L
        from cudatracerlib_tpu.scene import media as M
        from cudatracerlib_tpu.scene import scene as scene_mod
        from cudatracerlib_tpu.scene.shapes import caustic_scene, cornell_box

        scenes = {"cornell": cornell_box(), "caustic": caustic_scene()}
        build = M.Media.build

        def first_trips(scene, media, n, seed):
            # the emission of trace_photons_vol (JAX sppm.py:120-126)
            smp = Sampler.create(jnp.uint32(seed), jnp.arange(n, dtype=jnp.uint32),
                                 jnp.uint32(0xF00D))
            smp, u_sel = smp.next_1d()
            lsel, _, _ = pt._select_light(scene, u_sel)
            smp, u_pos = smp.next_2d()
            smp, u_dir = smp.next_2d()
            o, d, _ = L.sample_emitter_ray(scene.lights, lsel, u_pos, u_dir)
            hit = scene_mod.scene_intersect(scene, o, d)
            cfg = pt.specialize_config(scene, sppm.SPPMConfig().base)
            s = M.sample_distance(media, o, d, cfg.ray_eps, jnp.where(hit.valid, hit.t, 1e8),
                                  smp)[0]
            return trips(np.asarray(smp.state[0]), np.asarray(s.state[0]))

        who = "JAX package (CPU)"
    box = scenes["cornell"].bvh
    media = build(plume(np.asarray(box.world_min), np.asarray(box.world_max)))

    def render(scene, seed, state, cfg, med):
        return sppm.render_sppm_pass(scene, W, H, seed, state, cfg, media=med)

    def config(vol, photons):
        return sppm.SPPMConfig(n_photons=photons, vol_estimator=vol)

    return who, scenes, media, render, config, first_trips


def main():
    t0 = time.perf_counter()
    who, scenes, media, render, config, first_trips = packages("--port" in sys.argv[1:])

    def run(scene, vol, photons, passes, seed0):
        state, img = None, None
        for i in range(passes):
            img, state = render(scene, seed0 + i, state, config(vol, photons),
                                media if vol else None)
        img = np.asarray(img)
        return (float(img.mean()), float(np.asarray(state.r2).mean()),
                float((np.asarray(state.n_acc) > 0).mean()), bool(np.isfinite(img).all()))

    for name, (scene_name, vol, photons, passes) in RUNS.items():
        scene = scenes[scene_name]
        mean, r2, share, finite = run(scene, vol, photons, passes, 0)
        line = (f"{who}: {name} {W}x{H} {photons} photons {passes} passes (seeds from 0): mean "
                f"{mean:.9f}, mean r2 {r2:.9g}, gathered share {share:.6f}, finite {finite}")
        if vol:
            t = first_trips(scene, media, photons, 0)
            means = [run(scene, vol, photons, passes, s)[0] for s in SPREAD_SEEDS]
            spread = (max(means) - min(means)) / means[0]
            line += (f", first photon bounce's tracking trips {t}; started at seeds "
                     f"{SPREAD_SEEDS}: means {[round(m, 9) for m in means]}, spread {spread:.6f}")
        print(line, flush=True)
    print(f"{who}: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
