"""The JAX package's CPU volume gradients that chip_smoke.py's phase 19
gates the port's card gradients on, written to
tools/volume_grad_reference.npz (which chip_smoke.py reads) and summarised
on stdout. Three cases, each d mean(render_vol(...)) by `jax.value_and_grad`:

  slab   the JAX package's TestVolumetric test_transmittance_gradient
         (tests/test_engines.py:131): sigma_a of a homogeneous slab (sigma_a
         0.3, sigma_s 0.1) in furnace_scene(albedo=0.7), 16x16, 4 spp, seed 0,
         PTConfig(max_depth=3, rr_start=99);
  grid6  its test_grid_transmittance_gradient_fd (:191): the voxels
         (`grid_data`) of a 6^3 density grid from default_rng(3), sigma_a
         0.4, the same render;
  plume  bench config 4's plume (bench.py:261-275) in the Cornell box, 64x64,
         4 spp, depth 6, seed 3, with respect to grid_data, sigma_a and
         sigma_s.

JAX gets the media's mode tuple explicitly, so under jax.grad it takes the
specialised lookups the bench takes (its host cache would miss on a traced
grid). Beside each gradient it prints the delta-tracking trip count of each
bounce, read from one lane's sampler state before and after the bounce
(every lane draws 2 T + 10 numbers in a bounce whose slowest lane tracked T
trips). With --port the port computes the same on the CPU, for the
agreement the card's gate rests on, and the file is not written. Each run
imports one package only. Run from the root of the repository (JAX ~2 min):
    JAX_PLATFORMS=cpu python tools/volume_grad_reference.py [--port]
"""
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "tools", "volume_grad_reference.npz")
GOLDEN = 0x9E3779B9
BOUNCE_DRAWS = 10  # a bounce's draws besides tracking: NEE 3, phase 2, BSDF 3, RR 1, volume 1
SLAB_BOX = dict(box_min=[-2, -3, -2], box_max=[2, -1.5, 2])


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


def cases(cornell, furnace):
    """name: (scene, media records, fields, (width, height, spp, seed, depth, rr_start))."""
    rng = np.random.default_rng(3)
    dens = (0.5 + 0.5 * rng.random((6, 6, 6))).astype(np.float32)
    box = cornell()
    lo, hi = np.asarray(box.bvh.world_min), np.asarray(box.bvh.world_max)
    return {
        "slab": (furnace(), [dict(type=0, sigma_a=[0.3] * 3, sigma_s=[0.1] * 3, **SLAB_BOX)],
                 ["sigma_a"], (16, 16, 4, 0, 3, 99)),
        "grid6": (furnace(), [dict(type=1, sigma_a=[0.4] * 3, sigma_s=[0.0] * 3, density=dens,
                                   **SLAB_BOX)],
                  ["grid_data"], (16, 16, 4, 0, 3, 99)),
        "plume": (box, plume(lo, hi), ["grid_data", "sigma_a", "sigma_s"], (64, 64, 4, 3, 6, 5)),
    }


def run_jax():
    import jax
    import jax.numpy as jnp

    from cudatracerlib_tpu.render import volpath
    from cudatracerlib_tpu.render.path_tracer import PTConfig
    from cudatracerlib_tpu.scene import media as M
    from cudatracerlib_tpu.scene.shapes import cornell_box, furnace_scene

    out = {}
    for name, (scene, records, fields, (W, H, spp, seed, depth, rr)) in cases(
            cornell_box, lambda: furnace_scene(albedo=0.7)).items():
        med = M.Media.build(records)
        cfg = PTConfig(max_depth=depth, rr_start=rr, media_modes=M.static_modes(med))

        def loss(*xs, scene=scene, med=med, fields=fields, W=W, H=H, spp=spp, seed=seed,
                 cfg=cfg):
            m = med._replace(**dict(zip(fields, xs)))
            return jnp.mean(volpath.render_vol(scene, m, W, H, spp, seed, cfg))

        value, g = jax.value_and_grad(loss, argnums=tuple(range(len(fields))))(
            *(getattr(med, f) for f in fields))
        _, _, carry = volpath._vol_pass_setup(scene, med, W, H, spp, jnp.uint32(seed), cfg)
        t = []
        for d in range(depth):
            s0 = np.asarray(carry.sampler.state[0])
            carry = volpath._vol_step(scene, med, cfg, carry, jnp.int32(d))
            t.append(trips(s0, np.asarray(carry.sampler.state[0])))
        out[name] = (float(value), {f: np.asarray(x, np.float32) for f, x in zip(fields, g)}, t)
    return "JAX package (CPU)", out


def run_port():
    import torch

    from cudatracerlib_tpu_torch.convert import grads, with_grad
    from cudatracerlib_tpu_torch.render import volpath
    from cudatracerlib_tpu_torch.render.path_tracer import PTConfig
    from cudatracerlib_tpu_torch.scene.media import Media
    from cudatracerlib_tpu_torch.scene.shapes import cornell_box, furnace_scene

    out = {}
    for name, (scene, records, fields, (W, H, spp, seed, depth, rr)) in cases(
            lambda: cornell_box(device="cpu"),
            lambda: furnace_scene(albedo=0.7, device="cpu")).items():
        med = with_grad(Media.build(records, device="cpu"), fields)
        cfg = PTConfig(max_depth=depth, rr_start=rr)
        value = volpath.render_vol(scene, med, W, H, spp, seed, cfg).mean()
        value.backward()
        cfg = volpath._specialize(scene, med, cfg)
        _, o, d, _, smp = volpath._camera_batch(scene, W, H, spp, seed)
        carry, t = volpath.init_vol_carry(o, d, smp), []
        with torch.no_grad():
            for k in range(depth):
                s0 = carry.sampler.state[0]
                carry = volpath.vol_bounce(scene, med, cfg, carry, k)
                t.append(trips(s0, carry.sampler.state[0]))
        out[name] = (float(value.detach()), grads(med, fields), t)
    return "port (CPU)", out


def main():
    t0 = time.perf_counter()
    port = "--port" in sys.argv[1:]
    who, out = run_port() if port else run_jax()
    arrays = {}
    for name, (value, g, t) in out.items():
        arrays[f"{name}/loss"] = np.float64(value)
        arrays[f"{name}/trips"] = np.asarray(t, np.int64)
        summary = []
        for f, x in g.items():
            arrays[f"{name}/{f}"] = x
            top = np.argsort(-np.abs(x.reshape(-1)))[:3]
            summary.append(f"d/d{f} {x.shape}: sum {float(x.sum()):.9g}, |g| "
                           f"{float(np.linalg.norm(x)):.9g}, largest "
                           f"{[(int(i), float(f'{x.reshape(-1)[i]:.9g}')) for i in top]}")
        print(f"{who}: {name}: loss {value:.9g}, tracking trips by bounce {t}; "
              + "; ".join(summary))
    if not port:
        np.savez_compressed(OUT, **arrays)
        print(f"wrote {os.path.relpath(OUT, ROOT)} ({os.path.getsize(OUT)} bytes)")
    print(f"{who}: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
