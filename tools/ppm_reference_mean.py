"""The JAX package's CPU mean of the pinned PPM render that chip_smoke.py
gates the port's card render on (REF_PPM_MEAN there):

    render_ppm_pass(caustic_scene(), 64, 64, 4, seed 3, pass 1,
                    PPMConfig(n_photons=2**15))

with the query-major estimate's neighbour cap `max_gather` lifted to the
largest 3x3x3-cell photon count of either photon grid. No query can have
more candidates than that, so no photon is dropped and the estimate is the
exhaustive sum that the port's photon-major kernel computes on the card.
The eye pass runs in chunks of samples (the capped gather holds a (B, 27, K)
table), each chunk's film added to the next; the photon pass and the grids
are the render's own.

Run from the root of the repository (JAX on the CPU, a few minutes):
    JAX_PLATFORMS=cpu python tools/ppm_reference_mean.py
"""
import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cudatracerlib_tpu.image import film as film_mod  # noqa: E402
from cudatracerlib_tpu.render import ppm  # noqa: E402
from cudatracerlib_tpu.render.path_tracer import specialize_config  # noqa: E402
from cudatracerlib_tpu.scene.shapes import caustic_scene  # noqa: E402

W = H = 64
SPP, SEED, PASS, N_PHOTONS = 4, 3, 1, 1 << 15


def max_box_count(grid) -> int:
    """Largest photon count over any 3x3x3 block of cells of `grid`."""
    res = grid.res
    counts = np.diff(np.asarray(grid.cell_start))[: res ** 3].reshape(res, res, res)
    c = np.pad(counts, 1)
    box = sum(c[1 + dx:res + 1 + dx, 1 + dy:res + 1 + dy, 1 + dz:res + 1 + dz]
              for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1))
    return int(box.max())


def main():
    scene = caustic_scene()
    config = ppm.PPMConfig(n_photons=N_PHOTONS)
    base = specialize_config(scene, config.base)
    extent = float(np.min(np.asarray(scene.bvh.world_max)
                          - np.asarray(scene.bvh.world_min))) + 2e-3
    res = max(4, min(config.grid_res, int(extent / max(config.radius0, 1e-6))))
    config = config._replace(base=base, grid_res=res)
    assert not ppm.ppm_uses_kernel(base), "run on the CPU: the query-major branch"
    radius = ppm.progressive_radius(jnp.float32(config.radius0), jnp.float32(PASS))
    seed = jnp.uint32(SEED)
    pm = ppm.trace_photons(scene, config.n_photons, seed, base)
    grids = ppm.build_photon_grids(scene, pm, config)
    cap = max(max_box_count(g) for g in grids)
    config = config._replace(max_gather=cap)
    # every query's candidates lie in one 3x3x3 block of cells
    assert config.max_gather >= max(max_box_count(g) for g in grids)

    eye = jax.jit(partial(ppm.ppm_eye_pass, width=W, height=H, config=config))
    n_px = W * H
    pixel_id = jnp.tile(jnp.arange(n_px, dtype=jnp.uint32), SPP)
    sample_idx = jnp.repeat(jnp.arange(SPP, dtype=jnp.uint32), n_px)
    chunk = max(256, (1 << 25) // (27 * cap)) // 256 * 256
    film = film_mod.Film.create(H, W)
    for s in range(0, n_px * SPP, chunk):
        f = eye(scene, pm, grids, pixel_id[s:s + chunk], sample_idx[s:s + chunk],
                seed, radius)
        film = film._replace(rgb=film.rgb + f.rgb, weight=film.weight + f.weight)
    img = np.asarray(film_mod.develop(film))
    print(f"max_gather {cap} (grid res {res}, {int(pm.valid.sum())} photons, "
          f"{int((pm.valid & pm.caustic).sum())} caustic), radius {float(radius)}")
    print(f"mean {img.mean():.6f} finite {bool(np.isfinite(img).all())}")


if __name__ == "__main__":
    main()
