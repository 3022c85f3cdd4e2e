"""Volume gradients on grid media, the rest of test_torch_volgrad.py's
cases (its docstring states the tolerances and why JAX is given the mode
tuple): the per-channel grids of the JAX package's
test_per_channel_sigma_grids (tests/test_engines.py:171), an RGB sigma_a
grid and a scalar sigma_s grid ('gen' mode: the generic 3-channel lookups
and the per-volume tables by volume id), with respect to `grid_data`,
`sigma_a` and `sigma_s`, and test_grid_transmittance_gradient_fd's 6^3
density grid (:191, 'scalar' mode) with respect to its voxels. Alone this
file takes about 50 s, most of it JAX compiling the two gradients.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import numpy as np

from cudatracerlib_tpu.scene import media as jm
from cudatracerlib_tpu.scene.shapes import furnace_scene as jfurnace
from cudatracerlib_tpu_torch.scene import media as tm
from test_torch_volgrad import GRID_PATHS, SLAB_BOX, assert_gradients_match, gradient_pair


def test_per_channel_grid_gradient_matches_jax():
    rng = np.random.default_rng(5)
    ga = np.zeros((8, 8, 8, 3), np.float32)
    ga[..., 0] = 1.0   # red: full absorption
    ga[..., 2] = 0.2   # blue: light absorption
    gs = (0.5 * rng.random((8, 8, 8))).astype(np.float32)
    records = [dict(type=jm.GRID, sigma_a=[0.8] * 3, sigma_s=[0.3] * 3, sigma_a_grid=ga,
                    sigma_s_grid=gs, **SLAB_BOX)]
    assert tm.Media.build(records, device="cpu").modes[0][0] == "gen"
    pair = gradient_pair(jfurnace(albedo=0.7), records, GRID_PATHS, 16, 16, 4, 0, 3, 99)
    assert_gradients_match(pair)
    g = pair[3]
    assert all(np.abs(g[p]).max() > 0 for p in GRID_PATHS)


def test_grid_voxel_gradient_matches_jax():
    """test_grid_transmittance_gradient_fd: the 6^3 density grid's voxels."""
    rng = np.random.default_rng(3)
    dens = (0.5 + 0.5 * rng.random((6, 6, 6))).astype(np.float32)
    pair = gradient_pair(jfurnace(albedo=0.7),
                         [dict(type=jm.GRID, sigma_a=[0.4] * 3, sigma_s=[0.0] * 3, density=dens,
                               **SLAB_BOX)],
                         ["grid_data"], 16, 16, 4, 0, 3, 99)
    assert_gradients_match(pair)
    g = pair[3]["grid_data"]
    assert g[0] == 0 and g.min() < 0  # the dummy slot takes none; the voxels darken
