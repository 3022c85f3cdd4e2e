"""The scenes and settings of chip_smoke.py phase 25 (spectral, guided,
realtime and AOV engines), for either package (numpy only; each function
takes the package's scene or classes).

  with_cauchy    a scene whose DIELECTRIC materials get the Cauchy
                 coefficient c (the dispersive caustic scene at
                 DISP_C = 0.03, tests/test_spectral.py's);
  cornell_medium one HOMOGENEOUS volume filling the Cornell box (inset
                 0.05), coloured sigma_a / sigma_s, HG g = 0.3, as a
                 `Media.build` record;
  furnace_medium tests/test_spectral.py's gradient medium around the
                 furnace sphere;
  PIN            the pin sizes tools/engines_reference_mean.py computes
                 and chip_smoke.py gates on.
"""
from __future__ import annotations

import numpy as np

DIELECTRIC, HOMOGENEOUS = 2, 0   # scene/bsdf.py's and scene/media.py's tags (both packages)
DISP_C = 0.03

PIN = dict(
    spectral=dict(size=64, spp=4, seed=3, max_depth=5),
    spectral_vol=dict(size=64, spp=4, seeds=(3, 4, 5), max_depth=6),
    grad_radiance=dict(size=16, spp=8, seed=1, max_depth=4, rr_start=99),
    grad_cauchy=dict(size=16, spp=4, seed=3, max_depth=5, rr_start=99, c=0.01),
    guided=dict(res=8, n_photons=1 << 14, batches=2, size=64, spp=4, seed=3, max_depth=5),
    game=dict(size=64, frames=8),
    aovs=dict(size=256, seed=0),
)
TRAIN_CFG = dict(max_depth=5, rr_start=2)   # the guiding's photon passes (tests/test_guided.py)
GUIDED_CFG = dict(max_depth=5, rr_start=99)


def with_cauchy(scene, c):
    """`scene` with cauchy_c = c on its DIELECTRIC materials, 0 elsewhere
    (c a float or a 0-dim array / tensor, differentiable)."""
    m = scene.materials
    return scene._replace(materials=m._replace(cauchy_c=(m.bsdf_type == DIELECTRIC) * c))


def cornell_medium(scene):
    """The Media.build records of the homogeneous medium in `scene`'s box."""
    lo = np.asarray(scene.bvh.world_min, np.float64) + 0.05
    hi = np.asarray(scene.bvh.world_max, np.float64) - 0.05
    return [dict(type=HOMOGENEOUS, sigma_a=[0.02, 0.05, 0.1], sigma_s=[0.3, 0.25, 0.2],
                 box_min=lo, box_max=hi, phase_g=0.3)]


def furnace_medium(scene):
    """tests/test_spectral.py's gradient medium: one HOMOGENEOUS volume 5
    units beyond the furnace scene's box, sigma_a 0.05, sigma_s (0.2, 0.3,
    0.4), isotropic."""
    lo = np.asarray(scene.bvh.world_min, np.float64) - 5.0
    hi = np.asarray(scene.bvh.world_max, np.float64) + 5.0
    return [dict(type=HOMOGENEOUS, sigma_a=[0.05] * 3, sigma_s=[0.2, 0.3, 0.4], box_min=lo,
                 box_max=hi, phase_g=0.0)]


def weight_ramp(width):
    """The horizontal ramp (1, W, 1) of the cauchy gradient's weighted mean
    (tests/test_spectral.py), as numpy."""
    return np.linspace(0.0, 1.0, width, dtype=np.float32)[None, :, None]
