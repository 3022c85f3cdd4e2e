"""`rough_transmittance.generate_fits` against the JAX package on the CPU,
at a reduced grid (the full 7 x 9 x 18 grid at 72^2 strata is 5.9M lanes,
which the card runs; chip_smoke.py phase 25).

Tolerances, stated once:
  * `_transmittance_grid` on 2 etas x 2 alphas x 3 cosines at 16^2 strata,
    at eta and at 1 / eta: within 2e-6 of JAX's (each entry a mean of 256
    float32 quadrature terms of order 1; the samplers agree to float32
    rounding);
  * `_smooth_T` within 1e-7;
  * the least squares on a grid the test builds from both packages'
    quadratures (the fit's float64 numpy step, the same code): the fitted
    surfaces within 1e-5 of each other in value space, as JAX's
    `test_baked_constants_match_regeneration` compares them (the basis is
    ill-conditioned, so raw coefficients are not compared);
  * the baked constants are the JAX package's, equal as arrays.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import numpy as np
import pytest

from cudatracerlib_tpu.math import rough_transmittance as jrt
from cudatracerlib_tpu_torch.math import rough_transmittance as trt

ETAS = np.asarray([1.3, 1.8])
ALPHAS = np.asarray([0.1, 0.45])
COSINES = np.asarray([0.2, 0.6, 0.95])
NU = 16


@pytest.fixture(scope="module")
def grids(request):
    mp = pytest.MonkeyPatch()
    mp.setattr(jrt, "_NU", NU)        # the JAX quadrature reads its module's strata
    try:
        out = {}
        for name, etas in (("eta", ETAS), ("inv_eta", 1.0 / ETAS)):
            out[name] = (np.asarray(jrt._transmittance_grid(etas, ALPHAS, COSINES)),
                         trt._transmittance_grid(etas, ALPHAS, COSINES, NU, device="cpu"))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("which", ["eta", "inv_eta"])
def test_transmittance_grid_matches_jax(grids, which):
    ref, got = grids[which]
    assert got.shape == ref.shape == (2, 2, 3)
    assert np.isfinite(got).all() and (got > 0).all() and (got <= 1.0 + 1e-6).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


def test_smooth_t_matches_jax():
    E, C = np.meshgrid(trt._ETAS, trt._COSINES, indexing="ij")
    ref = jrt._smooth_T(E.reshape(-1), C.reshape(-1))
    got = trt._smooth_T(E.reshape(-1), C.reshape(-1), device="cpu")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-7)


def test_lstsq_step_matches_jax(grids):
    """The fit of the reduced grid's correction with a basis small enough
    for its 12 points, from each package's quadrature."""
    E, A, C = np.meshgrid(ETAS, ALPHAS, COSINES, indexing="ij")
    surfaces = []
    for k, rt in enumerate((jrt, trt)):
        T = grids["eta"][k]
        Ts = (rt._smooth_T(E.reshape(-1), C.reshape(-1)) if rt is jrt else
              rt._smooth_T(E.reshape(-1), C.reshape(-1), device="cpu")).reshape(T.shape)
        X = rt._basis(E.reshape(-1), A.reshape(-1), C.reshape(-1))[:, :6]
        dT = (T - Ts).reshape(-1)
        coefs, *_ = np.linalg.lstsq(X, dT, rcond=None)
        surfaces.append(X @ coefs)
    np.testing.assert_allclose(surfaces[1], surfaces[0], rtol=0, atol=1e-5)


def test_baked_constants_and_domain_are_jax():
    np.testing.assert_array_equal(trt.COEFS_T, jrt.COEFS_T)
    np.testing.assert_array_equal(trt.COEFS_FDR, jrt.COEFS_FDR)
    assert trt.FIT_RESIDUAL == jrt.FIT_RESIDUAL
    for name in ("_ETAS", "_ALPHAS", "_COSINES"):
        np.testing.assert_array_equal(getattr(trt, name), getattr(jrt, name))
    assert trt._NU == 72 and (trt._NPA, trt._NPC, trt._NPE) == (jrt._NPA, jrt._NPC, jrt._NPE)
