"""The bidirectional engines on `cornell_box_deluxe` against the JAX
package's: the light tracer, BDPT and VCM call `gather_mat_params` /
`hit_shading` without a ray cone and evaluate no material map, so on the
deluxe scene they take the IMAGE texture at level 0 and ignore the normal
map, in both packages.

Tolerance: every pixel within 1e-3 relative plus 1e-6, the image sums
within 1e-5 relative (tests/test_torch_bdpt.py's: float32 rounding in the
intersector and the BSDFs; measured 2e-6 absolute at most).
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import numpy as np
import pytest

from cudatracerlib_tpu.render import bdpt as jbdpt
from cudatracerlib_tpu.render import light_tracer as jlt
from cudatracerlib_tpu.render import vcm as jvcm
from cudatracerlib_tpu.scene.shapes import cornell_box_deluxe as jdeluxe
from cudatracerlib_tpu_torch.render import bdpt as tbdpt
from cudatracerlib_tpu_torch.render import light_tracer as tlt
from cudatracerlib_tpu_torch.render import vcm as tvcm
from cudatracerlib_tpu_torch.scene.shapes import cornell_box_deluxe as tdeluxe

W = H = 16
SEED = 3


@pytest.fixture(scope="module")
def scenes():
    return jdeluxe(), tdeluxe(device="cpu")


@pytest.mark.parametrize("engine", ["light_tracer", "bdpt", "vcm"])
def test_engine_matches_jax(scenes, engine):
    js, ts = scenes
    want, got = {
        "light_tracer": (lambda: jlt.render_light_trace(js, W, H, 1024, SEED),
                         lambda: tlt.render_light_trace(ts, W, H, 1024, SEED)),
        "bdpt": (lambda: jbdpt.render_bdpt(js, W, H, 2, SEED),
                 lambda: tbdpt.render_bdpt(ts, W, H, 2, SEED)),
        "vcm": (lambda: jvcm.render_vcm(js, W, H, 2, SEED, 1),
                lambda: tvcm.render_vcm(ts, W, H, 2, SEED, 1)),
    }[engine]
    w, g = np.asarray(want()), got().numpy()
    assert g.shape == w.shape == (H, W, 3) and np.isfinite(g).all()
    np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-6)
    assert abs(g.sum() - w.sum()) <= 1e-5 * abs(w.sum())
    assert w.mean() > 0.01
