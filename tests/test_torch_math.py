"""Closed-form parity of the port's math and sampling helpers with the JAX
package: vecmath, frames, warps, Monte-Carlo helpers. Inputs come from numpy
seeds; tolerances are float32 rounding (1e-6 absolute on unit-scale values)."""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.math import frame as jframe
from cudatracerlib_tpu.math import montecarlo as jmc
from cudatracerlib_tpu.math import vecmath as jvm
from cudatracerlib_tpu.math import warp as jwarp
from cudatracerlib_tpu_torch.math import frame as tframe
from cudatracerlib_tpu_torch.math import montecarlo as tmc
from cudatracerlib_tpu_torch.math import vecmath as tvm
from cudatracerlib_tpu_torch.math import warp as twarp
from cudatracerlib_tpu_torch.sampling import records as trec
from cudatracerlib_tpu.sampling import records as jrec

ATOL = 1e-6


def _unit(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _u2(n, seed):
    return np.random.default_rng(seed).random((n, 2), dtype=np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=atol)


def test_vecmath():
    a = np.random.default_rng(0).normal(size=(1000, 3)).astype(np.float32)
    b = np.random.default_rng(1).normal(size=(1000, 3)).astype(np.float32)
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    _close(tvm.dot(ta, tb), jvm.dot(ja, jb), 1e-5)
    _close(tvm.cross(ta, tb), jvm.cross(ja, jb), 1e-5)
    _close(tvm.normalize(ta), jvm.normalize(ja))
    _close(tvm.normalize(torch.zeros(2, 3)), jvm.normalize(jnp.zeros((2, 3))))


def test_frame_roundtrip_and_parity():
    n, v = _unit(2000, 2), _unit(2000, 3)
    n[:2] = [[0, 0, 1], [0, 0, -1]]
    tf, jf = tframe.Frame.from_normal(torch.from_numpy(n)), jframe.Frame.from_normal(jnp.asarray(n))
    for a, b in zip(tf, jf):
        _close(a, b)
    loc = tf.to_local(torch.from_numpy(v))
    _close(loc, jf.to_local(jnp.asarray(v)))
    _close(tf.to_world(loc), v, 2e-6)


@pytest.mark.parametrize("name", ["square_to_uniform_disk_concentric",
                                  "square_to_cosine_hemisphere",
                                  "square_to_uniform_triangle"])
def test_warps(name):
    u = _u2(5000, 4)
    u[:3] = [[0.5, 0.5], [0.0, 0.0], [0.999999, 0.25]]
    _close(getattr(twarp, name)(torch.from_numpy(u)), getattr(jwarp, name)(jnp.asarray(u)))


def test_cosine_hemisphere_pdf():
    d = _unit(1000, 5)
    _close(twarp.square_to_cosine_hemisphere_pdf(torch.from_numpy(d)),
           jwarp.square_to_cosine_hemisphere_pdf(jnp.asarray(d)))


def test_mis_and_power_heuristic():
    rng = np.random.default_rng(6)
    a, b = rng.random(1000, dtype=np.float32) * 10, rng.random(1000, dtype=np.float32) * 10
    a[:2] = 0.0
    b[:1] = 0.0
    _close(tmc.mis_weight(torch.from_numpy(a), torch.from_numpy(b)),
           jmc.mis_weight(jnp.asarray(a), jnp.asarray(b)))
    _close(tmc.power_heuristic(2.0, torch.from_numpy(a), 1.0, torch.from_numpy(b)),
           jmc.power_heuristic(2.0, jnp.asarray(a), 1.0, jnp.asarray(b)))


def test_sample_discrete():
    rng = np.random.default_rng(7)
    w = rng.random(8).astype(np.float32)
    w[3] = 0.0
    cdf = (np.cumsum(w) / w.sum()).astype(np.float32)
    u = rng.random(5000, dtype=np.float32)
    u[:2] = [0.0, 0.99999994]
    ti, tp, tu = tmc.sample_discrete(torch.from_numpy(cdf), torch.from_numpy(u))
    ji, jp, ju = jmc.sample_discrete(jnp.asarray(cdf), jnp.asarray(u))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tp, jp)
    _close(tu, ju, 1e-5)


@pytest.mark.parametrize("depth", [0, 4, 5, 7])
def test_russian_roulette_prob(depth):
    tp = np.random.default_rng(8).random(1000, dtype=np.float32) * 2
    _close(tmc.russian_roulette_prob(torch.from_numpy(tp), depth, 5),
           jmc.russian_roulette_prob(jnp.asarray(tp), depth, 5))


def test_record_constants():
    for name in ("SOLID_ANGLE", "AREA", "DISCRETE", "E_DIFFUSE_REFLECTION",
                 "E_DELTA_REFLECTION", "E_DELTA_TRANSMISSION", "E_NULL", "E_ALL"):
        assert getattr(trec, name) == getattr(jrec, name)
    assert trec.DirectSample._fields == jrec.DirectSample._fields
    assert trec.BSDFSample._fields == jrec.BSDFSample._fields
