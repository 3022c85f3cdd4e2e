"""RNG parity: the PyTorch port's counter-based PCG streams against the JAX
package's, bit for bit (inputs made with numpy from a seed)."""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.sampling import rng as jrng
from cudatracerlib_tpu_torch.sampling import rng as trng


def _words(n, seed):
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _np_u32(x):
    return x.numpy().astype(np.uint32)


def test_pcg_hash_bit_exact():
    x = _words(100_000, 0)
    x[:4] = [0, 1, 0xFFFFFFFF, 0x9E3779B9]
    np.testing.assert_array_equal(_np_u32(trng.pcg_hash(_t(x))),
                                  np.asarray(jrng.pcg_hash(jnp.asarray(x))))


def test_hash_combine_bit_exact():
    a, b = _words(50_000, 1), _words(50_000, 2)
    np.testing.assert_array_equal(_np_u32(trng.hash_combine(_t(a), _t(b))),
                                  np.asarray(jrng.hash_combine(jnp.asarray(a), jnp.asarray(b))))


def test_uint_to_unit_float_bit_exact():
    x = _words(50_000, 3)
    got = trng.uint_to_unit_float(_t(x)).numpy()
    want = np.asarray(jrng.uint_to_unit_float(jnp.asarray(x)))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", [0, 3, 0xFFFFFFFF])
def test_sampler_streams_bit_exact(seed):
    """Sampler.create then an interleaved next_1d / next_2d stream, as the
    path tracer draws it, lane by lane."""
    n = 4096
    pixel_id = np.arange(n, dtype=np.uint32) * 7 % 65536
    sample_idx = (np.arange(n) // 1024).astype(np.uint32)
    js = jrng.Sampler.create(jnp.uint32(seed), jnp.asarray(pixel_id), jnp.asarray(sample_idx))
    ts = trng.Sampler.create(seed, _t(pixel_id), _t(sample_idx))
    np.testing.assert_array_equal(_np_u32(ts.state), np.asarray(js.state))
    for step in range(6):
        if step % 2:
            js, ju = js.next_2d()
            ts, tu = ts.next_2d()
        else:
            js, ju = js.next_1d()
            ts, tu = ts.next_1d()
        np.testing.assert_array_equal(tu.numpy().view(np.int32),
                                      np.asarray(ju).view(np.int32))
        np.testing.assert_array_equal(_np_u32(ts.state), np.asarray(js.state))


@pytest.mark.parametrize("n", [0, 1, 7, 513])
def test_skip_and_draws_between_invert_the_stream(n):
    """`skip(n)` lands where n draws do (a tensor n per lane too), and
    `draws_between` gives n back: the volume tracker's trip count T."""
    s0 = trng.Sampler(state=_t(_words(64, 9)))
    s = s0
    for _ in range(n):
        s, _ = s.next_1d()
    assert torch.equal(s0.skip(n).state, s.state)
    assert torch.equal(s0.skip(torch.tensor(n)).state, s.state)
    assert all(trng.draws_between(a, b) == n for a, b in zip(s0.state[:4], s.state[:4]))
