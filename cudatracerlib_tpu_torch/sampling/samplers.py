"""Sample-sequence generators: independent, stratified, Halton, Sobol
(port of cudatracerlib_tpu/sampling/samplers.py; the tables are the JAX
package's, built by the same numpy code, and the draws equal its bit for bit).

Counterpart of reference ``Kernel/Sampler.{h,cpp}`` + ``Sampler_device.h``:
the host sequence generators (IndependentSequenceGenerator,
StratifiedSequenceGenerator, Sampler.h:63-118; the enum also names
low-discrepancy/Sobol which the reference never wired — here they are wired).

Design (as in the JAX package): sequences are either counter-hashed on the fly (independent — the
default fast path in sampling/rng.py) or generated as precomputed
low-discrepancy tables combined per-pixel with Cranley-Patterson rotations
(the stateless analogue of the reference's SequenceSamplerData index-decompose
trick, Sampler_device.h:62-107).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .rng import hash_combine, pcg_hash, uint_to_unit_float

INDEPENDENT = 0
STRATIFIED = 1
HALTON = 2
SOBOL = 3


def radical_inverse(base: int, i: np.ndarray) -> np.ndarray:
    """Host-side radical inverse for Halton tables."""
    i = i.astype(np.int64).copy()
    f = np.ones_like(i, dtype=np.float64)
    r = np.zeros_like(i, dtype=np.float64)
    while (i > 0).any():
        f = f / base
        r = r + f * (i % base)
        i = i // base
    return r


_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37]

def _sobol_table(n: int, dim: int) -> np.ndarray:
    """Gray-code Sobol points, dims 1-2 (dim 1 = van der Corput base 2; dim 2
    uses the classic x^2+x+1 primitive-polynomial direction numbers)."""
    # direction numbers
    v = np.zeros((2, 32), np.uint64)
    for k in range(32):
        v[0, k] = np.uint64(1) << np.uint64(31 - k)
    m = [1, 3]  # initial direction integers for dim 2 (s=2, a=1)
    for k in range(2, 32):
        prev, prev2 = m[k - 1], m[k - 2]
        m.append(prev2 ^ (4 * prev2) ^ (2 * prev))  # recurrence for x^2+x+1
    for k in range(32):
        v[1, k] = np.uint64(m[k]) << np.uint64(31 - k)

    out = np.zeros((n, dim), np.float64)
    x = np.zeros(2, np.uint64)
    for i in range(1, n + 1):
        c = ((i - 1) ^ i).bit_length() - 1  # index of lowest zero bit of i-1
        for d in range(min(dim, 2)):
            x[d] ^= v[d, min(c, 31)]
            out[i - 1, d] = float(x[d]) / 2**32
    return out


class SequenceTable(NamedTuple):
    """Precomputed low-discrepancy table (n_samples, n_dims) + per-pixel
    Cranley-Patterson rotation (the reference's per-pixel sequence combine)."""

    table: torch.Tensor  # (N, D) float32 in [0,1)
    kind: int

    @staticmethod
    def build(kind: int, n_samples: int, n_dims: int = 8, device="cuda") -> "SequenceTable":
        """The table on `device`: the card unless the caller asks for the CPU."""
        if kind == HALTON:
            i = np.arange(n_samples)
            cols = [radical_inverse(_PRIMES[d % len(_PRIMES)], i) for d in range(n_dims)]
            t = np.stack(cols, axis=1)
        elif kind == SOBOL:
            t = np.zeros((n_samples, n_dims))
            base = _sobol_table(n_samples, 2)
            for d in range(n_dims):
                t[:, d] = base[:, d % 2]
                if d >= 2:  # scramble higher dims by digit permutation
                    t[:, d] = (t[:, d] + radical_inverse(_PRIMES[d], np.arange(n_samples))) % 1.0
        elif kind == STRATIFIED:
            n_side = max(int(np.sqrt(n_samples)), 1)
            rngs = np.random.default_rng(0)
            t = np.zeros((n_samples, n_dims))
            for d in range(0, n_dims, 2):
                idx = np.arange(n_samples)
                sx = (idx % n_side + rngs.uniform(size=n_samples)) / n_side
                sy = (idx // n_side % n_side + rngs.uniform(size=n_samples)) / n_side
                t[:, d] = sx
                if d + 1 < n_dims:
                    t[:, d + 1] = sy
        else:
            t = np.random.default_rng(0).uniform(size=(n_samples, n_dims))
        return SequenceTable(table=torch.from_numpy(t.astype(np.float32)).to(device), kind=kind)

    def sample(self, pixel_id, sample_index, dim):
        """Low-discrepancy value with per-pixel rotation; shapes broadcast
        (integer tensors or ints, on the table's device)."""
        n, d_max = self.table.shape
        dev = self.table.device
        as_long = lambda x: torch.as_tensor(x, device=dev).long()  # noqa: E731
        base = self.table[as_long(sample_index) % n, as_long(dim) % d_max]
        rot = uint_to_unit_float(pcg_hash(hash_combine(as_long(pixel_id), as_long(dim))))
        return torch.remainder(base + rot, 1.0)
