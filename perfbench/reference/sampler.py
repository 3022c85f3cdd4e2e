"""Counter-based sample streams: every number is a PCG hash of (seed,
pixel, sample index, dimension), so a lane's draws do not depend on the
other lanes (a frozen copy of the stream the program's sampler defines).
Words are uint32 values held in int64 tensors."""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


def _u(x):
    return x.to(torch.int64) & MASK


def pcg_hash(x):
    state = (_u(x) * 747796405 + 2891336453) & MASK
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK
    return (word >> 22) ^ word


def hash_combine(a, b):
    a, b = _u(a), _u(b)
    return a ^ ((pcg_hash(b) + GOLDEN + ((a << 6) & MASK) + (a >> 2)) & MASK)


class Stream:
    """One uint32 state word a lane; `next(k)` returns the next k numbers
    in [0, 1) as a (B, k) tensor of `dtype` (the top 24 bits of each hash)."""

    def __init__(self, state, dtype=torch.float32):
        self.state = state
        self.dtype = dtype

    @staticmethod
    def create(seed: int, pixel_id, sample_idx, dtype=torch.float32) -> "Stream":
        s = torch.full_like(pixel_id, int(seed) & MASK, dtype=torch.int64)
        return Stream(hash_combine(hash_combine(s, pixel_id), sample_idx), dtype)

    def next(self, k: int = 1):
        out = []
        for _ in range(k):
            self.state = (self.state + GOLDEN) & MASK
            out.append((pcg_hash(self.state) >> 8).to(self.dtype) * (1.0 / 16777216.0))
        return torch.stack(out, -1)

    def skip(self, n):
        self.state = (self.state + n * GOLDEN) & MASK
