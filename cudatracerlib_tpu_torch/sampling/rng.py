"""Counter-based stateless RNG (port of cudatracerlib_tpu/sampling/rng.py).

Every sample is a hash of (seed, pixel_id, sample_index, dimension), so the
render needs no `torch.Generator` and reproduces the JAX package's streams
bit for bit. Words are uint32 values held in int64 tensors: PyTorch's CPU
backend has no uint32 addition, so every multiply, add and left shift is
followed by `& 0xFFFFFFFF` (products of two 32-bit words stay below 2^63).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..utils.timing import upload

MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9  # 2^32 / phi, Weyl increment


def _u(x, device=None) -> torch.Tensor:
    """Any integer input -> int64 tensor holding its uint32 value."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, dtype=torch.int64, device=device)
    return x.to(torch.int64) & MASK


def pcg_hash(x) -> torch.Tensor:
    """PCG-RXS-M-XS-32 output function over an LCG step; uint32 -> uint32."""
    x = _u(x)
    state = (x * 747796405 + 2891336453) & MASK
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK
    return (word >> 22) ^ word


def hash_combine(a, b) -> torch.Tensor:
    """Boost-style hash combine on uint32."""
    a = _u(a)
    b = _u(b, a.device)
    return a ^ ((pcg_hash(b) + _GOLDEN + ((a << 6) & MASK) + (a >> 2)) & MASK)


def uint_to_unit_float(x) -> torch.Tensor:
    """uint32 -> float32 in [0, 1) using the top 24 bits."""
    return (_u(x) >> 8).to(torch.float32) * (1.0 / 16777216.0)


class Sampler(NamedTuple):
    """Stateless sample stream: one uint32 state word (int64 tensor) per lane."""

    state: torch.Tensor

    @staticmethod
    def create(seed, pixel_id, sample_index) -> "Sampler":
        pixel_id = _u(pixel_id)
        if not isinstance(seed, torch.Tensor):
            seed = upload("sampler.seed", seed, pixel_id.device, torch.int64)
        s = hash_combine(hash_combine(_u(seed), pixel_id), _u(sample_index, pixel_id.device))
        return Sampler(state=s)

    def next_1d(self) -> Tuple["Sampler", torch.Tensor]:
        state = (self.state + _GOLDEN) & MASK
        return Sampler(state=state), uint_to_unit_float(pcg_hash(state))

    def next_2d(self) -> Tuple["Sampler", torch.Tensor]:
        s1 = (self.state + _GOLDEN) & MASK
        s2 = (s1 + _GOLDEN) & MASK
        u = torch.stack(
            [uint_to_unit_float(pcg_hash(s1)), uint_to_unit_float(pcg_hash(s2))],
            dim=-1,
        )
        return Sampler(state=s2), u

    def skip(self, n) -> "Sampler":
        """The sampler `n` draws on (n an int or an int tensor)."""
        return Sampler(state=(self.state + n * _GOLDEN) & MASK)


def draws_between(state_before, state_after) -> int:
    """How many draws lead from one lane's state to another (ints or 0-dim
    tensors): the Weyl step inverted modulo 2^32."""
    step = (int(state_after) - int(state_before)) & MASK
    return step * pow(_GOLDEN, -1, MASK + 1) & MASK


def stratified_offsets(n_x: int, n_y: int, dtype=torch.float32, device="cuda"):
    """(n_x*n_y, 2) stratum origins for stratified pixel sampling
    (reference StratifiedSequenceGenerator, Kernel/Sampler.h:84-118), on
    `device`: the card unless the caller asks for the CPU."""
    ix = torch.arange(n_x, dtype=dtype, device=device)
    iy = torch.arange(n_y, dtype=dtype, device=device)
    gx, gy = torch.meshgrid(ix, iy, indexing="ij")
    return torch.stack([gx.reshape(-1) / n_x, gy.reshape(-1) / n_y], dim=-1)
