"""Shading frame (port of cudatracerlib_tpu/math/frame.py)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import vecmath as vm


class Frame(NamedTuple):
    s: torch.Tensor  # tangent   (..., 3)
    t: torch.Tensor  # bitangent (..., 3)
    n: torch.Tensor  # normal    (..., 3)

    @staticmethod
    def from_normal(n: torch.Tensor) -> "Frame":
        s, t = vm.coordinate_system(n)
        return Frame(s=s, t=t, n=n)

    def to_local(self, v: torch.Tensor) -> torch.Tensor:
        return torch.stack(
            [vm.dot(v, self.s), vm.dot(v, self.t), vm.dot(v, self.n)], dim=-1
        )

    def to_world(self, v: torch.Tensor) -> torch.Tensor:
        return self.s * v[..., 0:1] + self.t * v[..., 1:2] + self.n * v[..., 2:3]


def cos_theta(v):
    return v[..., 2]


def abs_cos_theta(v):
    return v[..., 2].abs()


def sin_theta2(v):
    return torch.clamp(1.0 - v[..., 2] * v[..., 2], min=0.0)


def sin_theta(v):
    return torch.sqrt(sin_theta2(v))


def sin_phi(v):
    st = sin_theta(v)
    return torch.where(st < 1e-9, 0.0, torch.clamp(v[..., 1] / torch.clamp(st, min=1e-9), -1.0, 1.0))


def cos_phi(v):
    st = sin_theta(v)
    return torch.where(st < 1e-9, 1.0, torch.clamp(v[..., 0] / torch.clamp(st, min=1e-9), -1.0, 1.0))


def tan_theta2(v):
    c2 = v[..., 2] * v[..., 2]
    return torch.clamp(1.0 - c2, min=0.0) / torch.clamp(c2, min=1e-12)
