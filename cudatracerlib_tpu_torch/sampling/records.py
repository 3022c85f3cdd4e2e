"""Sampling records (port of cudatracerlib_tpu/sampling/records.py).

Value-type records passed through sampling chains; measures and lobe flags
match the JAX package (reference SceneTypes/Samples.h).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# EMeasure (SceneTypes/Samples.h)
SOLID_ANGLE = 0
AREA = 1
DISCRETE = 2
LENGTH = 3

# BSDF lobe type flags (SceneTypes/Samples.h:85-92)
E_DIFFUSE_REFLECTION = 1 << 0
E_DIFFUSE_TRANSMISSION = 1 << 1
E_GLOSSY_REFLECTION = 1 << 2
E_GLOSSY_TRANSMISSION = 1 << 3
E_DELTA_REFLECTION = 1 << 4
E_DELTA_TRANSMISSION = 1 << 5
E_NULL = 1 << 6
E_DIFFUSE = E_DIFFUSE_REFLECTION | E_DIFFUSE_TRANSMISSION
E_GLOSSY = E_GLOSSY_REFLECTION | E_GLOSSY_TRANSMISSION
E_SMOOTH = E_DIFFUSE | E_GLOSSY
E_DELTA = E_DELTA_REFLECTION | E_DELTA_TRANSMISSION
E_REFLECTION = E_DIFFUSE_REFLECTION | E_GLOSSY_REFLECTION | E_DELTA_REFLECTION
E_TRANSMISSION = E_DIFFUSE_TRANSMISSION | E_GLOSSY_TRANSMISSION | E_DELTA_TRANSMISSION
E_ALL = E_SMOOTH | E_DELTA

# Transport modes
RADIANCE = 0
IMPORTANCE = 1


class PositionSample(NamedTuple):
    """A sampled position on a surface (SceneTypes/Samples.h:94)."""

    p: torch.Tensor        # (..., 3)
    n: torch.Tensor        # (..., 3)
    pdf: torch.Tensor      # (...,)
    measure: torch.Tensor  # (...,) int32
    uv: torch.Tensor       # (..., 2)


class DirectionSample(NamedTuple):
    """A sampled direction (SceneTypes/Samples.h:113)."""

    d: torch.Tensor        # (..., 3)
    pdf: torch.Tensor      # (...,)
    measure: torch.Tensor  # (...,) int32


class DirectSample(NamedTuple):
    """A point on an emitter as seen from a reference point
    (SceneTypes/Samples.h:127)."""

    p: torch.Tensor        # sampled position (..., 3)
    n: torch.Tensor        # normal at sampled position
    d: torch.Tensor        # unit direction ref -> p
    dist: torch.Tensor     # |p - ref|
    pdf: torch.Tensor      # solid-angle pdf (0 => invalid)
    measure: torch.Tensor  # int
    uv: torch.Tensor       # emitter parametric coords


class BSDFSample(NamedTuple):
    """Result of sampling a BSDF at a surface interaction."""

    wi: torch.Tensor            # sampled incident dir, local frame (..., 3)
    weight: torch.Tensor        # f * |cos| / pdf (..., 3)
    pdf: torch.Tensor           # (...,)
    sampled_type: torch.Tensor  # lobe flags (...,) int32
    eta: torch.Tensor           # relative IOR change along the sampled path


class PhaseSample(NamedTuple):
    """Result of sampling a phase function (scene/phase.py)."""

    wi: torch.Tensor      # sampled direction, world space (..., 3)
    weight: torch.Tensor  # phase / pdf (...,); phases are achromatic
    pdf: torch.Tensor     # (...,)
