"""Direction <-> packed integer codes for compact photon storage (port of
cudatracerlib_tpu/math/compression.py; reference Math/Compression.h:12-50).

The JAX package keeps codes in uint32 arrays. Here they are int64 tensors
holding the same uint32 values: the shifts are computed in int64 (torch
has no CPU shift for uint32). Decoders take int64 or uint32 codes.
Quantization rounds half to even (`torch.round`, as `jnp.round`).
"""
from __future__ import annotations

import torch

from .vecmath import PI, normalize


def _quantize(x, top: int):
    return torch.clamp(torch.round(x), 0, top).to(torch.int64)


def _field(code, shift: int, mask: int):
    return ((code.to(torch.int64) >> shift) & mask).to(torch.float32)


def encode_spherical_u16(d):
    """Direction -> 16-bit spherical code (theta:8 | phi:8 << 8) in int64
    (reference NormalizedFloat3ToUchar2)."""
    theta = torch.arccos(torch.clamp(d[..., 2], -1.0, 1.0))
    phi = torch.atan2(d[..., 1], d[..., 0])
    phi = torch.where(phi < 0.0, phi + 2.0 * PI, phi)
    t = _quantize(theta / PI * 255.0, 255)
    p = _quantize(phi / (2.0 * PI) * 255.0, 255)
    return t | (p << 8)


def decode_spherical_u16(code):
    theta = _field(code, 0, 0xFF) / 255.0 * PI
    phi = _field(code, 8, 0xFF) / 255.0 * 2.0 * PI
    st = torch.sin(theta)
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), torch.cos(theta)], dim=-1)


def _oct_wrap(v):
    return (1.0 - v.flip(-1).abs()) * torch.where(v >= 0.0, 1.0, -1.0)


def encode_octahedral_u32(d):
    """Direction -> octahedral code, 16 bits per component, in int64."""
    d = normalize(d)
    a = d.abs()
    denom = ((a[..., 0] + a[..., 1]) + a[..., 2])[..., None]   # the JAX reduction's order
    p = d[..., :2] / torch.clamp(denom, min=1e-12)
    p = torch.where(d[..., 2:3] < 0.0, _oct_wrap(p), p)
    q = _quantize((p * 0.5 + 0.5) * 65535.0, 65535)
    return q[..., 0] | (q[..., 1] << 16)


def decode_octahedral_u32(code):
    x = _field(code, 0, 0xFFFF) / 65535.0 * 2.0 - 1.0
    y = _field(code, 16, 0xFFFF) / 65535.0 * 2.0 - 1.0
    z = 1.0 - x.abs() - y.abs()
    t = torch.clamp(-z, min=0.0)
    x = x - torch.where(x >= 0.0, t, -t)
    y = y - torch.where(y >= 0.0, t, -t)
    return normalize(torch.stack([x, y, z], dim=-1))


def encode_uv_u32(uv):
    """(u, v), wrapped into [0, 1), -> 16 bits each in int64 (reference
    TriangleData UV packing). `torch.remainder` takes the divisor's sign, as
    `jnp.mod` does."""
    q = _quantize(torch.remainder(uv, 1.0) * 65535.0, 65535)
    return q[..., 0] | (q[..., 1] << 16)


def decode_uv_u32(code):
    u = _field(code, 0, 0xFFFF) / 65535.0
    v = _field(code, 16, 0xFFFF) / 65535.0
    return torch.stack([u, v], dim=-1)
