"""Spectrum and colour math over (..., 3) RGB tensors (port of
cudatracerlib_tpu/math/spectrum.py).

Luminance, the sRGB transfer, RGB <-> XYZ and the packed 32-bit formats of
the reference's photon and film buffers (Math/Spectrum.h:323-418): RGBCOL
(0xAABBGGRR after the sRGB transfer) and Ward's shared-exponent RGBE. The
(3, 3) colour-space products are three explicit multiply-adds a channel,
so no matrix library runs a per-lane product. Packed words are int64
tensors holding the uint32 value, as the port's sampler keeps its state.
"""
from __future__ import annotations

import torch

_RGB2XYZ = ((0.412453, 0.357580, 0.180423),
            (0.212671, 0.715160, 0.072169),
            (0.019334, 0.119193, 0.950227))
_XYZ2RGB = ((3.240479, -1.537150, -0.498535),
            (-0.969256, 1.875991, 0.041556),
            (0.055648, -0.204043, 1.057311))


def luminance(rgb):
    """ITU-R BT.709 luminance (reference Spectrum::getLuminance)."""
    return 0.212671 * rgb[..., 0] + 0.715160 * rgb[..., 1] + 0.072169 * rgb[..., 2]


def average(rgb):
    return rgb.mean(-1)


def max_component(rgb):
    return rgb.amax(-1)


def is_black(rgb, eps: float = 0.0):
    return rgb.abs().amax(-1) <= eps


def mat3_apply(m, v):
    """(..., 3) rows of the constant 3x3 `m` (nested tuples of floats) times
    v, each row three multiply-adds in column order."""
    return torch.stack([m[i][0] * v[..., 0] + m[i][1] * v[..., 1] + m[i][2] * v[..., 2]
                        for i in range(3)], -1)


def rgb_to_xyz(rgb):
    return mat3_apply(_RGB2XYZ, rgb)


def xyz_to_rgb(xyz):
    return mat3_apply(_XYZ2RGB, xyz)


def linear_to_srgb(x):
    x = torch.clamp(x, min=0.0)
    return torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * torch.pow(torch.clamp(x, min=1e-12), 1.0 / 2.4) - 0.055)


def srgb_to_linear(x):
    return torch.where(x <= 0.04045, x / 12.92,
                       torch.pow(torch.clamp((x + 0.055) / 1.055, min=0.0), 2.4))


def to_rgbcol(rgb):
    """Linear RGB -> the uint32 0xAABBGGRR of its sRGB bytes (reference
    toRGBCOL), alpha 0xFF."""
    q = torch.clamp(torch.round(linear_to_srgb(rgb) * 255.0), 0, 255).to(torch.int64)
    return (0xFF << 24) | (q[..., 2] << 16) | (q[..., 1] << 8) | q[..., 0]


def from_rgbcol(packed):
    packed = packed.to(torch.int64)
    chans = [((packed >> s) & 0xFF).to(torch.float32) / 255.0 for s in (0, 8, 16)]
    return srgb_to_linear(torch.stack(chans, -1))


def to_rgbe(rgb):
    """Ward RGBE shared-exponent packing (reference toRGBE): byte 0 R, 1 G,
    2 B mantissas, byte 3 the exponent + 128; 0 below 1e-32."""
    v = rgb.amax(-1)
    vc = torch.clamp(v, min=1e-38)
    f, e = torch.frexp(vc)                    # v = f 2^e, f in [0.5, 1)
    scale = f * 256.0 / vc
    m = torch.clamp(rgb * scale[..., None], 0.0, 255.0).to(torch.int64)
    exp_byte = torch.clamp(e.to(torch.int64) + 128, 0, 255)
    packed = m[..., 0] | (m[..., 1] << 8) | (m[..., 2] << 16) | (exp_byte << 24)
    return torch.where(v < 1e-32, 0, packed)


def from_rgbe(packed):
    packed = packed.to(torch.int64)
    e = packed >> 24
    scale = torch.where(e == 0, 0.0, torch.exp2((e - 128 - 8).to(torch.float32)))
    chans = [((packed >> s) & 0xFF).to(torch.float32) for s in (0, 8, 16)]
    return torch.stack(chans, -1) * scale[..., None]
