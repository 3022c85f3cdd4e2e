"""Analytic Preetham sun/sky environment maps.

Port of cudatracerlib_tpu/io/sunsky.py, numpy only as there; the port keeps its own
copy so that it imports nothing of the JAX package.

Counterpart of the reference Mitsuba loader's ``sunsky``/``sun``/``sky``
emitter plugins (Engine/SceneLoader/Mitsuba/ObjectParser.h:495-560): instead
of a measured HDR, the sky dome is generated from the Preetham et al. 1999
analytic model ("A Practical Analytic Model for Daylight") at load time and
fed to the InfiniteLight env-map importance sampler — a precomputation, so it
costs nothing on the render path.

Output layout matches scene/lights.py env maps: (H, W, 3) lat-long with
v in [0, 1] mapping polar angle theta in [0, pi] and u mapping azimuth phi.
"""
from __future__ import annotations

import numpy as np

# Perez coefficient tables (Preetham et al., A.2): rows A..E, f(T) = c0*T + c1
_PEREZ_Y = np.array([[0.1787, -1.4630], [-0.3554, 0.4275], [-0.0227, 5.3251],
                     [0.1206, -2.5771], [-0.0670, 0.3703]])
_PEREZ_X = np.array([[-0.0193, -0.2592], [-0.0665, 0.0008], [-0.0004, 0.2125],
                     [-0.0641, -0.8989], [-0.0033, 0.0452]])
_PEREZ_YC = np.array([[-0.0167, -0.2608], [-0.0950, 0.0092], [-0.0079, 0.2102],
                      [-0.0441, -1.6537], [-0.0109, 0.0529]])


def _perez(theta, gamma, c):
    return (1.0 + c[0] * np.exp(c[1] / np.maximum(np.cos(theta), 1e-3))) * (
        1.0 + c[2] * np.exp(c[3] * gamma) + c[4] * np.cos(gamma) ** 2
    )


def _zenith(turbidity, theta_s):
    """Zenith luminance (kcd/m^2) and chromaticity (Preetham A.2)."""
    T = turbidity
    chi = (4.0 / 9.0 - T / 120.0) * (np.pi - 2.0 * theta_s)
    Yz = (4.0453 * T - 4.9710) * np.tan(chi) - 0.2155 * T + 2.4192
    t_vec = np.array([theta_s**3, theta_s**2, theta_s, 1.0])
    T_vec = np.array([T * T, T, 1.0])
    xM = np.array([
        [0.00166, -0.00375, 0.00209, 0.0],
        [-0.02903, 0.06377, -0.03202, 0.00394],
        [0.11693, -0.21196, 0.06052, 0.25886],
    ])
    yM = np.array([
        [0.00275, -0.00610, 0.00317, 0.0],
        [-0.04214, 0.08970, -0.04153, 0.00516],
        [0.15346, -0.26756, 0.06670, 0.26688],
    ])
    xz = T_vec @ xM @ t_vec
    yz = T_vec @ yM @ t_vec
    return max(Yz, 1e-3), xz, yz


def _xyY_to_rgb(x, y, Y):
    """CIE xyY -> linear sRGB."""
    y = np.maximum(y, 1e-6)
    X = x / y * Y
    Z = (1.0 - x - y) / y * Y
    r = 3.2406 * X - 1.5372 * Y - 0.4986 * Z
    g = -0.9689 * X + 1.8758 * Y + 0.0415 * Z
    b = 0.0557 * X - 0.2040 * Y + 1.0570 * Z
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, None)


def preetham_sky(sun_dir, turbidity: float = 3.0, res: int = 64,
                 scale: float = 1.0, ground_albedo: float = 0.15):
    """Lat-long (res, 2*res, 3) radiance map for the Preetham sky dome.

    `sun_dir`: unit vector toward the sun (world up = +z by Mitsuba's sunsky
    convention before toWorld). Below-horizon texels get a constant ground
    color lit by the sky's average."""
    sun_dir = np.asarray(sun_dir, np.float64)
    sun_dir = sun_dir / max(np.linalg.norm(sun_dir), 1e-9)
    theta_s = np.arccos(np.clip(sun_dir[2], -1.0, 1.0))
    theta_s = min(theta_s, np.radians(89.0))  # model validity clamp

    T = float(turbidity)
    cY = _PEREZ_Y @ [T, 1.0]
    cx = _PEREZ_X @ [T, 1.0]
    cy = _PEREZ_YC @ [T, 1.0]
    Yz, xz, yz = _zenith(T, theta_s)

    H, W = res, 2 * res
    v = (np.arange(H) + 0.5) / H
    u = (np.arange(W) + 0.5) / W
    theta = v * np.pi                      # polar from +z
    phi = u * 2.0 * np.pi
    st = np.sin(theta)[:, None]
    dirs = np.stack([
        np.broadcast_to(st * np.cos(phi)[None, :], (H, W)),
        np.broadcast_to(st * np.sin(phi)[None, :], (H, W)),
        np.broadcast_to(np.cos(theta)[:, None], (H, W)),
    ], axis=-1)

    cos_g = np.clip(dirs @ sun_dir, -1.0, 1.0)
    gamma = np.arccos(cos_g)
    th = np.minimum(theta[:, None] * np.ones((H, W)), np.radians(90.0) - 1e-3)

    denom_Y = _perez(0.0, theta_s, cY)
    denom_x = _perez(0.0, theta_s, cx)
    denom_y = _perez(0.0, theta_s, cy)
    Y = Yz * _perez(th, gamma, cY) / denom_Y
    x = xz * _perez(th, gamma, cx) / denom_x
    y = yz * _perez(th, gamma, cy) / denom_y

    rgb = _xyY_to_rgb(x, y, Y / 25.0)  # normalize kcd/m^2 into render units
    above = dirs[..., 2] > 0.0
    sky_avg = rgb[above].mean(axis=0) if above.any() else np.zeros(3)
    rgb = np.where(above[..., None], rgb, ground_albedo * sky_avg)
    return (scale * rgb).astype(np.float32)


def sun_radiance(turbidity: float = 3.0, sun_scale: float = 1.0):
    """Approximate integrated solar radiance for the `sun` emitter (the
    reference wires sun as a directional light; attenuation by turbidity)."""
    base = np.array([1.0, 0.95, 0.9]) * 50.0
    atten = np.exp(-0.15 * (turbidity - 2.0))
    return (sun_scale * atten * base).astype(np.float32)


def sun_direction_from_angles(elevation_deg: float, azimuth_deg: float = 0.0):
    el = np.radians(elevation_deg)
    az = np.radians(azimuth_deg)
    return np.array([
        np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)
    ], np.float32)
