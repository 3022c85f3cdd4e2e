"""Pixel debug visualizers: per-pixel auxiliary buffers drawn as images or
geometric overlays (port of cudatracerlib_tpu/image/debug_viz.py; reference
Kernel/PixelDebugVisualizers/).

Buffers are (H, W[, C]) tensors, e.g. any entry of `render_aovs`' dict; the
full-image colorize / normalize passes are tensor ops on the buffer's
device. The geometric overlay drawer stays host-side numpy, as in the JAX
package: it projects world-space segments through the scene camera
(`sensors.sample_direct`, one point a call) and rasterizes lines into a
numpy image. Visualization is not a hot path.
"""
from __future__ import annotations

import numpy as np
import torch


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# full-image visualization (PixelDebugVisualizer<T>::Visualize)
# ---------------------------------------------------------------------------

def colorize(t):
    """Blue -> cyan -> green -> yellow -> red ramp of t in [0, 1]."""
    t = torch.clamp(t, 0.0, 1.0)
    r = torch.clamp(1.5 - (4.0 * t - 3.0).abs(), 0.0, 1.0)
    g = torch.clamp(1.5 - (4.0 * t - 2.0).abs(), 0.0, 1.0)
    b = torch.clamp(1.5 - (4.0 * t - 1.0).abs(), 0.0, 1.0)
    return torch.stack([r, g, b], dim=-1)


def visualize_scalar(buf, normalize: bool = True, scale: float = 1.0):
    """(H, W) scalar buffer -> (H, W, 3) image: normalized to its range and
    colorized, or clipped to [0, 1] as grey."""
    v = torch.as_tensor(buf) * scale
    if normalize:
        lo, hi = v.min(), v.max()
        return colorize((v - lo) / torch.clamp(hi - lo, min=1e-12))
    return torch.clamp(v, 0.0, 1.0)[..., None].repeat_interleave(3, -1)


def visualize_vec2(buf, normalize: bool = True):
    """(H, W, 2) buffer -> RGB: x, y in R, G (0.5 v + 0.5), the magnitude
    in B."""
    v = torch.as_tensor(buf)
    if normalize:
        v = v / torch.clamp(v.abs().max(), min=1e-12)
    mag = torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])
    return torch.stack([v[..., 0] * 0.5 + 0.5, v[..., 1] * 0.5 + 0.5,
                        torch.clamp(mag, 0.0, 1.0)], dim=-1)


def visualize_vec3(buf, normalize: bool = True):
    """(H, W, 3) buffer -> RGB (direction colour coding, 0.5 v + 0.5)."""
    v = torch.as_tensor(buf)
    if normalize:
        v = v / torch.clamp(v.abs().max(), min=1e-12)
    return v * 0.5 + 0.5


def overlay(base, aux, alpha: float = 0.5, mask=None):
    """Alpha-blend an auxiliary visualization over a rendered image; where
    `mask` (H, W) is false the base shows through."""
    base = torch.as_tensor(base)
    out = base * (1 - alpha) + torch.as_tensor(aux) * alpha
    if mask is not None:
        out = torch.where(torch.as_tensor(mask)[..., None], out, base)
    return out


# ---------------------------------------------------------------------------
# per-pixel geometric overlays (IDebugDrawer, host-side)
# ---------------------------------------------------------------------------

class DebugDrawer:
    """Rasterizes world-space debug geometry into an (H, W, 3) numpy image.

    DrawEllipse / DrawEllipsoid / DrawCone are built from DrawLine as the
    reference's defaults are (PixelDebugVisualizer.h:19-67). `project` maps
    a world point to (film uv, in frustum); `camera_projector(camera)`
    builds one.
    """

    def __init__(self, image: np.ndarray, project):
        self.img = image
        self.project = project
        self.h, self.w = image.shape[:2]

    def _to_px(self, p):
        uv, ok = self.project(np.asarray(p, np.float64))
        return uv[0] * self.w, uv[1] * self.h, ok

    def draw_line(self, p1, p2, col=(1.0, 0.0, 0.0)):
        x0, y0, ok0 = self._to_px(p1)
        x1, y1, ok1 = self._to_px(p2)
        if not (ok0 or ok1):
            return
        n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) + 1
        xs = np.linspace(x0, x1, n).round().astype(int)
        ys = np.linspace(y0, y1, n).round().astype(int)
        keep = (xs >= 0) & (xs < self.w) & (ys >= 0) & (ys < self.h)
        self.img[ys[keep], xs[keep]] = np.asarray(col, np.float32)

    def draw_ellipse(self, p, t1, t2, l1, l2, col=(1.0, 0.0, 0.0), n: int = 32):
        p, t1, t2 = (np.asarray(a, np.float64) for a in (p, t1, t2))
        ang = np.linspace(0.0, 2 * np.pi, n)
        pts = p + np.outer(l1 * np.cos(ang), t1) + np.outer(l2 * np.sin(ang), t2)
        for a, b in zip(pts[:-1], pts[1:]):
            self.draw_line(a, b, col)
        self.draw_line(p - t1 * l1, p + t1 * l1, col)
        self.draw_line(p - t2 * l2, p + t2 * l2, col)

    def draw_ellipsoid(self, p, t1, t2, t3, l1, l2, l3, col=(1.0, 0.0, 0.0)):
        self.draw_ellipse(p, t1, t2, l1, l2, col)
        self.draw_ellipse(p, t1, t3, l1, l3, col)
        self.draw_ellipse(p, t2, t3, l2, l3, col)

    def draw_cone(self, p, d, theta, length, col=(1.0, 0.0, 0.0), n: int = 16):
        p = np.asarray(p, np.float64)
        d = np.asarray(d, np.float64)
        d = d / max(np.linalg.norm(d), 1e-12)
        c = p + d * length
        rad = length * np.tan(theta / 2.0)
        a = np.array([1.0, 0.0, 0.0]) if abs(d[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
        t1 = np.cross(d, a)
        t1 /= np.linalg.norm(t1)
        t2 = np.cross(d, t1)
        ang = np.linspace(0.0, 2 * np.pi, n)
        rim = c + np.outer(rad * np.cos(ang), t1) + np.outer(rad * np.sin(ang), t2)
        for q1, q2 in zip(rim[:-1], rim[1:]):
            self.draw_line(q1, q2, col)
            self.draw_line(p, q1, col)


def camera_projector(camera):
    """world point -> (film uv (2,) float64, in frustum) through the scene
    camera (`sensors.sample_direct` on the camera's device)."""
    from ..scene import sensors

    dev = camera.to_world.device

    def project(p):
        q = torch.as_tensor(np.asarray(p), dtype=torch.float32, device=dev)
        uv, _, _, _, ok = sensors.sample_direct(camera, q)
        return uv.cpu().numpy().astype(np.float64), bool(ok)

    return project


def draw_vector_field(image, camera, points, vectors, valid=None,
                      stride: int = 8, scale: float = 1.0,
                      col=(1.0, 0.2, 0.2)):
    """Overlay a sparse world-space vector field onto a rendered image: the
    Vec3f visualizer's per-pixel `Vector` mode on a stride grid.

    `points` / `vectors`: (H, W, 3) world positions and vectors per pixel
    (tensors or arrays). Returns a new numpy image."""
    img = np.array(_np(image), np.float32, copy=True)
    drawer = DebugDrawer(img, camera_projector(camera))
    pts = _np(points)
    vecs = _np(vectors)
    ok = None if valid is None else _np(valid)
    h, w = pts.shape[:2]
    for y in range(stride // 2, h, stride):
        for x in range(stride // 2, w, stride):
            if ok is not None and not ok[y, x]:
                continue
            p = pts[y, x]
            v = vecs[y, x] * scale
            if np.linalg.norm(v) < 1e-12:
                continue
            drawer.draw_line(p, p + v, col)
    return img
