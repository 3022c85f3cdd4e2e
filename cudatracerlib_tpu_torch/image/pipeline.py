"""The image pipeline: reconstruction filters, tone mapping, gamma and
non-local-means denoising (port of cudatracerlib_tpu/image/pipeline.py;
reference Kernel/ImagePipeline/).

`filter_eval_1d` is the continuous 1-D filter that filter-importance
splatting (`image/film.add_samples_filtered`) weighs each sample's taps
with; `filter_kernel_1d` and `apply_filter` are the discrete post-process
blur over a finished image, the baseline that splatting is compared
against. `reinhard_tonemap` is the global Reinhard operator
(ToneMapPostProcess.h:8-31), `nlm_denoise` the variance-driven non-local
means (NonLocalMeansFilter.h:13-50) as dense shifted sums over the search
window, and `apply_pipeline` chains the stages in the reference's order
(ImagePipeline.cu:14-52). The blurs (the separable filter and the NLM
patch box) are written as shifted, weighted sums in tap order, so no
convolution library (and no TF32 path on the card) is involved.
"""
from __future__ import annotations

import torch

from ..math.vecmath import PI

BOX = 0
GAUSSIAN = 1
MITCHELL = 2
LANCZOS = 3
TRIANGLE = 4


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _mitchell(t):
    """Mitchell-Netravali with B = C = 1/3 on t in units of the radius."""
    B = C = 1.0 / 3.0
    t = t * 2.0
    t2 = t * t
    t3 = t2 * t
    inner = ((12 - 9 * B - 6 * C) * t3 + (-18 + 12 * B + 6 * C) * t2 + (6 - 2 * B)) / 6.0
    outer = ((-B - 6 * C) * t3 + (6 * B + 30 * C) * t2 + (-12 * B - 48 * C) * t
             + (8 * B + 24 * C)) / 6.0
    return torch.where(t < 1.0, inner, torch.where(t < 2.0, outer, 0.0))


def _sinc(y):
    y = torch.where(y.abs() < 1e-6, 1e-6, y)
    return torch.sin(PI * y) / (PI * y)


def _profile(ftype: int, x, t, radius: float, box):
    if ftype == BOX:
        return box
    if ftype == GAUSSIAN:
        return torch.clamp(torch.exp(-2.0 * x * x) - torch.exp(_f32(-2.0 * radius * radius, x)),
                           min=0.0)
    if ftype == MITCHELL:
        return _mitchell(t)
    if ftype == LANCZOS:
        return torch.where(t < 1.0, _sinc(t * 2.0) * _sinc(t * 2.0 / 3.0), 0.0)
    if ftype == TRIANGLE:
        return torch.clamp(1.0 - t, min=0.0)
    raise ValueError(f"filter type {ftype}: 0 (box) to 4 (triangle)")


def filter_eval_1d(ftype: int, x, radius: float = 2.0):
    """The continuous 1-D filter at offsets x (pixel units): box (|x| <=
    0.5), gaussian, Mitchell, Lanczos or triangle of `radius`, 0 beyond it
    (the box ignores the radius)."""
    t = x.abs() / radius
    k = _profile(ftype, x, t, radius, (x.abs() <= 0.5).to(torch.float32))
    return k if ftype == BOX else torch.where(t <= 1.0, k, 0.0)


def filter_kernel_1d(ftype: int, radius: float = 2.0, taps: int = 5, device="cpu"):
    """Discrete 1-D filter taps centred on 0, normalised to sum 1."""
    x = torch.arange(taps, dtype=torch.float32, device=device) - (taps - 1) / 2
    t = x.abs() / radius
    k = _profile(ftype, x, t, radius, (t <= (0.5 / radius)).to(torch.float32))
    return k / torch.clamp(k.sum(), min=1e-9)


def _blur_axis(img, k, axis: int):
    """Correlate `img` (H, W, C) with taps k along `axis`, zero-padded to
    the same size, summing the taps in order."""
    taps = k.shape[0]
    r = (taps - 1) // 2
    pad = [0, 0, 0, 0, 0, 0]
    pad[2 * (2 - axis)], pad[2 * (2 - axis) + 1] = r, taps - 1 - r
    padded = torch.nn.functional.pad(img, pad)
    n = img.shape[axis]
    out = None
    for i in range(taps):
        term = k[i] * padded.narrow(axis, i, n)
        out = term if out is None else out + term
    return out


def apply_filter(image, ftype: int = GAUSSIAN, radius: float = 2.0, taps: int = 5):
    """Separable filter over an (H, W, 3) image: vertical, then horizontal."""
    if ftype == BOX and taps <= 1:
        return image
    k = filter_kernel_1d(ftype, radius, taps, device=image.device)
    return _blur_axis(_blur_axis(image, k, 0), k, 1)


def reinhard_tonemap(image, key: float = 0.18, burn: float = 1.0):
    """Reinhard global operator (ToneMapPostProcess.h:8-31): the luminance
    scaled to `key` by its log average, white at burn times the largest."""
    lum = 0.212671 * image[..., 0] + 0.715160 * image[..., 1] + 0.072169 * image[..., 2]
    log_avg = torch.exp(torch.log(torch.clamp(lum, min=1e-6)).mean())
    scaled = key / torch.clamp(log_avg, min=1e-9) * lum
    lwhite2 = torch.clamp(burn * scaled.amax(), min=1e-6) ** 2
    mapped = scaled * (1.0 + scaled / lwhite2) / (1.0 + scaled)
    return image * (mapped / torch.clamp(lum, min=1e-9))[..., None]


def gamma_correct(image, gamma: float = 2.2):
    return torch.pow(torch.clamp(image, min=0.0), 1.0 / gamma)


def _box_same(img, patch: int):
    """The mean over each pixel's patch x patch window, zero-padded to the
    same size (a box convolution), taps summed row-major."""
    pr = (patch - 1) // 2
    H, W = img.shape[:2]
    padded = torch.nn.functional.pad(img, (0, 0, pr, patch - 1 - pr, pr, patch - 1 - pr))
    out = None
    for i in range(patch):
        for j in range(patch):
            term = padded[i:i + H, j:j + W] * (1.0 / (patch * patch))
            out = term if out is None else out + term
    return out


def nlm_denoise(image, variance, strength: float = 0.5, patch: int = 3, window: int = 7):
    """Non-local means weighted by per-pixel variance estimates
    (NonLocalMeansFilter.h:13-50): over the window's (wrapped) shifts, the
    patch distance of the variance-normalised squared differences sets each
    shifted image's weight."""
    wr = window // 2
    var = torch.clamp(variance, min=1e-8)[..., None]
    acc = torch.zeros_like(image)
    wacc = torch.zeros(image.shape[:2] + (1,), device=image.device)
    for dy in range(-wr, wr + 1):
        for dx in range(-wr, wr + 1):
            shifted = torch.roll(image, (dy, dx), dims=(0, 1))
            d2 = _box_same((image - shifted) ** 2 / var, patch)
            w = torch.exp(-d2.mean(-1, keepdim=True)
                          / max(2.0 * strength * strength, 1e-6))
            acc = acc + w * shifted
            wacc = wacc + w
    return acc / torch.clamp(wacc, min=1e-9)


def apply_pipeline(image, variance=None, filter_type: int = BOX, tonemap: bool = False,
                   denoise: bool = False, gamma: float | None = None):
    """The stage chain in the reference's order (ImagePipeline.cu:14-52):
    filter, denoise (with a variance), tone map, gamma."""
    out = image
    if filter_type != BOX:
        out = apply_filter(out, filter_type)
    if denoise and variance is not None:
        out = nlm_denoise(out, variance)
    if tonemap:
        out = reinhard_tonemap(out)
    if gamma is not None:
        out = gamma_correct(out, gamma)
    return out
