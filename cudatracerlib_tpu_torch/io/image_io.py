"""Image output: PNG (tone-mapped sRGB) and HDR-ish npz (port of
cudatracerlib_tpu/io/image_io.py).

Counterpart of the reference's FreeImage-based export
(Engine/Image.cpp WriteDisplayImage / main.cpp:172-174). Each writer takes
an (H, W, 3) tensor on any device or an array.
"""
from __future__ import annotations

import numpy as np


def _host(image) -> np.ndarray:
    if hasattr(image, "detach"):
        image = image.detach().cpu().numpy()
    return np.asarray(image, np.float32)


def write_png(path: str, image, gamma_encode: bool = True) -> None:
    from PIL import Image as PILImage

    img = _host(image)
    if gamma_encode:
        img = np.where(
            img <= 0.0031308,
            12.92 * img,
            1.055 * np.power(np.maximum(img, 1e-12), 1 / 2.4) - 0.055,
        )
    q = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
    PILImage.fromarray(q, mode="RGB").save(path)


def write_hdr_npz(path: str, image, **aux) -> None:
    np.savez_compressed(path, image=_host(image),
                        **{k: _host(v) if hasattr(v, "detach") else v for k, v in aux.items()})


def read_hdr_npz(path: str):
    return np.load(path)["image"]
