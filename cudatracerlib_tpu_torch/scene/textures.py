"""Texture table (port of cudatracerlib_tpu/scene/textures.py).

`Textures.build` assembles the same SoA table as the JAX package for
scenes without images; `eval_texture` is ported for CONSTANT and
CHECKERBOARD textures (with their uv transform). Images and any other
texture type set raise NotImplementedError.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._tree import tree_to

CONSTANT = 0
CHECKERBOARD = 1
IMAGE = 2
UV = 3
WIREFRAME = 4
BILERP = 5

WRAP_REPEAT = 0
FILTER_TRILINEAR = 3

PORTED = (CONSTANT, CHECKERBOARD)
ATLAS_RES = 256  # image layers are resampled to ATLAS_RES^2 MIP pyramids
ATLAS_TOTAL = sum((ATLAS_RES >> m) ** 2 for m in range(ATLAS_RES.bit_length()))


class Textures(NamedTuple):
    ttype: torch.Tensor        # (NT,) int32
    color_a: torch.Tensor      # (NT, 3) constant value / checker color 0 / image scale
    color_b: torch.Tensor      # (NT, 3) checker color 1
    uv_xform: torch.Tensor     # (NT, 4) (su, sv, du, dv)
    image_id: torch.Tensor     # (NT,) int32 into atlas layers
    wrap_mode: torch.Tensor    # (NT,) int32
    filter_mode: torch.Tensor  # (NT,) int32
    atlas: torch.Tensor        # (L, ATLAS_TOTAL, 3) flattened mip pyramids

    def to(self, device) -> "Textures":
        return tree_to(self, device)

    @staticmethod
    def build(records: list[dict], images: list[np.ndarray] | None = None) -> "Textures":
        """Host-side constructor from a list of texture dicts."""
        if images:
            raise NotImplementedError("image textures are not ported")
        nt = max(len(records), 1)
        ttype = np.zeros(nt, np.int32)
        ca = np.ones((nt, 3), np.float32)
        cb = np.zeros((nt, 3), np.float32)
        uvx = np.tile(np.array([1.0, 1.0, 0.0, 0.0], np.float32), (nt, 1))
        iid = np.zeros(nt, np.int32)
        wrap = np.zeros(nt, np.int32)
        filt = np.full(nt, FILTER_TRILINEAR, np.int32)
        for i, r in enumerate(records):
            ttype[i] = r.get("type", CONSTANT)
            ca[i] = np.asarray(r.get("color_a", [1, 1, 1]), np.float32)
            cb[i] = np.asarray(r.get("color_b", [0, 0, 0]), np.float32)
            uvx[i] = np.asarray(r.get("uv_xform", [1, 1, 0, 0]), np.float32)
            iid[i] = r.get("image_id", 0)
            wrap[i] = r.get("wrap_mode", WRAP_REPEAT)
            filt[i] = r.get("filter_mode", FILTER_TRILINEAR)
        atlas = np.ones((1, ATLAS_TOTAL, 3), np.float32)  # the no-image atlas
        arrays = dict(ttype=ttype, color_a=ca, color_b=cb, uv_xform=uvx, image_id=iid,
                      wrap_mode=wrap, filter_mode=filt, atlas=atlas)
        return Textures(**{k: torch.from_numpy(v) for k, v in arrays.items()})


def check_ported(active):
    if active is None or not set(active) <= set(PORTED):
        raise NotImplementedError(f"texture types {active}: only {PORTED} are ported")


def eval_texture(tex: Textures, tid, uv, active=None):
    """Evaluate texture `tid` (per-lane int) at uv (..., 2); returns (..., 3).

    `active`: the static tuple of texture types present in the scene. An
    all-CONSTANT set is a row lookup; with CHECKERBOARD present, checker
    lanes take the parity of floor(2 u') + floor(2 v') on the transformed
    uv' = uv * (su, sv) + (du, dv) (reference Texture.h:127)."""
    check_ported(active)
    tid = torch.clamp(torch.as_tensor(tid, device=tex.color_a.device), 0, tex.ttype.shape[0] - 1)
    ca = tex.color_a[tid]
    if set(active) <= {CONSTANT}:
        return ca
    xf = tex.uv_xform[tid]
    uv_t = uv * xf[..., 0:2] + xf[..., 2:4]
    iu = torch.floor(uv_t[..., 0] * 2.0).to(torch.int32)
    iv = torch.floor(uv_t[..., 1] * 2.0).to(torch.int32)
    checker = torch.where((((iu + iv) & 1) == 0)[..., None], ca, tex.color_b[tid])
    return torch.where((tex.ttype[tid] == CHECKERBOARD)[..., None], checker, ca)
