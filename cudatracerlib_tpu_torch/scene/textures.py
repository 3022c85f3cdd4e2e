"""Texture table and MIP-mapped evaluation (port of
cudatracerlib_tpu/scene/textures.py).

All textures of a scene live in one SoA table indexed by texture id. Image
data lives in a fixed-size MIP pyramid atlas: every layer is resampled to
ATLAS_RES² at load, box-downsampled to a full pyramid, and the levels are
flattened into one (L, ATLAS_TOTAL, 3) array, so any (layer, level, x, y)
fetch is a row of the flat (L * ATLAS_TOTAL, 3) atlas at int32 address
arithmetic. Each fetch is one `gather_rows`: a load on the card, and its
cotangent is summed onto the atlas by the gather backward's deterministic
kernels. Anisotropic filtering is the fixed-tap probe scheme: N trilinear
probes along the major footprint axis at the LOD of the minor axis.

`eval_texture` computes what the JAX package's does, type for type: BILERP
has no branch there and returns `color_a`, and WIREFRAME is zero unless
barycentrics are passed (no engine passes them). Evaluation is
differentiable in the colours and the atlas texels.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._tree import tree_to
from ..ops.shade_gather import gather_rows

CONSTANT = 0
CHECKERBOARD = 1
IMAGE = 2
UV = 3
WIREFRAME = 4
BILERP = 5

# wrap modes (MIPMap_device.h:10-17)
WRAP_REPEAT = 0
WRAP_CLAMP = 1
WRAP_MIRROR = 2
WRAP_BLACK = 3

# filter modes (MIPMap_device.h:19-25)
FILTER_POINT = 0
FILTER_BILINEAR = 1
FILTER_ANISOTROPIC = 2
FILTER_TRILINEAR = 3

PORTED = (CONSTANT, CHECKERBOARD, IMAGE, UV, WIREFRAME, BILERP)
ATLAS_RES = 256  # each image layer is resampled to ATLAS_RES^2 at load time
N_LEVELS = ATLAS_RES.bit_length()  # 256 -> 9 levels (256..1)
_LEVEL_RES = [ATLAS_RES >> m for m in range(N_LEVELS)]
_LEVEL_OFFSETS = np.cumsum([0] + [r * r for r in _LEVEL_RES[:-1]]).astype(np.int32)
ATLAS_TOTAL = int(_LEVEL_OFFSETS[-1] + _LEVEL_RES[-1] ** 2)
N_ANISO_PROBES = 4  # fixed-tap anisotropic filtering (replaces the EWA loop)


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
        """Host-side constructor from a list of texture dicts and the images
        (each (H, W) or (H, W, >= 3)) that IMAGE records name by `image_id`."""
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
        if images:
            atlas = np.stack([build_pyramid(_resample(np.asarray(img, np.float32), ATLAS_RES))
                              for img in images])
        else:
            atlas = np.ones((1, ATLAS_TOTAL, 3), np.float32)
        arrays = dict(ttype=ttype, color_a=ca, color_b=cb, uv_xform=uvx, image_id=iid,
                      wrap_mode=wrap, filter_mode=filt, atlas=atlas)
        return Textures(**{k: torch.from_numpy(v) for k, v in arrays.items()})


def _resample(img: np.ndarray, res: int) -> np.ndarray:
    """Nearest-neighbour resample to the atlas resolution (host side)."""
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    h, w = img.shape[:2]
    yi = (np.arange(res) * h // res).clip(0, h - 1)
    xi = (np.arange(res) * w // res).clip(0, w - 1)
    return img[np.ix_(yi, xi)][..., :3].astype(np.float32)


def build_pyramid(level0: np.ndarray) -> np.ndarray:
    """Box-filter mip pyramid of a (R, R, 3) image, flattened to (TOTAL, 3):
    2x2 averaging per level, like the reference's box downsample."""
    levels = [level0]
    cur = level0
    for _ in range(N_LEVELS - 1):
        r = cur.shape[0] // 2
        cur = cur.reshape(r, 2, r, 2, 3).mean(axis=(1, 3))
        levels.append(cur)
    return np.concatenate([lv.reshape(-1, 3) for lv in levels], axis=0)


def check_ported(active):
    """The port always passes the static type set; None (every type, the
    JAX default) and unknown tags are refused."""
    if active is None or not set(active) <= set(PORTED):
        raise NotImplementedError(f"texture types {active}: pass the static tuple of tags in "
                                  f"{PORTED}")


def _wrap_float(u, mode):
    """A float texture coordinate wrapped into [0, 1] by its wrap mode
    (MIPMap_device.h WrapCoordinates); BLACK clamps here and the caller
    masks."""
    rep = u - torch.floor(u)
    cla = torch.clamp(u, 0.0, 1.0)
    period = u - 2.0 * torch.floor(u * 0.5)      # in [0, 2)
    mir = 1.0 - torch.abs(period - 1.0)
    out = torch.where(mode == WRAP_CLAMP, cla, rep)
    out = torch.where(mode == WRAP_MIRROR, mir, out)
    return torch.where(mode == WRAP_BLACK, cla, out)


def _fetch_texels(atlas, layer, level, xi, yi):
    """Texels at integer coordinates of a per-lane mip level: one row
    gather of the flat (L * ATLAS_TOTAL, 3) atlas at the int32 address
    layer * ATLAS_TOTAL + level_offset + y * res + x. The level's offset,
    the sum of (ATLAS_RES >> m)^2 over m < level (`_LEVEL_OFFSETS`), is
    computed in closed form, (ATLAS_RES^2 - res^2) * 4 / 3, so no table is
    copied to the device a call."""
    res = torch.full_like(level, ATLAS_RES) >> level
    offset = (ATLAS_RES * ATLAS_RES - res * res) * 4 // 3
    gaddr = layer * ATLAS_TOTAL + (offset + yi * res + xi)
    return gather_rows(atlas.reshape(-1, 3), gaddr.to(torch.int32))


def _bilinear_level(atlas, layer, uv, level, wrap):
    """Bilinear fetch at a per-lane mip level from the raw uv and wrap
    mode; v is flipped (image rows top-down)."""
    res = torch.full_like(level, ATLAS_RES) >> level
    resf = res.to(torch.float32)
    u = _wrap_float(uv[..., 0], wrap)
    v = _wrap_float(1.0 - uv[..., 1], wrap)
    x = u * resf - 0.5
    y = v * resf - 0.5
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def wrap_i(i):
        # integer texel wrap: REPEAT by floor modulo, the others clamp (the
        # float wrap already folded mirror and clamp; only the +1 neighbour
        # can step out)
        return torch.where(wrap == WRAP_REPEAT, torch.remainder(i, res),
                           torch.minimum(torch.clamp(i, min=0), res - 1))

    x0w, x1w = wrap_i(x0), wrap_i(x0 + 1)
    y0w, y1w = wrap_i(y0), wrap_i(y0 + 1)
    c00 = _fetch_texels(atlas, layer, level, x0w, y0w)
    c01 = _fetch_texels(atlas, layer, level, x1w, y0w)
    c10 = _fetch_texels(atlas, layer, level, x0w, y1w)
    c11 = _fetch_texels(atlas, layer, level, x1w, y1w)
    top = c00 * (1 - fx) + c01 * fx
    bot = c10 * (1 - fx) + c11 * fx
    out = top * (1 - fy) + bot * fy
    outside = (uv[..., 0] < 0) | (uv[..., 0] > 1) | (uv[..., 1] < 0) | (uv[..., 1] > 1)
    return torch.where((outside & (wrap == WRAP_BLACK))[..., None], 0.0, out)


def sample_trilinear(atlas, layer, uv, lod, wrap):
    """Trilinear (mip-lerped bilinear) sample (KernelMIPMap::Sample(uv,
    width), the triangle filter)."""
    lod = torch.clamp(lod, 0.0, float(N_LEVELS - 1))
    l0 = torch.floor(lod).to(torch.int32)
    l1 = torch.clamp(l0 + 1, max=N_LEVELS - 1)
    f = (lod - l0.to(torch.float32))[..., None]
    c0 = _bilinear_level(atlas, layer, uv, l0, wrap)
    c1 = _bilinear_level(atlas, layer, uv, l1, wrap)
    return c0 * (1 - f) + c1 * f


def sample_aniso(atlas, layer, uv, duv0, duv1, wrap, n_probes: int = N_ANISO_PROBES,
                 max_aniso: float = 8.0):
    """Anisotropic filtering: `n_probes` trilinear probes along the major
    footprint axis at the minor axis' LOD, the anisotropy clamped to
    `max_aniso` (the fixed-trip replacement of the reference's EWA loop)."""
    l0 = torch.sqrt((duv0 * duv0).sum(-1) + 1e-20)
    l1 = torch.sqrt((duv1 * duv1).sum(-1) + 1e-20)
    major_len = torch.maximum(l0, l1)
    minor_len = torch.minimum(l0, l1)
    major = torch.where((l0 >= l1)[..., None], duv0, duv1)
    minor_len = torch.maximum(minor_len, major_len / max_aniso)
    lod = torch.log2(torch.clamp(minor_len * ATLAS_RES, min=1e-6))
    acc = 0.0
    for k in range(n_probes):
        t = (k + 0.5) / n_probes - 0.5
        acc = acc + sample_trilinear(atlas, layer, uv + major * t, lod, wrap)
    return acc / n_probes


def _image_lookup(tex: Textures, tid, uv_t, uv_width=None, duv0=None, duv1=None):
    layer = tex.image_id[tid]
    wrap = tex.wrap_mode[tid]
    if duv0 is not None and duv1 is not None:
        smooth = sample_aniso(tex.atlas, layer, uv_t, duv0, duv1, wrap)
    elif uv_width is not None:
        lod = torch.log2(torch.clamp(uv_width * ATLAS_RES, min=1e-6))
        smooth = sample_trilinear(tex.atlas, layer, uv_t, lod, wrap)
    else:
        smooth = None
    base = _bilinear_level(tex.atlas, layer, uv_t, torch.zeros_like(layer), wrap)
    if smooth is None:
        return base
    # per-texture filter mode: POINT and BILINEAR stay at level 0
    filt = tex.filter_mode[tid]
    use_smooth = (filt == FILTER_TRILINEAR) | (filt == FILTER_ANISOTROPIC)
    return torch.where(use_smooth[..., None], smooth, base)


def eval_texture(tex: Textures, tid, uv, bary=None, active=None, uv_width=None, duv0=None,
                 duv1=None):
    """Evaluate texture `tid` (per-lane int) at uv (..., 2); returns (..., 3).

    `active`: the static tuple of texture types present in the scene; a
    type it leaves out is not computed (an all-CONSTANT set is a row
    lookup; without IMAGE the atlas is not read).
    `uv_width`: the isotropic footprint in uv units, for a trilinear mip
    lookup; `duv0` / `duv1`: the footprint ellipse's axes, for anisotropic
    filtering; neither: level 0, bilinear. The transformed uv is
    uv' = uv * (su, sv) + (du, dv); CHECKERBOARD takes the parity of
    floor(2 u') + floor(2 v') (reference Texture.h:127)."""
    check_ported(active)
    tid = torch.clamp(torch.as_tensor(tid, device=tex.color_a.device), 0,
                      tex.ttype.shape[0] - 1)
    ca = gather_rows(tex.color_a, tid)
    if set(active) <= {CONSTANT}:
        return ca
    tt = tex.ttype[tid]
    xf = gather_rows(tex.uv_xform, tid)
    uv_t = uv * xf[..., 0:2] + xf[..., 2:4]
    scale = xf[..., 0:2]

    iu = torch.floor(uv_t[..., 0] * 2.0).to(torch.int32)
    iv = torch.floor(uv_t[..., 1] * 2.0).to(torch.int32)
    checker = torch.where((((iu + iv) & 1) == 0)[..., None], ca, gather_rows(tex.color_b, tid))
    out = torch.where((tt == CHECKERBOARD)[..., None], checker, ca)

    if IMAGE in active:
        w_t = None if uv_width is None else uv_width * scale.abs().amax(-1)
        d0_t = None if duv0 is None else duv0 * scale
        d1_t = None if duv1 is None else duv1 * scale
        image = _image_lookup(tex, tid, uv_t, w_t, d0_t, d1_t) * ca
        out = torch.where((tt == IMAGE)[..., None], image, out)
    if UV in active:
        uvcol = torch.stack([torch.remainder(uv_t[..., 0], 1.0),
                             torch.remainder(uv_t[..., 1], 1.0),
                             torch.zeros_like(uv_t[..., 0])], -1)
        out = torch.where((tt == UV)[..., None], uvcol, out)
    if WIREFRAME in active:
        if bary is None:
            wire = torch.zeros_like(ca)
        else:
            b0 = 1.0 - bary[..., 0] - bary[..., 1]
            edge = torch.minimum(torch.minimum(b0, bary[..., 0]), bary[..., 1]) < 0.02
            wire = edge[..., None].to(ca.dtype).expand_as(ca)
        out = torch.where((tt == WIREFRAME)[..., None], wire, out)
    return out
