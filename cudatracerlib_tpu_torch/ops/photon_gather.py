"""Photon-major density estimate: the photon tiles, the CUDA kernel and its
plain version.

Port of the Pallas TPU kernel cudatracerlib_tpu/ops/photon_gather.py:164
(`photon_density_tpu`) and of its host preparation `build_photon_tiles`
(:213). For each gather query it returns [sum w * flux_rgb, sum w] with
w = max(1 - d^2/r^2, 0) * [n_q . n_p > 0.7] * [n_q . wi_p >= 0]; the caller
applies the Epanechnikov normalization 2/(pi r^2) and albedo/pi. The kernel
lives in csrc/photon_gather.cu (its header note says what bounds it on the
H100 and what the design does about it).

Layouts are the JAX package's: tiles (n_tiles, 16, 512) float32 of
attribute rows [x y z |p|^2 r g b nx ny nz wix wiy wiz 0 0 0] with photons
cell-sorted and padded to FAR, and aabbs (n_tiles, 8) = [lo, hi, 0, 0], so
one set of tiles feeds both packages.

`photon_density` is the wrapper: CUDA tensors launch the kernel, CPU tensors
run `photon_density_plain`; it never falls back from one to the other. The
plain version has the same contract and the same per-block tile cull, and
sweeps (query block, surviving tile) pairs in chunks. Both compute each
pair's weight with the same float32 operations in the same order; they sum
in another order, a relative difference of about 1e-5 on the sums.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._build_util import CudaKernel

BQ = 256       # queries per block
PT = 512       # photons per tile
FAR = 1.0e15   # padding position (FAR^2 stays finite in float32)
NORMAL_MIN_DOT = 0.7

# Each launch of the CUDA kernel adds one here (plain-version calls do not).
launches = {"density": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_KERNEL = CudaKernel("photon_gather", [_P, _I, _P, _P, _P, _P, _I, _F, _F, _P, _P])
_PAIRS_PER_CHUNK = {"cpu": 1 << 22}   # (query, photon) pairs per plain-version chunk
_PAIRS_PER_CHUNK_DEFAULT = 1 << 25


def get_lib():
    """Build (once per source hash) and load the kernel's launch function."""
    return _KERNEL.get()


def build_photon_tiles(pos, power, normal, valid, box_min, box_max, res: int, wi):
    """Sort photons by grid cell and pack them into kernel tiles.

    One stable sort by cell id carries every attribute (invalid photons sort
    to the tail). Returns (tiles (n_tiles, 16, PT) float32, aabbs
    (n_tiles, 8) float32). `wi` (P, 3): the photons' incoming directions for
    the front-side test (a zero direction passes it)."""
    P, dev = pos.shape[0], pos.device
    box_min = torch.as_tensor(box_min, dtype=torch.float32, device=dev)
    box_max = torch.as_tensor(box_max, dtype=torch.float32, device=dev)
    inv_cell = res / torch.clamp(box_max - box_min, min=1e-9)
    q = torch.clamp(torch.floor((pos - box_min) * inv_cell).to(torch.int32), 0, res - 1)
    cid = (q[:, 0] * res + q[:, 1]) * res + q[:, 2]
    cid = torch.where(valid, cid, res ** 3)
    order = torch.sort(cid, stable=True)[1]

    sv = valid[order]
    sp, spow, sn, swi = pos[order], power[order], normal[order], wi[order]
    xyz = torch.where(sv[:, None], sp, FAR)
    p2 = (xyz[:, 0] * xyz[:, 0] + xyz[:, 1] * xyz[:, 1]) + xyz[:, 2] * xyz[:, 2]
    flux = torch.where(sv[:, None], spow, 0.0)
    Pp = (P + PT - 1) // PT * PT
    rows = torch.zeros(16, Pp, dtype=torch.float32, device=dev)
    rows[0:3, P:] = FAR
    rows[3, P:] = FAR * FAR
    rows[0:3, :P] = xyz.t()
    rows[3, :P] = p2
    rows[4:7, :P] = flux.t()
    rows[7:10, :P] = sn.t()
    rows[10:13, :P] = swi.t()
    tiles = rows.reshape(16, Pp // PT, PT).transpose(0, 1).contiguous()

    vm = torch.zeros(Pp, dtype=torch.bool, device=dev)
    vm[:P] = sv
    vm = vm.reshape(Pp // PT, 1, PT)
    pos_t = tiles[:, 0:3, :]
    lo = torch.where(vm, pos_t, FAR).amin(2)
    hi = torch.where(vm, pos_t, -FAR).amax(2)
    aabbs = torch.cat([lo, hi, torch.zeros(Pp // PT, 2, device=dev)], dim=1)
    return tiles, aabbs


def _radius2(radius):
    """(r^2, 1/r^2) as float32 host scalars; r^2 >= 1e-20 as in the JAX kernel."""
    r = np.float32(radius)
    r2 = max(r * r, np.float32(1e-20))
    return r2, np.float32(1.0) / r2


def _check(tiles, aabbs, q_pos, q_n, q_valid):
    if tiles.dim() != 3 or tiles.shape[1:] != (16, PT):
        raise ValueError(f"tiles must be (n_tiles, 16, {PT}), got {tuple(tiles.shape)}")
    if aabbs.shape != (tiles.shape[0], 8):
        raise ValueError(f"aabbs must be ({tiles.shape[0]}, 8), got {tuple(aabbs.shape)}")
    if q_pos.dim() != 2 or q_pos.shape[1] != 3 or q_n.shape != q_pos.shape:
        raise ValueError(f"q_pos, q_n must be (B, 3), got {tuple(q_pos.shape)}, {tuple(q_n.shape)}")
    if q_valid.shape != q_pos.shape[:1] or q_valid.dtype != torch.bool:
        raise TypeError(f"q_valid must be a (B,) bool tensor, got {tuple(q_valid.shape)} "
                        f"{q_valid.dtype}")
    for name, x in (("tiles", tiles), ("aabbs", aabbs), ("q_pos", q_pos), ("q_n", q_n)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
    for name, x in (("tiles", tiles), ("aabbs", aabbs), ("q_n", q_n), ("q_valid", q_valid)):
        if x.device != q_pos.device:
            raise ValueError(f"{name} is on {x.device}, q_pos on {q_pos.device}")


def _pad_to_blocks(x):
    """Pad the query dimension (0) with zeros / False to a multiple of BQ."""
    pad = -x.shape[0] % BQ
    return torch.nn.functional.pad(x, (0, 0) * (x.dim() - 1) + (0, pad))


def block_cull(aabbs, q_pos, q_valid, radius):
    """(n_blocks, n_tiles) bool: tile t can hold a photon within `radius` of
    some valid query of block b (blocks of BQ queries in the given order).
    The squared AABB gap is summed as the kernel sums it."""
    q_pos, q_valid = _pad_to_blocks(q_pos), _pad_to_blocks(q_valid)
    r2, _ = _radius2(radius)
    nb = q_pos.shape[0] // BQ
    blo = torch.where(q_valid[:, None], q_pos, FAR).reshape(nb, BQ, 3).amin(1)
    bhi = torch.where(q_valid[:, None], q_pos, -FAR).reshape(nb, BQ, 3).amax(1)
    lo, hi = aabbs[None, :, 0:3], aabbs[None, :, 3:6]
    gap = torch.clamp(torch.maximum(lo - bhi[:, None], blo[:, None] - hi), min=0.0)
    dist = (gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1]) + gap[..., 2] * gap[..., 2]
    return dist <= float(r2)


def surviving_pairs(aabbs, q_pos, q_valid, radius) -> int:
    """(valid query, photon slot) pairs that the sweep visits: for each block,
    its valid queries times PT times its surviving tiles."""
    keep = block_cull(aabbs, q_pos, q_valid, radius)
    per_block = _pad_to_blocks(q_valid).reshape(-1, BQ).sum(1)
    return int((per_block * keep.sum(1)).sum()) * PT


def photon_density_plain(tiles, aabbs, q_pos, q_n, q_valid, radius):
    """Plain PyTorch version of the kernel's contract: per query
    (flux (B, 3), sum_w (B,)); 0 for invalid queries."""
    _check(tiles, aabbs, q_pos, q_n, q_valid)
    B, dev = q_pos.shape[0], q_pos.device
    r2, inv_r2 = _radius2(radius)
    keep = block_cull(aabbs, q_pos, q_valid, radius)
    qp, qn, qv = (_pad_to_blocks(x) for x in (q_pos, q_n, q_valid))
    nb = qp.shape[0] // BQ
    qp, qn = qp.reshape(nb, BQ, 3), qn.reshape(nb, BQ, 3)
    out = torch.zeros(nb, BQ, 4, device=dev)
    pb, pt = keep.nonzero(as_tuple=True)
    chunk = max(1, _PAIRS_PER_CHUNK.get(dev.type, _PAIRS_PER_CHUNK_DEFAULT) // (BQ * PT))
    inv_r2 = float(inv_r2)
    for s in range(0, pb.shape[0], chunk):
        b, t = pb[s:s + chunk], pt[s:s + chunk]
        q, n, ph = qp[b][..., None], qn[b][..., None], tiles[t][:, None]  # (K, BQ, 3, 1), (K, 1, 16, PT)
        dx, dy, dz = (ph[:, :, c] - q[:, :, c] for c in range(3))
        d2 = (dx * dx + dy * dy) + dz * dz
        w = torch.clamp(1.0 - d2 * inv_r2, min=0.0)
        ndot = (n[:, :, 0] * ph[:, :, 7] + n[:, :, 1] * ph[:, :, 8]) + n[:, :, 2] * ph[:, :, 9]
        wdot = (n[:, :, 0] * ph[:, :, 10] + n[:, :, 1] * ph[:, :, 11]) + n[:, :, 2] * ph[:, :, 12]
        w = torch.where((ndot > NORMAL_MIN_DOT) & (wdot >= 0.0), w, 0.0)
        sums = torch.stack([(w * ph[:, :, 4]).sum(-1), (w * ph[:, :, 5]).sum(-1),
                            (w * ph[:, :, 6]).sum(-1), w.sum(-1)], dim=-1)
        out.index_add_(0, b, sums)
    out = torch.where(qv[:, None], out.reshape(-1, 4), 0.0)[:B]
    return out[:, 0:3], out[:, 3]


def photon_density(tiles, aabbs, q_pos, q_n, q_valid, radius):
    """Per query (sum w * flux_rgb (B, 3), sum w (B,)) over the tiled
    photons; `radius` a host scalar. CUDA tensors go to the kernel, CPU
    tensors to the plain version."""
    if q_pos.device.type == "cpu":
        return photon_density_plain(tiles, aabbs, q_pos, q_n, q_valid, radius)
    if q_pos.device.type != "cuda":
        raise ValueError(f"photon_density runs on cuda or cpu tensors, not {q_pos.device}")
    _check(tiles, aabbs, q_pos, q_n, q_valid)
    B = q_pos.shape[0]
    out = torch.empty(B, 4, dtype=torch.float32, device=q_pos.device)
    if B == 0:
        return out[:, 0:3], out[:, 3]
    tiles, aabbs = tiles.contiguous(), aabbs.contiguous()
    if tiles.data_ptr() % 16:
        tiles = tiles.clone()  # the kernel stages tiles through aligned loads
    q_pos, q_n = q_pos.contiguous(), q_n.contiguous()
    q_valid = q_valid.contiguous().view(torch.uint8)
    r2, inv_r2 = _radius2(radius)
    with torch.cuda.device(q_pos.device):
        stream = torch.cuda.current_stream().cuda_stream
    _KERNEL.launch(tiles.data_ptr(), tiles.shape[0], aabbs.data_ptr(), q_pos.data_ptr(),
                   q_n.data_ptr(), q_valid.data_ptr(), B, float(r2), float(inv_r2),
                   out.data_ptr(), stream)
    launches["density"] += 1
    return out[:, 0:3], out[:, 3]
