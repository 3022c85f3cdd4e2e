"""Shade-pack row gather: the CUDA kernel and its plain version.

Port of the Pallas TPU kernel cudatracerlib_tpu/ops/shade_gather.py:69
(`_gather_tpu`, the forward of `packed_gather` :103). The kernel lives in
csrc/shade_gather.cu (its header note says what bounds it on the H100 and
what the design does about it). It is exact: no bf16 hi/lo split.

Layout: the output is row-major (B, C), one table row per index, and
scene/shade_pack.py `cols` returns column views of it; the JAX package's
(C, B) layout was forced by the TPU's tiling. Forward only: the render runs
without gradients.

`packed_gather` is the wrapper: CUDA tensors launch the kernel, CPU tensors
run the plain version `table[idx.clamp(0, Tr - 1)]`; it never falls back
from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from .._build_util import CudaKernel

MAX_ROWS = 16384   # the shade pack's band (scene/shade_pack.pack_enabled)

# Each launch of the CUDA kernel adds one here (plain-version calls do not).
launches = {"gather": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_KERNEL = CudaKernel("shade_gather", [_P, _I, _I, _P, _I, _P, _P])


def get_lib():
    """Build (once per source hash) and load the kernel's launch function."""
    return _KERNEL.get()


def _check(table, idx):
    if table.dim() != 2 or table.shape[0] == 0 or table.shape[1] % 4:
        raise ValueError(f"table must be (Tr > 0, C % 4 == 0), got {tuple(table.shape)}")
    if table.dtype != torch.float32:
        raise TypeError(f"table must be float32, got {table.dtype}")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise TypeError(f"idx must be a (B,) int32 tensor, got {tuple(idx.shape)} {idx.dtype}")
    if idx.device != table.device:
        raise ValueError(f"idx is on {idx.device}, table on {table.device}")


def packed_gather_plain(table, idx):
    """Plain PyTorch version: rows of `table` at the clamped indices."""
    _check(table, idx)
    return table[torch.clamp(idx, 0, table.shape[0] - 1).long()]


def packed_gather(table, idx):
    """out[b] = table[clamp(idx[b], 0, Tr - 1)]: (Tr, C) float32 x (B,)
    int32 -> (B, C) float32. CUDA tensors go to the kernel, CPU tensors to
    the plain version."""
    if idx.device.type == "cpu":
        return packed_gather_plain(table, idx)
    if idx.device.type != "cuda":
        raise ValueError(f"packed_gather runs on cuda or cpu tensors, not {idx.device}")
    _check(table, idx)
    table, idx = table.contiguous(), idx.contiguous()
    if table.data_ptr() % 16:
        table = table.clone()  # the kernel moves float4s
    out = torch.empty(idx.shape[0], table.shape[1], dtype=torch.float32, device=idx.device)
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream().cuda_stream
    _KERNEL.launch(table.data_ptr(), table.shape[0], table.shape[1], idx.data_ptr(),
                   idx.shape[0], out.data_ptr(), stream)
    launches["gather"] += 1
    return out
