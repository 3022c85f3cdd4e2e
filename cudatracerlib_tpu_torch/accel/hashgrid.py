"""Spatial hash grid as sorted cell-id arrays and segment queries
(port of cudatracerlib_tpu/accel/hashgrid.py:33-102).

Points are quantized to cell ids and sorted by cell (a stable sort, as JAX's
argsort is: under a neighbour cap the order decides which points a query
keeps); per-cell [start, end) ranges come from searchsorted. This is the
query-major photon lookup of render/ppm.py: the CPU reference, and on the
card the path of scenes whose gather surfaces are not all DIFFUSE.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class HashGrid(NamedTuple):
    """Regular grid over an AABB with sorted payload."""

    box_min: torch.Tensor     # (3,)
    inv_cell: torch.Tensor    # (3,) 1 / cell size
    res: int                  # grid resolution per axis
    order: torch.Tensor       # (N,) int64 permutation sorting points by cell id
    cell_start: torch.Tensor  # (res^3 + 1,) int64 CSR offsets into the sorted order
    cell_of: torch.Tensor     # (N,) sorted cell ids


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def cell_index(grid_box_min, inv_cell, res: int, p):
    """Quantize world positions (..., 3) to flat cell ids (int32)."""
    q = torch.floor((p - grid_box_min) * inv_cell).to(torch.int32)
    q = torch.clamp(q, 0, res - 1)
    return (q[..., 0] * res + q[..., 1]) * res + q[..., 2]


def build_grid(points, box_min, box_max, res: int, valid=None) -> HashGrid:
    """Sort-based grid build over (N, 3) points. `valid`: optional (N,)
    mask; invalid points sort past the last cell and no query returns them."""
    box_min = _f32(box_min, points.device)
    box_max = _f32(box_max, points.device)
    inv_cell = res / torch.clamp(box_max - box_min, min=1e-9)
    cid = cell_index(box_min, inv_cell, res, points)
    if valid is not None:
        cid = torch.where(valid, cid, res ** 3)
    cid_sorted, order = torch.sort(cid, stable=True)
    cells = torch.arange(res ** 3 + 1, dtype=cid_sorted.dtype, device=points.device)
    cell_start = torch.searchsorted(cid_sorted, cells)
    return HashGrid(box_min=box_min, inv_cell=inv_cell, res=res, order=order,
                    cell_start=cell_start, cell_of=cid_sorted)


_OFFSETS = [[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]


def query_sphere(grid: HashGrid, centers, radius, max_neighbors: int):
    """Up to `max_neighbors` point indices in the 3x3x3 cells around each
    center (cell size >= radius). Returns (idx (B, K) int64 into the
    original points, valid (B, K)). Candidates beyond K are dropped in
    cell order, as in the JAX package (and the reference's fixed-capacity
    grids)."""
    res, K, dev = grid.res, max_neighbors, centers.device
    q = torch.floor((centers - grid.box_min) * grid.inv_cell).to(torch.int64)
    offs = torch.tensor(_OFFSETS, dtype=torch.int64, device=dev)      # (27, 3)
    qq_raw = q[:, None, :] + offs[None]                                 # (B, 27, 3)
    qq = torch.clamp(qq_raw, 0, res - 1)
    is_center = (offs == 0).all(-1)[None, :]
    is_dup = (qq != qq_raw).any(-1) & ~is_center       # clamped at the domain boundary
    cid = (qq[..., 0] * res + qq[..., 1]) * res + qq[..., 2]
    start = grid.cell_start[cid]
    end = grid.cell_start[cid + 1]
    count = torch.where(is_dup, 0, end - start)                         # (B, 27)

    # slot k belongs to the cell whose cumulative count first exceeds k
    cum = torch.cumsum(count, dim=1)
    k = torch.arange(K, device=dev)[None, :]
    cell_sel = (cum[:, :, None] <= k[:, None, :]).sum(1)
    cell_sel = torch.clamp(cell_sel, max=26)                            # (B, K)
    cum_before = cum.gather(1, cell_sel) - count.gather(1, cell_sel)
    src = start.gather(1, cell_sel) + (k - cum_before)
    valid = k < cum[:, -1:]
    src_c = torch.clamp(src, 0, grid.order.shape[0] - 1)
    return grid.order[src_c], valid
