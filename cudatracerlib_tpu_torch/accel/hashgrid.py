"""Spatial hash grid as sorted cell-id arrays and segment queries
(port of cudatracerlib_tpu/accel/hashgrid.py).

Points are quantized to cell ids and sorted by cell (a stable sort, as JAX's
argsort is: under a neighbour cap the order decides which points a query
keeps); per-cell [start, end) ranges come from searchsorted. This is the
query-major photon lookup of render/ppm.py (the CPU reference, and on the
card the path of scenes whose gather surfaces are not all DIFFUSE), of
render/vcm.py's merge and of render/sppm.py, whose volume estimators take
the systematically subsampled query.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .._tree import tree_map_all


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


def _candidates(grid: HashGrid, centers):
    """(start, count) (B, 27) of the 3x3x3 cells around each center in the
    sorted order; a neighbour cell clamped onto another at the domain
    boundary counts no points."""
    res, dev = grid.res, centers.device
    q = torch.floor((centers - grid.box_min) * grid.inv_cell).to(torch.int64)
    offs = torch.tensor(_OFFSETS, dtype=torch.int64, device=dev)      # (27, 3)
    qq_raw = q[:, None, :] + offs[None]                                 # (B, 27, 3)
    qq = torch.clamp(qq_raw, 0, res - 1)
    is_center = (offs == 0).all(-1)[None, :]
    is_dup = (qq != qq_raw).any(-1) & ~is_center
    cid = (qq[..., 0] * res + qq[..., 1]) * res + qq[..., 2]
    start = grid.cell_start[cid]
    end = grid.cell_start[cid + 1]
    return start, torch.where(is_dup, 0, end - start)


def _pick(grid: HashGrid, start, count, k):
    """The point index of each query's k-th candidate (k (B | 1, K), in
    cell order): slot k belongs to the cell whose cumulative count first
    exceeds k."""
    cum = torch.cumsum(count, dim=1)
    cell_sel = (cum[:, :, None] <= k[:, None, :]).sum(1)
    cell_sel = torch.clamp(cell_sel, max=26)                            # (B, K)
    cum_before = cum.gather(1, cell_sel) - count.gather(1, cell_sel)
    src = start.gather(1, cell_sel) + (k - cum_before)
    return grid.order[torch.clamp(src, 0, grid.order.shape[0] - 1)], cum[:, -1]


def query_sphere(grid: HashGrid, centers, radius, max_neighbors: int):
    """Up to `max_neighbors` point indices in the 3x3x3 cells around each
    center (cell size >= radius). Returns (idx (B, K) int64 into the
    original points, valid (B, K)). Candidates beyond K are dropped in
    cell order, as in the JAX package (and the reference's fixed-capacity
    grids)."""
    start, count = _candidates(grid, centers)
    k = torch.arange(max_neighbors, device=centers.device)[None, :]
    idx, n_total = _pick(grid, start, count, k)
    return idx, k < n_total[:, None]


def query_sphere_sampled(grid: HashGrid, centers, max_neighbors: int):
    """The 3x3x3-cell neighbourhood subsampled systematically (JAX
    accel/hashgrid.py:105-147): of a query's N candidates it returns those
    at floor(k * stride), k < K, stride = max(N / K, 1) in float32, and the
    per-query weight stride (N / K above K candidates, else 1), which makes
    a weighted sum over the returned set unbiased where a first-K cut is
    biased low. Returns (idx (B, K) int64, valid (B, K), weight (B,) f32)."""
    start, count = _candidates(grid, centers)
    n_total = count.sum(1)
    stride = torch.clamp(n_total.to(torch.float32) / max_neighbors, min=1.0)
    k = torch.arange(max_neighbors, dtype=torch.float32, device=centers.device)[None, :]
    g = torch.floor(k * stride[:, None]).to(count.dtype)                # (B, K)
    idx, _ = _pick(grid, start, count, g)
    return idx, g < n_total[:, None], stride


def query_reduce(grid: HashGrid, points_sorted_payload, centers, radius,
                 max_neighbors: int, reduce_fn, init):
    """Gather each center's neighbours (`query_sphere`) and fold
    `reduce_fn(init, payload, valid)`. The payload is a tensor or a dict /
    list / tuple / NamedTuple of (N, ...) tensors indexed like the original
    points; each leaf arrives gathered as (B, K, ...)."""
    idx, valid = query_sphere(grid, centers, radius, max_neighbors)
    payload = tree_map_all(lambda a: a[idx], points_sorted_payload)
    return reduce_fn(init, payload, valid)
