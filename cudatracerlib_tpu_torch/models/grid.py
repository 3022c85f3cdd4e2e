"""Per-cell model grids: world positions onto a regular grid of model
instances (port of cudatracerlib_tpu/models/grid.py; reference
Kernel/ParametricModels/GridModelBuffer.h). The buffer of models is the
batched model state (models/gmm.py, models/discretized.py, the guiding
histogram); this module maps a position to its flat cell, as
accel/hashgrid.py does."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..accel.hashgrid import cell_index


class ModelGrid(NamedTuple):
    box_min: torch.Tensor   # (3,)
    inv_cell: torch.Tensor  # (3,)
    res: int


def make_model_grid(box_min, box_max, res: int, device="cuda") -> ModelGrid:
    box_min = torch.as_tensor(box_min, dtype=torch.float32, device=device)
    box_max = torch.as_tensor(box_max, dtype=torch.float32, device=device)
    return ModelGrid(box_min=box_min, inv_cell=res / torch.clamp(box_max - box_min, min=1e-9),
                     res=res)


def cell_of_position(grid: ModelGrid, p):
    """World position (..., 3) -> flat cell id in [0, res^3), int32."""
    return cell_index(grid.box_min, grid.inv_cell, grid.res, p)


def n_cells(grid: ModelGrid) -> int:
    return grid.res ** 3
