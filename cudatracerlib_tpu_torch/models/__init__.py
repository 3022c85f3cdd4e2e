"""Parametric models: on-line EM Gaussian mixtures, discretized
distributions and per-cell model grids (port of cudatracerlib_tpu/models/;
reference Kernel/ParametricModels/)."""
from .gmm import GMM, gmm_init, gmm_em_step, gmm_pdf, gmm_sample  # noqa: F401
from .discretized import (DiscretizedModel, discretized_init,  # noqa: F401
                          discretized_update, discretized_sample,
                          discretized_pdf, histogram_density)
from .grid import ModelGrid, make_model_grid, cell_of_position  # noqa: F401
