"""Caps torch's CPU threads at this process's share of the cores.

Every `tests/test_torch_*.py` imports this module first. Under pytest-xdist
each worker process imports every test module while collecting, so the cap
reaches every worker: with `-n N`, torch runs `cpu_count // N` intra-op
threads per worker instead of one per core in each of the N workers (which
oversubscribes the cores N-fold, beside JAX's own pools). Without xdist the
count is the whole machine, torch's default.
"""
import os

import torch

N_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
torch.set_num_threads(max(1, (os.cpu_count() or 1) // N_WORKERS))
