"""Maps over trees of tensors: NamedTuples and plain tuples."""
from __future__ import annotations

import torch


def tree_map(fn, obj):
    """Copy of `obj` with `fn` applied to every tensor leaf; NamedTuples and
    plain tuples (an instanced scene's `blas` and `instances`) are walked,
    every other leaf (numpy arrays, ints, dicts) is kept."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, tuple):
        items = (tree_map(fn, v) for v in obj)
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    return obj


def tree_to(obj, device):
    """Copy of `obj` with every tensor leaf moved to `device`."""
    return tree_map(lambda t: t.to(device), obj)
