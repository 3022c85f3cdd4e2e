"""Maps over NamedTuple trees of tensors."""
from __future__ import annotations

import torch


def tree_map(fn, obj):
    """Copy of `obj` with `fn` applied to every tensor leaf; NamedTuples
    are walked, every other leaf (numpy arrays, ints, dicts) is kept."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(tree_map(fn, v) for v in obj))
    return obj


def tree_to(obj, device):
    """Copy of `obj` with every tensor leaf moved to `device`."""
    return tree_map(lambda t: t.to(device), obj)
