"""Maps over trees of tensors: NamedTuples and plain tuples (`tree_map`),
or every container as jax.tree.map walks them (`tree_map_all`)."""
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


def tree_map_all(fn, obj):
    """Copy of `obj` with `fn` applied to every leaf, walking dicts, lists,
    tuples and NamedTuples as jax.tree.map does; None stays None."""
    if obj is None:
        return None
    if isinstance(obj, dict):
        return {k: tree_map_all(fn, v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        items = (tree_map_all(fn, v) for v in obj)
        return type(obj)(*items) if hasattr(obj, "_fields") else type(obj)(items)
    return fn(obj)


def tree_to(obj, device):
    """Copy of `obj` with every tensor leaf moved to `device`."""
    return tree_map(lambda t: t.to(device), obj)


def tree_leaves_with_paths(obj, prefix: tuple = ()):
    """[(path, leaf)] in the JAX package's `jax.tree_util` order: a dict's
    items by sorted key, a NamedTuple's fields, a tuple's or list's items in
    order; None has no leaves; anything else is a leaf. A path is the JAX
    key strings joined by "/" ("['film']", ".woop", "[0]")."""
    if obj is None:
        return []
    if isinstance(obj, dict):
        items = [(f"[{k!r}]", obj[k]) for k in sorted(obj)]
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        items = [(f".{f}", v) for f, v in zip(obj._fields, obj)]
    elif isinstance(obj, (tuple, list)):
        items = [(f"[{i}]", v) for i, v in enumerate(obj)]
    else:
        return [("/".join(prefix), obj)]
    out = []
    for key, v in items:
        out += tree_leaves_with_paths(v, prefix + (key,))
    return out


def tree_unflatten(like, leaves):
    """`like` with its leaves (in `tree_leaves_with_paths` order) replaced
    by `leaves`, in order."""
    it = iter(leaves)

    def build(obj):
        if obj is None:
            return None
        if isinstance(obj, dict):
            new = {k: build(obj[k]) for k in sorted(obj)}
            return {k: new[k] for k in obj}
        if isinstance(obj, tuple) and hasattr(obj, "_fields"):
            return type(obj)(*(build(v) for v in obj))
        if isinstance(obj, (tuple, list)):
            return type(obj)(build(v) for v in obj)
        return next(it)

    return build(like)
