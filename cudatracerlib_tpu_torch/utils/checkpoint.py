"""Checkpoint/resume of progressive rendering state (port of
cudatracerlib_tpu/utils/checkpoint.py).

The reference has none (SURVEY.md §5: errors kill the process, film state is
lost); this module adds restartable progressive rendering: film + pass count +
sampler seed state serialize to npz, so a killed job resumes mid-render.
Scene parameters (for inverse rendering) round-trip the same way.

The file format is the JAX package's: one array `leaf_<i>` per leaf in
`jax.tree_util`'s order (`_tree.tree_leaves_with_paths`: dict keys sorted,
NamedTuple fields, sequence items), their paths in `__paths__`, written with
`np.savez_compressed` to a temporary file renamed into place. A checkpoint
written by either package loads in the other where the leaves line up.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from .._tree import tree_leaves_with_paths, tree_unflatten


def _host(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree: Any) -> None:
    pairs = tree_leaves_with_paths(tree)
    arrays = {f"leaf_{i}": _host(leaf) for i, (_, leaf) in enumerate(pairs)}
    arrays["__paths__"] = np.asarray([p for p, _ in pairs], dtype=object)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)


def load_pytree(path: str, like: Any) -> Any:
    """The tree saved at `path`, shaped as `like`: each leaf a tensor on the
    device of `like`'s leaf where that is a tensor, else on the CPU."""
    z = np.load(path, allow_pickle=True)
    leaves = [leaf for _, leaf in tree_leaves_with_paths(like)]
    out = []
    for i, leaf in enumerate(leaves):
        dev = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
        out.append(torch.from_numpy(np.array(z[f"leaf_{i}"])).to(dev))
    return tree_unflatten(like, out)


class ProgressiveCheckpoint:
    """Every-K-pass film checkpointing for a restartable pass loop."""

    def __init__(self, path: str, every: int = 16):
        self.path = path
        self.every = every

    def maybe_save(self, film, pass_idx: int) -> None:
        if (pass_idx + 1) % self.every == 0:
            save_pytree(self.path, {"film": film, "pass_idx": np.int32(pass_idx)})

    def load(self, film_like):
        if not os.path.exists(self.path):
            return None, 0
        state = load_pytree(self.path, {"film": film_like, "pass_idx": np.int32(0)})
        return state["film"], int(state["pass_idx"]) + 1
