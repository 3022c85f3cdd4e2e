"""A port Scene from a JAX package Scene's arrays, and gradients the other
way.

The JAX Scene's leaves, flattened to numpy by field path ("bvh.woop",
"lights.tri_cdf", "camera.to_world", ...), become the port's Scene with the
same arrays, so both packages can compute on identical scene data;
`media_from_numpy` does the same for a JAX Media's arrays.
`flatten` does that flattening for any NamedTuple tree whose leaves numpy
can read: the JAX Scene, a JAX gradient pytree (`jax.grad` of a function of
the Scene, whose leaves are the gradients), or a port Scene for the way
back. `with_grad` makes chosen leaves of a port Scene require grad, and
`grads` reads their `.grad` by the same field paths, so a JAX gradient and
the port's compare field by field. Both take a port Media as they take a
Scene (fields `grid_data`, `sigma_a`, `sigma_s`, `le`, ...); its host-side
`modes` tuple is carried along unchanged.
"""
from __future__ import annotations

import numpy as np
import torch

from .accel.bvh import BVH, chunk_boxes_from_woop
from .scene import media as media_mod
from .scene.lights import Lights
from .scene.scene import Materials, Scene, ShadingData
from .scene.sensors import Camera
from .scene.textures import Textures

_TENSOR_GROUPS = {
    "shading": ShadingData,
    "materials": Materials,
    "textures": Textures,
    "lights": Lights,
    "camera": Camera,
}
# port-only leaves derived from others: left out of `flatten`, rebuilt by
# `scene_from_numpy` (the dense intersector's boxes, from the Woop rows)
_DERIVED = {"bvh.chunk_boxes"}
# leaves the port keeps on the host as ints (scene-static: the camera
# model), int32 arrays in `flatten` as in the JAX Scene
_HOST_INTS = {"camera.ctype"}


def flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """{field path: numpy array} over a NamedTuple tree. None leaves, empty
    tuples and non-array metadata (dicts) are left out."""
    out: dict[str, np.ndarray] = {}
    for name, v in zip(tree._fields, tree):
        key = prefix + name
        if key in _DERIVED:
            continue
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            out.update(flatten(v, key + "."))
        elif isinstance(v, torch.Tensor):
            out[key] = v.detach().cpu().numpy()
        elif key in _HOST_INTS and isinstance(v, int):   # the port's; JAX's are arrays
            out[key] = np.asarray(v, np.int32)
        elif v is not None and not isinstance(v, (tuple, dict)):
            out[key] = np.asarray(v)
    return out


def _group(cls, arrays, prefix, device):
    def leaf(path):
        if path in _HOST_INTS:
            return int(arrays[path])
        return torch.from_numpy(np.array(arrays[path])).to(device)
    return cls(**{f: leaf(f"{prefix}.{f}") for f in cls._fields})


def scene_from_numpy(arrays: dict[str, np.ndarray], device="cuda") -> Scene:
    """Build a port Scene on `device` (the card unless the caller asks for
    the CPU) from flattened Scene arrays. The specialization is derived from
    the arrays by specialize_config."""
    groups = {name: _group(cls, arrays, name, device) for name, cls in _TENSOR_GROUPS.items()}
    woop = torch.from_numpy(np.array(arrays["bvh.woop"])).to(device)
    bvh = BVH(
        nodes=torch.from_numpy(np.array(arrays["bvh.nodes"])).to(device),
        woop=woop,
        tri_index=torch.from_numpy(np.array(arrays["bvh.tri_index"])).to(device),
        root_code=np.int32(arrays["bvh.root_code"]),
        world_min=np.array(arrays["bvh.world_min"]),
        world_max=np.array(arrays["bvh.world_max"]),
        chunk_boxes=chunk_boxes_from_woop(woop),
    )
    return Scene(
        bvh=bvh,
        light_cdf=torch.from_numpy(np.array(arrays["light_cdf"])).to(device),
        env_light_id=torch.from_numpy(np.array(arrays["env_light_id"])).to(device),
        spec=None,
        **groups,
    )


def media_from_numpy(arrays: dict[str, np.ndarray], device="cuda") -> media_mod.Media:
    """A port Media on `device` (the card unless the caller asks for the
    CPU) from a JAX Media's arrays flattened by field name (`flatten`); its
    `modes` are rebuilt from the arrays."""
    return media_mod.from_arrays(arrays, device)


def get_field(tree, path: str):
    """The leaf of a NamedTuple tree at a dotted field path."""
    for name in path.split("."):
        tree = getattr(tree, name)
    return tree


def set_field(tree, path: str, value):
    """A copy of a NamedTuple tree with the leaf at `path` replaced."""
    head, _, rest = path.partition(".")
    if not rest:
        return tree._replace(**{head: value})
    return tree._replace(**{head: set_field(getattr(tree, head), rest, value)})


def with_grad(tree, paths=None):
    """A copy of a port tree whose leaves at `paths` (every floating-point
    tensor leaf by default) are fresh copies that require grad."""
    if paths is None:
        paths = [k for k in flatten(tree) if isinstance(leaf := get_field(tree, k), torch.Tensor)
                 and leaf.is_floating_point()]
    for path in paths:
        tree = set_field(tree, path, get_field(tree, path).detach().clone().requires_grad_())
    return tree


def grads(tree, paths=None) -> dict[str, np.ndarray]:
    """{field path: the leaf's .grad as numpy} over `paths` (every leaf that
    requires grad by default); a leaf that got no gradient reads as zeros,
    as a JAX gradient of an unused input does."""
    if paths is None:
        paths = [k for k in flatten(tree)
                 if getattr(get_field(tree, k), "requires_grad", False)]
    out = {}
    for path in paths:
        leaf = get_field(tree, path)
        g = leaf.grad
        out[path] = (np.zeros(tuple(leaf.shape), np.float32) if g is None
                     else g.detach().cpu().numpy())
    return out
