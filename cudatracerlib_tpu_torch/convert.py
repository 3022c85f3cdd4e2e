"""A port Scene from a JAX package Scene's arrays.

The JAX Scene's leaves, flattened to numpy by field path ("bvh.woop",
"lights.tri_cdf", "camera.to_world", ...), become the port's Scene with the
same arrays, so both packages can compute on identical scene data.
`flatten` does that flattening for any NamedTuple tree whose leaves numpy
can read (the JAX Scene, or a port Scene for the way back).
"""
from __future__ import annotations

import numpy as np
import torch

from .accel.bvh import BVH
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


def flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """{field path: numpy array} over a NamedTuple tree. None leaves, empty
    tuples and non-array metadata (dicts) are left out."""
    out: dict[str, np.ndarray] = {}
    for name, v in zip(tree._fields, tree):
        key = prefix + name
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            out.update(flatten(v, key + "."))
        elif isinstance(v, torch.Tensor):
            out[key] = v.detach().cpu().numpy()
        elif v is not None and not isinstance(v, (tuple, dict)):
            out[key] = np.asarray(v)
    return out


def _group(cls, arrays, prefix, device):
    return cls(**{f: torch.from_numpy(np.array(arrays[f"{prefix}.{f}"])).to(device)
                  for f in cls._fields})


def scene_from_numpy(arrays: dict[str, np.ndarray], device="cuda") -> Scene:
    """Build a port Scene on `device` (the card unless the caller asks for
    the CPU) from flattened Scene arrays. The specialization is derived from
    the arrays by specialize_config."""
    groups = {name: _group(cls, arrays, name, device) for name, cls in _TENSOR_GROUPS.items()}
    bvh = BVH(
        nodes=torch.from_numpy(np.array(arrays["bvh.nodes"])).to(device),
        woop=torch.from_numpy(np.array(arrays["bvh.woop"])).to(device),
        tri_index=torch.from_numpy(np.array(arrays["bvh.tri_index"])).to(device),
        root_code=np.int32(arrays["bvh.root_code"]),
        world_min=np.array(arrays["bvh.world_min"]),
        world_max=np.array(arrays["bvh.world_max"]),
    )
    return Scene(
        bvh=bvh,
        light_cdf=torch.from_numpy(np.array(arrays["light_cdf"])).to(device),
        env_light_id=torch.from_numpy(np.array(arrays["env_light_id"])).to(device),
        spec=None,
        **groups,
    )
