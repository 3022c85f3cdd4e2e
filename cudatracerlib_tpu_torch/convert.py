"""A port Scene from a JAX package Scene's arrays, and gradients the other
way.

The JAX Scene's leaves, flattened to numpy by field path ("bvh.woop",
"lights.tri_cdf", "camera.to_world", ...), become the port's Scene with the
same arrays, so both packages can compute on identical scene data;
`media_from_numpy` does the same for a JAX Media's arrays.
An instanced JAX Scene's per-mesh `blas` and `instances` tuples come
across as `blas.<i>.bvh.*` and `instances.<i>.*` (a JAX `BlasEntry.clusters`,
the TPU kernel's layout, is dropped: the port's BLAS is its BVH alone), each
BLAS's chunk boxes rebuilt from its Woop rows, and the scene's
specialization set as JAX registers it for instanced scenes.
`skinned_from_numpy` and `refit_plan_from_numpy` carry a JAX `SkinnedMesh`
and `RefitPlan` across; `guiding_from_numpy`, `model_grid_from_numpy`,
`gmm_from_numpy`, `discretized_from_numpy` and `psf_from_numpy` the state of
the guided and game tracers and of the parametric models (a trained
histogram, a PSF cache), so both packages can render from the same state.
`flatten` does that flattening for any tree of NamedTuples (and plain
tuples of them, by index) whose leaves numpy can read: the JAX Scene, a JAX gradient pytree (`jax.grad` of a function of
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

from .accel.bvh import BVH, chunk_boxes_from_woop, vertex_rows
from .accel.refit import RefitPlan
from .models.discretized import DiscretizedModel
from .models.gmm import GMM
from .models.grid import ModelGrid
from .render.guided import Guiding
from .render.realtime import PSFBuffer
from .scene import media as media_mod
from .scene.animation import SkinnedMesh
from .scene.dynamic import instanced_spec
from .scene.instances import BlasEntry, InstanceGroup
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
# `scene_from_numpy` (the dense intersector's boxes, from the Woop rows, and
# the rows' vertices, from the shading vertices; also each BLAS's,
# `blas.<i>.bvh.chunk_boxes` and `blas.<i>.bvh.tri_verts`)
_DERIVED = ("bvh.chunk_boxes", "bvh.tri_verts")
# leaves the port keeps on the host as ints (scene-static: the camera
# model), int32 arrays in `flatten` as in the JAX Scene
_HOST_INTS = {"camera.ctype"}


def flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """{field path: numpy array} over a NamedTuple tree; a plain tuple's
    NamedTuple or array elements go under their index ("blas.0.bvh.woop",
    "plan.level_nodes.0"). None
    leaves, empty tuples and non-array metadata (dicts) are left out."""
    out: dict[str, np.ndarray] = {}
    for name, v in zip(tree._fields, tree):
        key = prefix + name
        if any(key == k or key.endswith("." + k) for k in _DERIVED):
            continue
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            out.update(flatten(v, key + "."))
        elif isinstance(v, tuple) and v and all(hasattr(x, "_fields") for x in v):
            for i, x in enumerate(v):
                out.update(flatten(x, f"{key}.{i}."))
        elif isinstance(v, tuple) and v and all(hasattr(x, "shape") for x in v):
            for i, x in enumerate(v):     # a tuple of arrays (RefitPlan.level_nodes)
                out[f"{key}.{i}"] = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                                     else np.asarray(x))
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


def _tensor(arrays, path, device):
    return torch.from_numpy(np.array(arrays[path])).to(device)


def bvh_from_numpy(arrays: dict[str, np.ndarray], tris: np.ndarray, prefix: str = "",
                   device="cuda") -> BVH:
    """A port BVH on `device` from a JAX BVH's arrays flattened under
    `prefix`, its chunk boxes rebuilt from the Woop rows and its vertex rows
    from `tris`, the rows' (T, 3, 3) leaf-order vertices."""
    woop = _tensor(arrays, prefix + "woop", device)
    verts = vertex_rows(torch.from_numpy(np.array(tris, np.float32))).to(device)
    return BVH(
        nodes=_tensor(arrays, prefix + "nodes", device),
        woop=woop,
        tri_index=_tensor(arrays, prefix + "tri_index", device),
        root_code=np.int32(arrays[prefix + "root_code"]),
        world_min=np.array(arrays[prefix + "world_min"]),
        world_max=np.array(arrays[prefix + "world_max"]),
        chunk_boxes=chunk_boxes_from_woop(woop),
        tri_verts=verts,
    )


def _count(arrays, prefix) -> int:
    """How many tuple elements the keys "<prefix><i>" (leaves) or
    "<prefix><i>." (trees) name."""
    n = 0
    while any(k == f"{prefix}{n}" or k.startswith(f"{prefix}{n}.") for k in arrays):
        n += 1
    return n


def scene_from_numpy(arrays: dict[str, np.ndarray], device="cuda") -> Scene:
    """Build a port Scene on `device` (the card unless the caller asks for
    the CPU) from flattened Scene arrays. The specialization is derived from
    the arrays by specialize_config, or for an instanced scene set here as
    JAX registers it (`dynamic.instanced_spec`: every material's, light's
    and texture's type, shading never flat)."""
    groups = {name: _group(cls, arrays, name, device) for name, cls in _TENSOR_GROUPS.items()}
    instances = tuple(InstanceGroup(**{f: _tensor(arrays, f"instances.{i}.{f}", device)
                                       for f in InstanceGroup._fields})
                      for i in range(_count(arrays, "instances.")))
    sh_verts = np.asarray(arrays["shading.verts"])

    def blas_tris(i):   # a mesh's rows in the concatenated object-space shading tables
        base = int(np.asarray(arrays[f"instances.{i}.prim_base"]).reshape(-1)[0])
        return sh_verts[base:base + np.asarray(arrays[f"blas.{i}.bvh.woop"]).shape[0]]

    blas = tuple(BlasEntry(bvh=bvh_from_numpy(arrays, blas_tris(i), f"blas.{i}.bvh.", device))
                 for i in range(_count(arrays, "blas.")))
    spec = None
    if instances:
        spec = instanced_spec(arrays["materials.bsdf_type"], arrays["lights.ltype"],
                              arrays["textures.ttype"])
    bvh_tris = blas_tris(0) if blas else sh_verts   # an instanced scene's bvh is mesh 0's BLAS
    return Scene(
        bvh=bvh_from_numpy(arrays, bvh_tris, "bvh.", device),
        light_cdf=_tensor(arrays, "light_cdf", device),
        env_light_id=_tensor(arrays, "env_light_id", device),
        spec=spec,
        blas=blas,
        instances=instances,
        **groups,
    )


def refit_plan_from_numpy(arrays: dict[str, np.ndarray], prefix: str = "",
                          device="cuda") -> RefitPlan:
    """A port RefitPlan on `device` from a JAX RefitPlan's arrays flattened
    under `prefix` (`level_nodes.<i>`, `c0`, `c1`)."""
    as_long = lambda path: _tensor(arrays, path, device).long()  # noqa: E731
    return RefitPlan(
        level_nodes=tuple(as_long(f"{prefix}level_nodes.{i}")
                          for i in range(_count(arrays, prefix + "level_nodes."))),
        c0=as_long(prefix + "c0"), c1=as_long(prefix + "c1"))


def skinned_from_numpy(arrays: dict[str, np.ndarray], device="cuda") -> SkinnedMesh:
    """A port SkinnedMesh on `device` from a JAX SkinnedMesh's arrays
    (`flatten` of it: rest, bone_ids, weights, inv_bind, plan.*)."""
    return SkinnedMesh(rest=_tensor(arrays, "rest", device),
                       bone_ids=_tensor(arrays, "bone_ids", device),
                       weights=_tensor(arrays, "weights", device),
                       inv_bind=_tensor(arrays, "inv_bind", device),
                       plan=refit_plan_from_numpy(arrays, "plan.", device))


def media_from_numpy(arrays: dict[str, np.ndarray], device="cuda") -> media_mod.Media:
    """A port Media on `device` (the card unless the caller asks for the
    CPU) from a JAX Media's arrays flattened by field name (`flatten`); its
    `modes` are rebuilt from the arrays."""
    return media_mod.from_arrays(arrays, device)


def model_grid_from_numpy(arrays: dict[str, np.ndarray], prefix: str = "",
                          device="cuda") -> ModelGrid:
    """A port ModelGrid on `device` from a JAX ModelGrid's arrays flattened
    under `prefix` (`box_min`, `inv_cell`, `res`)."""
    return ModelGrid(box_min=_tensor(arrays, prefix + "box_min", device),
                     inv_cell=_tensor(arrays, prefix + "inv_cell", device),
                     res=int(arrays[prefix + "res"]))


def guiding_from_numpy(arrays: dict[str, np.ndarray], device="cuda") -> Guiding:
    """A port Guiding on `device` from a JAX Guiding's arrays (`grid.*`,
    `hist`)."""
    return Guiding(grid=model_grid_from_numpy(arrays, "grid.", device),
                   hist=_tensor(arrays, "hist", device))


def gmm_from_numpy(arrays: dict[str, np.ndarray], device="cuda") -> GMM:
    """A port GMM on `device` from a JAX GMM's arrays."""
    return GMM(**{f: _tensor(arrays, f, device) for f in GMM._fields})


def discretized_from_numpy(arrays: dict[str, np.ndarray], device="cuda") -> DiscretizedModel:
    """A port DiscretizedModel on `device` from a JAX one's arrays (`hist`,
    and its `lo` / `hi` bounds as floats)."""
    return DiscretizedModel(hist=_tensor(arrays, "hist", device), lo=float(arrays["lo"]),
                            hi=float(arrays["hi"]))


def psf_from_numpy(arrays: dict[str, np.ndarray], device="cuda") -> PSFBuffer:
    """A port PSFBuffer on `device` from a JAX PSFBuffer's arrays."""
    return PSFBuffer(**{f: _tensor(arrays, f, device) for f in PSFBuffer._fields})


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
