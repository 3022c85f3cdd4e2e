"""The port covers the JAX package's public API.

Every `.py` of `cudatracerlib_tpu/` is read as text with `ast` (never
imported). For each module, the port's counterpart must import, and every
public top-level def, class and UPPER constant of the JAX module must be an
attribute of it (`hasattr`, so a name the port re-exports counts). The only
exceptions are the by-design ones in `EXCEPTIONS`: the TPU machinery the port
replaces with its CUDA kernels and its own specialization cache.
"""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import ast
import importlib
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "cudatracerlib_tpu")
WHOLE_MODULE = "*"

# {module: {name: reason}}; a module mapped to {WHOLE_MODULE: reason} has no counterpart
EXCEPTIONS = {
    "accel.clusters": {WHOLE_MODULE: "TPU cluster layout of the Pallas cluster tracer; "
                                     "csrc/intersect_bvh.cu traverses the BVH itself"},
    "ops.intersect_pallas": {WHOLE_MODULE: "the Pallas dense kernel; csrc/intersect_dense.cu"},
    "ops.cluster_trace": {WHOLE_MODULE: "the Pallas cluster kernel; csrc/intersect_bvh.cu"},
    "scene._hostcache": {WHOLE_MODULE: "JAX's host-side cache of jit specializations; the "
                                       "port keeps them on Scene.spec"},
    "ops.photon_gather": {
        "RING": "TPU DMA ring depth of the Pallas kernel",
        "photon_density_tpu": "the Pallas kernel; the port's is photon_density "
                              "(csrc/photon_gather.cu)",
    },
    "ops.shade_gather": {
        "BR": "TPU row block of the Pallas gather",
        "BT": "TPU lane block of the Pallas gather",
    },
    "scene.media": {"ONEHOT_MAX_YZ": "TPU one-hot gather threshold",
                    "media_static": "JAX's host cache of static media fields (Scene.spec)"},
    "scene.scene": {
        "CLUSTER_MIN_TRIS": "TPU threshold for the cluster tracer",
        "small_gather": "TPU one-hot gather for small tables",
        "get_registered_specialization": "JAX's host specialization cache (Scene.spec)",
    },
    "scene.shade_pack": {"get_pack": "JAX's host cache of shade packs (Scene.spec)"},
    "accel.traversal": {"force_intersect_mode": "the CT_* environment knob choosing a TPU "
                                                "intersector"},
    "utils.timing": {"GLOBAL_TIMER": "a process-wide timer nothing read; the port's spans and "
                                     "counters (span, count, counters) replace it",
                     "RayCounter": "host-side rays a second nothing read; the intersectors "
                                   "count their rays (counters())"},
}


def _jax_modules():
    out = []
    for root, _, files in os.walk(JAX_PKG):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), JAX_PKG)[:-3].split(os.sep)
                if rel[-1] == "__init__":
                    rel = rel[:-1]
                out.append(".".join(rel))
    return sorted(out)


def _public_names(module):
    """Public top-level defs, classes and UPPER constants of a JAX module."""
    parts = module.split(".") if module else []
    path = os.path.join(JAX_PKG, *parts)
    path = path + ".py" if os.path.isfile(path + ".py") else os.path.join(path, "__init__.py")
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names += [t.id for t in targets if isinstance(t, ast.Name) and t.id.isupper()]
    return [n for n in names if not n.startswith("_")]


MODULES = _jax_modules()


def test_scan_sees_the_package():
    assert len(MODULES) > 80 and "math.spline" in MODULES and "" in MODULES
    assert set(EXCEPTIONS) <= set(MODULES), sorted(set(EXCEPTIONS) - set(MODULES))
    assert "eval_1d" in _public_names("math.spline")
    assert {"PI", "EPS", "vec3"} <= set(_public_names("math.vecmath"))
    assert "_segment" not in _public_names("math.spline")


@pytest.mark.parametrize("module", MODULES, ids=lambda m: m or "<package>")
def test_port_has_the_public_api(module):
    skip = EXCEPTIONS.get(module, {})
    if WHOLE_MODULE in skip:
        return
    port = importlib.import_module("cudatracerlib_tpu_torch" + ("." + module if module else ""))
    names = _public_names(module)
    assert set(skip) <= set(names), f"stale exceptions {sorted(set(skip) - set(names))}"
    missing = [n for n in names if n not in skip and not hasattr(port, n)]
    assert not missing, f"cudatracerlib_tpu_torch.{module} lacks {missing}"
