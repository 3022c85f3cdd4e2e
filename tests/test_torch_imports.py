"""The port imports without JAX, and building its scenes leaves the JAX
package's native library alone."""
import _torch_threads  # noqa: F401  (caps torch's CPU threads under xdist)
import ast
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NATIVE_SO = os.path.join(REPO, "cudatracerlib_tpu", "native", "_native.so")

MODULES = [
    "cudatracerlib_tpu_torch",
    "cudatracerlib_tpu_torch.accel.bvh",
    "cudatracerlib_tpu_torch.accel.hashgrid",
    "cudatracerlib_tpu_torch.accel.refit",
    "cudatracerlib_tpu_torch.accel.traversal",
    "cudatracerlib_tpu_torch.cli",
    "cudatracerlib_tpu_torch.convert",
    "cudatracerlib_tpu_torch.entry",
    "cudatracerlib_tpu_torch.image.debug_viz",
    "cudatracerlib_tpu_torch.image.film",
    "cudatracerlib_tpu_torch.image.pipeline",
    "cudatracerlib_tpu_torch.image.variance",
    "cudatracerlib_tpu_torch.io",
    "cudatracerlib_tpu_torch.io.hair",
    "cudatracerlib_tpu_torch.io.image_io",
    "cudatracerlib_tpu_torch.io.md5",
    "cudatracerlib_tpu_torch.io.mitsuba",
    "cudatracerlib_tpu_torch.io.obj",
    "cudatracerlib_tpu_torch.io.ply",
    "cudatracerlib_tpu_torch.io.serialized",
    "cudatracerlib_tpu_torch.io.sunsky",
    "cudatracerlib_tpu_torch.math.compression",
    "cudatracerlib_tpu_torch.math.dispersion",
    "cudatracerlib_tpu_torch.math.frame",
    "cudatracerlib_tpu_torch.math.fresnel",
    "cudatracerlib_tpu_torch.math.function_model",
    "cudatracerlib_tpu_torch.math.kernels",
    "cudatracerlib_tpu_torch.math.microfacet",
    "cudatracerlib_tpu_torch.math.montecarlo",
    "cudatracerlib_tpu_torch.math.quadrature",
    "cudatracerlib_tpu_torch.math.rough_transmittance",
    "cudatracerlib_tpu_torch.math.spectral",
    "cudatracerlib_tpu_torch.math.spectrum",
    "cudatracerlib_tpu_torch.math.spline",
    "cudatracerlib_tpu_torch.math.vecmath",
    "cudatracerlib_tpu_torch.math.warp",
    "cudatracerlib_tpu_torch.models",
    "cudatracerlib_tpu_torch.models.discretized",
    "cudatracerlib_tpu_torch.models.gmm",
    "cudatracerlib_tpu_torch.models.grid",
    "cudatracerlib_tpu_torch.native",
    "cudatracerlib_tpu_torch.ops.delta_track",
    "cudatracerlib_tpu_torch.ops.intersect_bvh",
    "cudatracerlib_tpu_torch.ops.intersect_dense",
    "cudatracerlib_tpu_torch.ops.photon_gather",
    "cudatracerlib_tpu_torch.ops.shade_gather",
    "cudatracerlib_tpu_torch.ops.transmittance",
    "cudatracerlib_tpu_torch.parallel",
    "cudatracerlib_tpu_torch.parallel.distributed",
    "cudatracerlib_tpu_torch.parallel.shard",
    "cudatracerlib_tpu_torch.render.adaptive",
    "cudatracerlib_tpu_torch.render.bdpt",
    "cudatracerlib_tpu_torch.render.guided",
    "cudatracerlib_tpu_torch.render.light_tracer",
    "cudatracerlib_tpu_torch.render.path_tracer",
    "cudatracerlib_tpu_torch.render.ppm",
    "cudatracerlib_tpu_torch.render.prim_tracer",
    "cudatracerlib_tpu_torch.render.realtime",
    "cudatracerlib_tpu_torch.render.spectral",
    "cudatracerlib_tpu_torch.render.sppm",
    "cudatracerlib_tpu_torch.render.vcm",
    "cudatracerlib_tpu_torch.render.volpath",
    "cudatracerlib_tpu_torch.render.wavefront",
    "cudatracerlib_tpu_torch.sampling.records",
    "cudatracerlib_tpu_torch.sampling.rng",
    "cudatracerlib_tpu_torch.sampling.samplers",
    "cudatracerlib_tpu_torch.scene.animation",
    "cudatracerlib_tpu_torch.scene.bigscene",
    "cudatracerlib_tpu_torch.scene.bsdf",
    "cudatracerlib_tpu_torch.scene.dynamic",
    "cudatracerlib_tpu_torch.scene.instances",
    "cudatracerlib_tpu_torch.scene.lights",
    "cudatracerlib_tpu_torch.scene.material_lib",
    "cudatracerlib_tpu_torch.scene.media",
    "cudatracerlib_tpu_torch.scene.phase",
    "cudatracerlib_tpu_torch.scene.scene",
    "cudatracerlib_tpu_torch.scene.sensors",
    "cudatracerlib_tpu_torch.scene.shade_pack",
    "cudatracerlib_tpu_torch.scene.shapes",
    "cudatracerlib_tpu_torch.scene.textures",
    "cudatracerlib_tpu_torch.utils",
    "cudatracerlib_tpu_torch.utils.checkpoint",
    "cudatracerlib_tpu_torch.utils.settings",
    "cudatracerlib_tpu_torch.utils.timing",
]


def _run(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def test_module_list_is_complete():
    pkg = os.path.join(REPO, "cudatracerlib_tpu_torch")
    found = set()
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py") and not f.startswith("_"):
                rel = os.path.relpath(os.path.join(root, f[:-3]), REPO)
                found.add(rel.replace(os.sep, "."))
    assert found <= set(MODULES), sorted(found - set(MODULES))


def test_port_imports_without_jax():
    out = _run(
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', "
        "'cudatracerlib_tpu.')) or m == 'cudatracerlib_tpu')\n"
        "print('LEAKED', bad)\n")
    assert "LEAKED []" in out, out


def test_port_cornell_build_leaves_jax_native_lib_untouched():
    before = os.stat(JAX_NATIVE_SO).st_mtime_ns
    out = _run(
        "import sys\n"
        "from cudatracerlib_tpu_torch.scene.shapes import cornell_box\n"
        "s = cornell_box(device='cpu')\n"
        "print('WOOP', tuple(s.bvh.woop.shape), 'jax' in sys.modules)\n")
    assert "WOOP (60, 12) False" in out, out
    assert os.stat(JAX_NATIVE_SO).st_mtime_ns == before


def _port_sources():
    pkg = os.path.join(REPO, "cudatracerlib_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "examples", "inverse_rendering_torch.py")
    for name in ("crack_cases.py", "io_cases.py"):   # chip_smoke.py's helpers
        yield os.path.join(REPO, "tools", name)


def _docstrings(tree):
    """ids of the docstring constants of a module, its classes and functions."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                out.add(id(body[0].value))
    return out


def _reaches_jax_package(path):
    """The places in one source that import the JAX package or name a path
    inside it: an import of `cudatracerlib_tpu` (or a module of it), or a
    string constant with `cudatracerlib_tpu` as a path component. Docstrings
    are prose, and the values of `"replaces"` name the TPU kernel a port
    kernel replaces (chip_smoke.py's kernels line): neither opens a file."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    skip = _docstrings(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "replaces":
                    skip.add(id(v))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [(node.lineno, a.name) for a in node.names
                    if a.name.split(".")[0] == "cudatracerlib_tpu"]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if (node.module or "").split(".")[0] == "cudatracerlib_tpu":
                bad.append((node.lineno, node.module))
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and id(node) not in skip
              and "cudatracerlib_tpu" in re.split(r"[/\\\s\"':]+", node.value)):
            bad.append((node.lineno, node.value[:60]))
    return bad


def test_port_reaches_nothing_of_the_jax_package():
    """No module of the port, not chip_smoke.py (nor the tools it imports)
    and not the port's inverse-rendering example imports the JAX package
    or builds a path into it; the SBVH builder compiles the port's own
    copy of the source."""
    from cudatracerlib_tpu_torch import native

    pkg = os.path.join(REPO, "cudatracerlib_tpu_torch") + os.sep
    assert os.path.abspath(native.SRC).startswith(pkg), native.SRC
    assert os.path.isfile(native.SRC), native.SRC
    found = {os.path.relpath(p, REPO): b for p in _port_sources() if (b := _reaches_jax_package(p))}
    assert not found, found


def test_jax_package_scan_catches_a_path_and_an_import(tmp_path):
    """The scan above flags a joined path component, a slash path and an
    import, and leaves docstrings and the port's own name alone."""
    src = tmp_path / "probe.py"
    src.write_text(
        '"""Port of cudatracerlib_tpu/render/ppm.py."""\n'
        "import os\n"
        "A = os.path.join(os.path.dirname(__file__), 'cudatracerlib_tpu', 'native')\n"
        "B = 'cudatracerlib_tpu/native/bvh_builder.cpp'\n"
        "C = 'cudatracerlib_tpu_torch/native/bvh_builder.cpp'\n"
        "K = {'replaces': 'cudatracerlib_tpu/ops/shade_gather.py:69'}\n"
        "def f():\n"
        "    from cudatracerlib_tpu.scene import bsdf\n"
        "    return bsdf\n")
    assert sorted(line for line, _ in _reaches_jax_package(str(src))) == [3, 4, 8]
