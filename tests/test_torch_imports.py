"""The port imports without JAX, and building its scenes leaves the JAX
package's native library alone."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NATIVE_SO = os.path.join(REPO, "cudatracerlib_tpu", "native", "_native.so")

MODULES = [
    "cudatracerlib_tpu_torch",
    "cudatracerlib_tpu_torch.accel.bvh",
    "cudatracerlib_tpu_torch.accel.traversal",
    "cudatracerlib_tpu_torch.convert",
    "cudatracerlib_tpu_torch.math.frame",
    "cudatracerlib_tpu_torch.math.fresnel",
    "cudatracerlib_tpu_torch.math.microfacet",
    "cudatracerlib_tpu_torch.math.montecarlo",
    "cudatracerlib_tpu_torch.math.rough_transmittance",
    "cudatracerlib_tpu_torch.math.vecmath",
    "cudatracerlib_tpu_torch.math.warp",
    "cudatracerlib_tpu_torch.native",
    "cudatracerlib_tpu_torch.ops.intersect_bvh",
    "cudatracerlib_tpu_torch.ops.intersect_dense",
    "cudatracerlib_tpu_torch.ops.shade_gather",
    "cudatracerlib_tpu_torch.render.path_tracer",
    "cudatracerlib_tpu_torch.render.wavefront",
    "cudatracerlib_tpu_torch.sampling.records",
    "cudatracerlib_tpu_torch.sampling.rng",
    "cudatracerlib_tpu_torch.scene.bsdf",
    "cudatracerlib_tpu_torch.scene.lights",
    "cudatracerlib_tpu_torch.scene.scene",
    "cudatracerlib_tpu_torch.scene.sensors",
    "cudatracerlib_tpu_torch.scene.shade_pack",
    "cudatracerlib_tpu_torch.scene.shapes",
    "cudatracerlib_tpu_torch.scene.textures",
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
