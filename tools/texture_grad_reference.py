"""The JAX package's CPU gradients that chip_smoke.py's phase 23 gates the
port's card gradients on, written to tools/texture_grad_reference.npz (which
chip_smoke.py and tests/test_torch_deluxe.py read) and summarised on
stdout. Two cases, each d mean(render(...)) by `jax.value_and_grad`, at
64x64, 4 spp, seed 0, no Russian roulette:

  deluxe  cornell_box_deluxe(), PTConfig(max_depth=4, rr_start=99), with
          respect to textures.atlas (the normal map's texels) and
          textures.color_a;
  sss     tests/test_sss.py's Marble sphere (tools/texture_cases.sss_case),
          PTConfig(max_depth=6, rr_start=99, sss_steps=16), with respect to
          materials.sss_sigma_s.

With --port the port computes the same on the CPU, for the agreement the
card's gate rests on, and the file is not written. Each run imports one
package only. Run from the root of the repository (JAX ~3 min, most of it
compiling the deluxe gradient; the port ~30 s):
    JAX_PLATFORMS=cpu python tools/texture_grad_reference.py [--port]
"""
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import texture_cases  # noqa: E402

OUT = os.path.join(ROOT, "tools", "texture_grad_reference.npz")
SIZE = dict(width=64, height=64, spp=4, seed=0)
CASES = {
    "deluxe": (dict(max_depth=4, rr_start=99), ["textures.atlas", "textures.color_a"]),
    "sss": (dict(max_depth=6, rr_start=99, sss_steps=16), ["materials.sss_sigma_s"]),
}


def _scenes(port: bool):
    if port:
        from cudatracerlib_tpu_torch.scene import material_lib
        from cudatracerlib_tpu_torch.scene.scene import Materials, build_scene
        from cudatracerlib_tpu_torch.scene.sensors import Camera
        from cudatracerlib_tpu_torch.scene.shapes import cornell_box_deluxe
        from cudatracerlib_tpu_torch.scene.textures import Textures

        kw = dict(device="cpu")
    else:
        from cudatracerlib_tpu.scene import material_lib
        from cudatracerlib_tpu.scene.scene import Materials, build_scene
        from cudatracerlib_tpu.scene.sensors import Camera
        from cudatracerlib_tpu.scene.shapes import cornell_box_deluxe
        from cudatracerlib_tpu.scene.textures import Textures

        kw = {}
    sss = texture_cases.build(texture_cases.sss_case(material_lib.sss_record), build_scene,
                              Materials, Textures, Camera, **kw)
    return {"deluxe": cornell_box_deluxe(**kw), "sss": sss}


def _set(tree, path, value):
    head, _, rest = path.partition(".")
    if not rest:
        return tree._replace(**{head: value})
    return tree._replace(**{head: _set(getattr(tree, head), rest, value)})


def _get(tree, path):
    for name in path.split("."):
        tree = getattr(tree, name)
    return tree


def run_jax():
    import jax
    import jax.numpy as jnp

    from cudatracerlib_tpu.render import path_tracer

    out = {}
    for name, scene in _scenes(False).items():
        cfg, paths = CASES[name]

        def loss(*xs, scene=scene, cfg=cfg, paths=paths):
            sc = scene
            for path, x in zip(paths, xs):
                sc = _set(sc, path, x)
            return jnp.mean(path_tracer.render(sc, SIZE["width"], SIZE["height"], SIZE["spp"],
                                               jnp.uint32(SIZE["seed"]),
                                               path_tracer.PTConfig(**cfg)))

        value, g = jax.value_and_grad(loss, argnums=tuple(range(len(paths))))(
            *(_get(scene, p) for p in paths))
        out[name] = (float(value), {p: np.asarray(x, np.float32) for p, x in zip(paths, g)})
    return "JAX package (CPU)", out


def run_port():
    import torch

    from cudatracerlib_tpu_torch.convert import grads, with_grad
    from cudatracerlib_tpu_torch.render import path_tracer

    torch.set_num_threads(os.cpu_count() or 1)
    out = {}
    for name, scene in _scenes(True).items():
        cfg, paths = CASES[name]
        scene = with_grad(scene, paths)
        value = path_tracer.render(scene, SIZE["width"], SIZE["height"], SIZE["spp"],
                                   SIZE["seed"], path_tracer.PTConfig(**cfg)).mean()
        value.backward()
        out[name] = (float(value.detach()), grads(scene, paths))
    return "port (CPU)", out


def main():
    t0 = time.perf_counter()
    port = "--port" in sys.argv[1:]
    who, out = run_port() if port else run_jax()
    arrays = {}
    for name, (value, g) in out.items():
        arrays[f"{name}/loss"] = np.float64(value)
        summary = []
        for f, x in g.items():
            arrays[f"{name}/{f}"] = x
            top = np.argsort(-np.abs(x.reshape(-1)))[:3]
            summary.append(f"d/d{f} {x.shape}: sum {float(x.sum()):.9g}, nonzero "
                           f"{int((x != 0).sum())}, largest "
                           f"{[(int(i), float(f'{x.reshape(-1)[i]:.9g}')) for i in top]}")
        print(f"{who}: {name}: loss {value:.9g}; " + "; ".join(summary))
    if not port:
        np.savez_compressed(OUT, **arrays)
        print(f"wrote {os.path.relpath(OUT, ROOT)} ({os.path.getsize(OUT)} bytes)")
    print(f"{who}: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
