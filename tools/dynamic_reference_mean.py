"""The pinned small renders and the pose gradient that chip_smoke.py phase 24
gates the card's dynamic, instanced and adaptive paths on (DYNAMIC_PINS and
REF_POSE_GRAD there), on the scenes of tools/dynamic_cases.py:

  instanced     render_counted of the instanced `_build(8)` scene (3 meshes,
                10 instances), 64x64, 8 spp, seed 3, depth 5: mean and rays;
  skinned_dense render_counted of the skinned sphere (24 x 48: 2,208
                triangles, in the dense band) at pose 2, 64x64, 4 spp, seed
                3, depth 5: mean and rays;
  skinned_bvh   the same with the 64 x 128 sphere (16,128 triangles, above
                the band);
  pose_grad     d mean(render(animate_scene(small sphere, pose))) / d pose at
                pose 2, 64x64, 4 spp, seed 0, depth 4, rr_start 99, on the
                10 x 20 sphere (362 triangles with the floor: JAX's CPU path
                then takes its brute force; its lockstep BVH walk under
                jax.grad compiled for over 25 minutes at 2,208): the loss
                and the (2, 4, 4) gradient;
  adaptive      render_adaptive_host(cornell_box(), 64x64, 4 spp, 3 passes,
                seed 3, depth 5): mean;
  adaptive_wf   render_wavefront_adaptive(glossy_scene(), 32x32, 4 spp, 3
                waves, seed 3, depth 5): mean.

By default the JAX package computes them on the CPU; with --port the port
computes the same on the CPU, for the agreement the gates rest on. Each run
imports one package only. Run from the root of the repository (JAX about 2
minutes, the port about 2):
    JAX_PLATFORMS=cpu python tools/dynamic_reference_mean.py [--port] [case ...]
"""
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import dynamic_cases as dc  # noqa: E402

SIZE = 64
SEED, DEPTH, PIN_POSE = 3, 5, 2
GRAD = dict(spp=4, seed=0, max_depth=4, rr_start=99, n_theta=10, n_phi=20)
WF_SIZE = 32


def _package(port: bool):
    """The package's modules and the device keyword."""
    if port:
        import torch

        from cudatracerlib_tpu_torch.accel.bvh import build_bvh
        from cudatracerlib_tpu_torch.render import adaptive, path_tracer
        from cudatracerlib_tpu_torch.scene import animation, shapes
        from cudatracerlib_tpu_torch.scene.dynamic import DynamicScene
        from cudatracerlib_tpu_torch.scene.scene import Materials, build_scene
        from cudatracerlib_tpu_torch.scene.sensors import Camera
        from cudatracerlib_tpu_torch.scene.textures import Textures

        torch.set_num_threads(os.cpu_count() or 1)
        kw = dict(device="cpu")

        def grad(loss_fn, pose):
            p = torch.from_numpy(pose).requires_grad_()
            loss = loss_fn(p)
            loss.backward()
            return float(loss.detach()), p.grad.numpy()

        as_pose = torch.from_numpy
    else:
        import jax
        import jax.numpy as jnp

        from cudatracerlib_tpu.accel.bvh import build_bvh
        from cudatracerlib_tpu.render import adaptive, path_tracer
        from cudatracerlib_tpu.scene import animation, shapes
        from cudatracerlib_tpu.scene.dynamic import DynamicScene
        from cudatracerlib_tpu.scene.scene import Materials, build_scene
        from cudatracerlib_tpu.scene.sensors import Camera
        from cudatracerlib_tpu.scene.textures import Textures

        kw = {}

        def grad(loss_fn, pose):
            loss, g = jax.value_and_grad(loss_fn)(jnp.asarray(pose))
            return float(loss), np.asarray(g)

        as_pose = jnp.asarray
    return dict(build_bvh=build_bvh, adaptive=adaptive, pt=path_tracer, animation=animation,
                shapes=shapes, DynamicScene=DynamicScene, Materials=Materials,
                build_scene=build_scene, Camera=Camera, Textures=Textures, kw=kw, grad=grad,
                as_pose=as_pose)


def skinned(P, n_theta, n_phi):
    """(scene, rig) of the skinned sphere in package P."""
    inputs = dc.skinned_inputs(P["shapes"], n_theta, n_phi)
    scene = dc.build_skinned(inputs, P["build_scene"], P["Materials"], P["Textures"],
                             P["Camera"], **P["kw"])
    _, host = P["build_bvh"](inputs["vertices"], with_host=True, **P["kw"])
    bone_ids, weights, inv_bind = dc.rig(np.asarray(scene.shading.verts))
    mesh = P["animation"].make_skinned(scene, host["nodes"], host["root"], bone_ids, weights,
                                       inv_bind)
    return scene, mesh


def cases(port: bool):
    """{name: a function returning a dict of results}."""
    P = _package(port)
    pt, kw = P["pt"], P["kw"]
    cfg = pt.PTConfig(max_depth=DEPTH)

    def counted(scene, spp):
        img, rays = pt.render_counted(scene, SIZE, SIZE, spp, SEED, cfg)
        return dict(mean=float(np.asarray(img).mean()), rays=int(rays),
                    finite=bool(np.isfinite(np.asarray(img)).all()))

    def posed(n_theta, n_phi):
        scene, mesh = skinned(P, n_theta, n_phi)
        return counted(P["animation"].animate_scene(scene, mesh,
                                                    P["as_pose"](dc.pose(PIN_POSE))), 4)

    def pose_grad():
        scene, mesh = skinned(P, GRAD["n_theta"], GRAD["n_phi"])
        gcfg = pt.PTConfig(max_depth=GRAD["max_depth"], rr_start=GRAD["rr_start"])

        def loss(p):
            s = P["animation"].animate_scene(scene, mesh, p)
            return pt.render(s, SIZE, SIZE, GRAD["spp"], GRAD["seed"], gcfg).mean()

        value, g = P["grad"](loss, dc.pose(PIN_POSE))
        return dict(loss=value, grad=g.reshape(-1).tolist())

    def adaptive():
        from_shapes = P["shapes"].cornell_box(**kw)
        img = P["adaptive"].render_adaptive_host(from_shapes, SIZE, SIZE, 4, 3, SEED, cfg)
        return dict(mean=float(np.asarray(img).mean()))

    def adaptive_wf():
        img = P["adaptive"].render_wavefront_adaptive(P["shapes"].glossy_scene(**kw), WF_SIZE,
                                                      WF_SIZE, 4, 3, SEED, cfg)
        return dict(mean=float(np.asarray(img).mean()))

    return {
        "instanced": lambda: counted(
            dc.instanced(P["DynamicScene"](**kw), P["shapes"], P["Camera"], 8).update(
                instancing=True), 8),
        "skinned_dense": lambda: posed(24, 48),
        "skinned_bvh": lambda: posed(64, 128),
        "pose_grad": pose_grad,
        "adaptive": adaptive,
        "adaptive_wf": adaptive_wf,
    }


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    port = "--port" in sys.argv[1:]
    who = "port (CPU)" if port else "JAX package (CPU)"
    for name, run in cases(port).items():
        if args and name not in args:
            continue
        t0 = time.perf_counter()
        out = run()
        text = ", ".join(f"{k} {v:.9f}" if isinstance(v, float) else
                         f"{k} [{', '.join(f'{x:.9g}' for x in v)}]" if isinstance(v, list) else
                         f"{k} {v}" for k, v in out.items())
        print(f"{who} {name}: {text}, {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
