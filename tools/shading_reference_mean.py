"""The pinned small renders that chip_smoke.py phase 21 gates the card's
surface-shading renders on (SHADING_PINS there): each case at 64x64, 4 spp
(the light tracer 16,384 paths), seed 3, depth 5:

  furnace_*   render_counted of the white furnace with each BSDF this slice
              ports (the cases of tests/test_render.py's
              test_energy_conservation, HK's and NULL_BSDF's default
              fields) and COATING / ROUGHCOATING / BLEND over a DIFFUSE
              inner material (`shapes.nested_furnace_inputs`), the cases
              of the port's `shapes.FURNACE_CASES` and `NESTED_CASES`;
  cornell_*   render_counted of the Cornell box through the THINLENS,
              ORTHOGRAPHIC, SPHERICAL and TELECENTRIC cameras
              (`shapes.CORNELL_CAMERAS`);
  gaussian    render of the Cornell box with rec_filter GAUSSIAN, radius 1.5;
  caustic_reg render of the caustic scene with regularization 0.1;
  lt_ps, bdpt_ps, vcm_ps   the light tracer, BDPT and VCM (pass 1) on the
              Cornell box lit by a point and a spot light
              (`shapes.cornell_point_spot_inputs`);
  lt_furnace  the light tracer on the constant-environment furnace.

By default the JAX package computes them on the CPU; with --port the port
computes the same renders on the CPU, for the agreement the gates rest on.
Both runs take the scenes the port adds from the port's host-side inputs
(numpy), which either package's build_scene takes. Run from the root of the
repository (JAX on the CPU about two minutes; the port about ten, its CPU
intersector being brute force over the furnace's 2,208 triangles):
    JAX_PLATFORMS=cpu python tools/shading_reference_mean.py [--port] [case ...]
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

W = H = 64
SPP, SEED, DEPTH = 4, 3, 5
N_PATHS = W * H * SPP


def cases(port: bool):
    """{name: a function returning (image, rays or None)}."""
    from cudatracerlib_tpu_torch.scene import shapes as tshapes

    if port:
        from cudatracerlib_tpu_torch.render import bdpt, light_tracer, path_tracer, vcm
        from cudatracerlib_tpu_torch.scene.sensors import Camera
        from cudatracerlib_tpu_torch.scene.shapes import caustic_scene, cornell_box, furnace_scene

        kw = dict(device="cpu")

        def build(inp):
            return tshapes.build_inputs(inp, device="cpu")
    else:
        from cudatracerlib_tpu.render import bdpt, light_tracer, path_tracer, vcm
        from cudatracerlib_tpu.scene.scene import Materials, build_scene
        from cudatracerlib_tpu.scene.sensors import Camera
        from cudatracerlib_tpu.scene.shapes import caustic_scene, cornell_box, furnace_scene
        from cudatracerlib_tpu.scene.textures import Textures

        kw = {}

        def build(inp):
            return build_scene(inp["vertices"], None, None, inp["mat_id"],
                               Materials.build(inp["materials"]), Textures.build(inp["textures"]),
                               inp["lights"], Camera.look_at(**inp["camera"]))

    cfg = path_tracer.PTConfig(max_depth=DEPTH)

    def counted(make, config=cfg):
        return lambda: path_tracer.render_counted(make(), W, H, SPP, SEED, config)

    def plain(make, config):
        return lambda: (path_tracer.render(make(), W, H, SPP, SEED, config), None)

    def with_camera(view):
        def make():
            camera = Camera.look_at(**view)
            return cornell_box(**kw)._replace(camera=camera.to("cpu") if port else camera)
        return make

    out = {}
    for name, fkw in tshapes.FURNACE_CASES.items():
        out[f"furnace_{name}"] = counted(lambda fkw=fkw: furnace_scene(**fkw, **kw))
    for name, tag in tshapes.NESTED_CASES.items():
        out[f"furnace_{name}"] = counted(
            lambda tag=tag: build(tshapes.nested_furnace_inputs(tag, **tshapes.NESTED_KW)))
    for name, view in tshapes.CORNELL_CAMERAS.items():
        out[f"cornell_{name}"] = counted(with_camera(view))
    out["gaussian"] = plain(lambda: cornell_box(**kw),
                            path_tracer.PTConfig(max_depth=DEPTH, rec_filter=1, rec_radius=1.5))
    out["caustic_reg"] = plain(lambda: caustic_scene(**kw),
                               path_tracer.PTConfig(max_depth=DEPTH, regularization=0.1))

    def point_spot():
        return build(tshapes.cornell_point_spot_inputs())

    out["lt_ps"] = lambda: (light_tracer.render_light_trace(point_spot(), W, H, N_PATHS, SEED),
                            None)
    out["bdpt_ps"] = lambda: bdpt.render_bdpt_counted(point_spot(), W, H, SPP, SEED)
    out["vcm_ps"] = lambda: (vcm.render_vcm(point_spot(), W, H, SPP, SEED, 1), None)
    out["lt_furnace"] = lambda: (light_tracer.render_light_trace(furnace_scene(**kw), W, H,
                                                                 N_PATHS, SEED), None)
    return out


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    port = "--port" in sys.argv[1:]
    who = "port (CPU)" if port else "JAX package (CPU)"
    if port:
        import torch

        torch.set_num_threads(os.cpu_count() or 1)
    for name, run in cases(port).items():
        if args and name not in args:
            continue
        t0 = time.perf_counter()
        img, rays = run()
        img = np.asarray(img)
        extra = "" if rays is None else f", rays {int(rays)}"
        print(f"{who} {name}: mean {img.mean():.9f}{extra}, finite {bool(np.isfinite(img).all())},"
              f" {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
