#!/usr/bin/env python3
"""An earlier and the current backward of the shade-pack gather side by side
on one NVIDIA GPU, at every shape of PERF.md's rows 5a-5j.

Builds `shade_gather_bwd.cu` of an earlier version of the port from a
directory (with the current C interface: `shade_gather_bwd_launch` and
`shade_gather_bwd_scratch`) beside the current kernels, and captures each
shape's (g, idx, n_rows) from the pass that makes it, with chip_smoke.py's
capture helpers:

  pack     2^20 x 64 onto the glossy pack (first-hit prims, seeded g)
  texture  2^20 x 3 onto Cornell's 5 texture rows (a config-1 gradient pass's ids, seeded g)
  woop     2^20 x 12 onto the glossy Woop rows (seeded g)
  pose_woop, pose_verts  a skinned sphere's pose gradient (2^20 x 12 and x 9 onto 19,796 rows)
  bdpt_splat, lt_splat   the BDPT and light-tracer splat sums at bench config 5
  grid     bench config 4's gradient pass: 134,217,728 x 1 onto the plume's 32,769 rows
  table    a 'gen' volume's per-volume table (524,288 x 3 onto 1 row)
  filter   the Gaussian film's taps at bench config 1 (9 x 2^20 x 4 onto 65,537 rows)
  atlas    a deluxe gradient pass's atlas lookup (2^20 x 3 onto 87,381 rows)
  deposit  the guiding deposit (655,360 x 1 onto 32,768 rows)

At each shape it times the whole call (arguments, scratch, launches; CUDA
events over REPS calls) and the kernels alone (prepared arguments) in turns,
earlier, current, current, earlier; `index_add_` (float32, atomics) and the
bytes bound beside them; the current kernels by name under torch.profiler;
and it requires the current result bit-equal to the earlier one on the full
inputs, to itself, and to `packed_gather_bwd_emulated` on 4,096 lanes. It
prints the (tile, row) pairs, the range stage the rule takes (word masks or
bands, and how many) and both scratch sizes. Run from the
root of a checkout, the earlier source extracted first, e.g.

    mkdir -p .chipcheck/old
    git show <commit>:cudatracerlib_tpu_torch/csrc/shade_gather_bwd.cu \\
        > .chipcheck/old/shade_gather_bwd.cu
    python3 tools/ab_gather_bwd.py .chipcheck/old [shape ...]

It prints the current kernels' `-Xptxas -v` report, one line per shape,
then all of them as one JSON object, and exits 1 if a result differs.
"""
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

REPS = 20
SHAPES = ("pack", "texture", "woop", "pose_woop", "pose_verts", "bdpt_splat", "lt_splat", "grid",
          "table", "filter", "atlas", "deposit")


def _earlier(old_dir):
    """The earlier source's whole call: (prepare(g, idx, n_rows) ->
    (args, keep), grad; launch(prepared)), its scratch sized by its own
    `shade_gather_bwd_scratch`."""
    import torch
    from cudatracerlib_tpu_torch._build_util import NVCC_FLAGS, build_shared, load, nvcc_path
    from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops

    lib = load(build_shared(os.path.join(old_dir, "shade_gather_bwd.cu"),
                            "earlier_shade_gather_bwd", [nvcc_path()] + NVCC_FLAGS))
    fn = lib.shade_gather_bwd_launch
    fn.restype, fn.argtypes = ctypes.c_int, sg_ops._BWD_KERNEL.argtypes
    size_fn = lib.shade_gather_bwd_scratch
    size_fn.restype = ctypes.c_longlong
    size_fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]

    def prepare(g, idx, n_rows):
        # the current wrapper's checks and copies, then the earlier scratch size
        sg_ops._check_bwd(g, idx, n_rows)
        g, idx = g.contiguous(), idx.contiguous()
        if g.data_ptr() % 16:
            g = g.clone()
        n, C = g.shape
        grad = torch.empty(n_rows, C, dtype=torch.float32, device=g.device)
        size = size_fn(C, n, n_rows)
        scratch = torch.empty(max(size, 1), dtype=torch.float32, device=g.device)
        args = (g.data_ptr(), C, idx.data_ptr(), n, n_rows, grad.data_ptr(), scratch.data_ptr(),
                size, torch.cuda.current_stream().cuda_stream)
        return (args, (g, idx, scratch)), grad

    def launch(prepared):
        err = fn(*prepared[0])
        if err:
            raise RuntimeError(f"earlier kernel launch failed: cudaError {err}")

    def call(g, idx, n_rows):
        prepared, grad = prepare(g, idx, n_rows)
        launch(prepared)
        return grad
    return call, prepare, launch, size_fn


def _ptxas_report():
    """The current source's registers, spills and shared memory, as
    `nvcc -Xptxas -v` reports them."""
    from cudatracerlib_tpu_torch._build_util import BUILD_DIR, CSRC, nvcc_path

    os.makedirs(BUILD_DIR, exist_ok=True)
    r = subprocess.run([nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                        "-O3", "-Xptxas", "-v", "-cubin", "-o",
                        os.path.join(BUILD_DIR, "shade_gather_bwd_report.cubin"),
                        os.path.join(CSRC, "shade_gather_bwd.cu")],
                       capture_output=True, text=True)
    return [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln
            or "smem" in ln]


def _breakdown(fn, calls=5):
    """Device time per call of each kernel that `fn` launches, by name, under
    torch.profiler (ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.split("::")[-1].split("(")[0][:40]
            out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / calls
    return out


def _capture(label, dev):
    """(g, idx, n_rows) of one shape, captured from the pass that makes it."""
    import torch

    import chip_smoke as cs
    from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops
    from cudatracerlib_tpu_torch.render import path_tracer as pt
    from cudatracerlib_tpu_torch.scene import shapes

    seeded = lambda n, c: torch.rand(  # noqa: E731
        n, c, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    if label in ("pack", "woop"):
        from cudatracerlib_tpu_torch.render import wavefront as wf
        from cudatracerlib_tpu_torch.scene import scene as scene_mod
        from cudatracerlib_tpu_torch.scene import shade_pack

        glossy = shapes.glossy_scene()
        _, go, gd, _ = wf._camera_ray(glossy, torch.arange(cs.W * cs.H * cs.SPP, device=dev), 3,
                                      cs.W, cs.H)
        prims = torch.clamp(scene_mod.scene_intersect(glossy, go, gd).prim, min=0)
        if label == "pack":
            pack = shade_pack.build_shade_pack(glossy)
            return seeded(prims.shape[0], pack.shape[1]), prims, pack.shape[0]
        return seeded(prims.shape[0], 12), prims, glossy.bvh.woop.shape[0]
    if label == "texture":
        cornell = shapes.cornell_box()
        ids = cs._capture_texture_ids(cornell, pt.specialize_config(
            cornell, pt.PTConfig(max_depth=cs.DEPTH)))
        return seeded(ids.shape[0], 3), ids, cornell.textures.color_a.shape[0]
    if label in ("pose_woop", "pose_verts"):
        from cudatracerlib_tpu_torch.accel.bvh import build_bvh
        from cudatracerlib_tpu_torch.scene import animation
        from cudatracerlib_tpu_torch.scene.scene import Materials, build_scene
        from cudatracerlib_tpu_torch.scene.sensors import Camera
        from cudatracerlib_tpu_torch.scene.textures import Textures

        dc = cs._dynamic_cases()
        inputs = dc.skinned_inputs(shapes, 64, 128)
        scene = dc.build_skinned(inputs, build_scene, Materials, Textures, Camera)
        _, host = build_bvh(inputs["vertices"], with_host=True)
        mesh = animation.make_skinned(scene, host["nodes"], host["root"],
                                      *dc.rig(scene.shading.verts.cpu().numpy()))
        gcfg = pt.PTConfig(max_depth=cs.POSE_GRAD["max_depth"],
                           rr_start=cs.POSE_GRAD["rr_start"])

        def pose_loss():
            p = torch.from_numpy(dc.pose(cs.DYNAMIC_PIN["pose"])).cuda().requires_grad_()
            pt.render(animation.animate_scene(scene, mesh, p), cs.W, cs.H, cs.SPP, 7,
                      gcfg).mean().backward()

        n_rows = int(scene.bvh.woop.shape[0])
        _, _, first = cs._bwd_calls(pose_loss)
        return first[(12 if label == "pose_woop" else 9, n_rows)]
    if label in ("bdpt_splat", "lt_splat"):
        from cudatracerlib_tpu_torch.render import bdpt, light_tracer

        caustic = shapes.caustic_scene()
        if label == "bdpt_splat":
            pix, val, n_px = cs._capture_bdpt(caustic, bdpt.BDPTConfig())[2][0]
        else:
            pix, val, n_px = cs._capture_splats(lambda: light_tracer.render_light_trace(
                caustic, cs.PPM_W, cs.PPM_H, cs.PPM_W * cs.PPM_H * cs.PPM_SPP, 0))[0]
        return val.float().contiguous(), pix.to(torch.int32), n_px
    if label == "grid":
        from cudatracerlib_tpu_torch.scene import media as media_mod

        cornell = shapes.cornell_box()
        plume = media_mod.Media.build(media_mod.plume_records(cornell.bvh.world_min,
                                                              cornell.bvh.world_max))
        n_grid = plume.grid_data.shape[0]
        lanes = cs.VOL_W * cs.VOL_H * cs.VOL_SPP * media_mod.TAU_STEPS * 8
        cap, _ = cs._capture_bwd(
            lambda: cs._vol_loss_and_grads(cornell, plume, cs.VGRAD_PATHS, cs.VOL_W, cs.VOL_H,
                                           cs.VOL_SPP, cs.VGRAD_SEED,
                                           pt.PTConfig(max_depth=cs.VOL_DEPTH)),
            lambda g, i, r: r == n_grid and g.shape == (lanes, 1))
        return cap
    if label == "table":
        import numpy as np

        from cudatracerlib_tpu_torch.scene import media as media_mod

        ga = np.zeros((8, 8, 8, 3), np.float32)
        ga[..., 0], ga[..., 2] = 1.0, 0.2
        gs = (0.5 * np.random.default_rng(5).random((8, 8, 8))).astype(np.float32)
        gen = media_mod.Media.build([dict(type=media_mod.GRID, sigma_a=[0.8] * 3,
                                          sigma_s=[0.3] * 3, sigma_a_grid=ga, sigma_s_grid=gs,
                                          box_min=[-2, -3, -2], box_max=[2, -1.5, 2])])
        furnace = shapes.furnace_scene(albedo=0.7)
        cap, _ = cs._capture_bwd(
            lambda: cs._vol_loss_and_grads(furnace, gen, cs.VGRAD_PATHS, 64, 64, 4, 0,
                                           pt.PTConfig(max_depth=3, rr_start=99)),
            lambda g, i, r: r == gen.sigma_a.shape[0] and g.shape[1] == 3)
        return cap
    if label == "filter":
        cornell = shapes.cornell_box()
        fcfg = pt.PTConfig(max_depth=cs.DEPTH, rec_filter=1, rec_radius=1.5)
        _, _, splats = cs._capture_render(lambda: pt.render_counted(cornell, cs.W, cs.H, cs.SPP,
                                                                    0, fcfg))
        pix, val, n_rows = splats[0]
        return val.contiguous(), pix.to(torch.int32), n_rows
    if label == "atlas":
        from cudatracerlib_tpu_torch.scene import textures as tex_mod

        deluxe = shapes.cornell_box_deluxe()
        n_atlas = deluxe.textures.atlas.shape[0] * tex_mod.ATLAS_TOTAL
        lanes = cs.W * cs.H * cs.SPP
        cap, _ = cs._capture_bwd(
            lambda: cs._loss_and_grads(deluxe, ["textures.atlas"], cs.W, cs.H, cs.SPP, 7,
                                       pt.PTConfig(max_depth=cs.DEPTH)),
            lambda g, i, r: r == n_atlas and g.shape == (lanes, 3))
        return cap
    if label == "deposit":
        from cudatracerlib_tpu_torch.render import guided

        ec = cs._engines_cases()
        caustic = shapes.caustic_scene()
        gd = guided.make_guiding(caustic, res=cs.GUIDE_RES)
        n_rows = cs.GUIDE_RES ** 3 * guided.N_DIR_BINS ** 2
        cap, _ = cs._capture_bwd(
            lambda: guided.train_guiding(caustic, gd, cs.GUIDE_PHOTONS, 0,
                                         pt.PTConfig(**ec.TRAIN_CFG)),
            lambda g, i, r: g.shape[1] == 1 and r == n_rows)
        return cap
    raise ValueError(f"unknown shape {label}; shapes: {', '.join(SHAPES)}")


def _measure(label, g, idx, n_rows, earlier, dev):
    """One shape's line (module docstring)."""
    import torch

    import chip_smoke as cs
    from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops

    old_call, old_prepare, old_launch, old_size = earlier
    g, idx = g.contiguous(), idx.contiguous()
    n, cols = g.shape
    new = sg_ops.packed_gather_bwd
    a, b = old_call(g, idx, n_rows), new(g, idx, n_rows)
    torch.cuda.synchronize()
    bit_equal = bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
    deterministic = bool(torch.equal(b.view(torch.int32),
                                     new(g, idx, n_rows).view(torch.int32)))
    gs, ids = g[:4096].contiguous(), idx[:4096].contiguous()
    emu = sg_ops.packed_gather_bwd_emulated(gs.cpu(), ids.cpu(), n_rows)
    emulated = bool(torch.equal(new(gs, ids, n_rows).cpu().view(torch.int32),
                                emu.view(torch.int32)))
    del a, b
    calls, kernels = {}, {}
    prep_new, _ = sg_ops.bwd_launch_args(g, idx, n_rows)
    prep_old, _ = old_prepare(g, idx, n_rows)
    for name in ("earlier", "current", "current", "earlier"):
        call = old_call if name == "earlier" else new
        whole = cs._time_ms(lambda: call(g, idx, n_rows), REPS)  # noqa: B023
        calls.setdefault(name, []).append(whole)
        kernels.setdefault(name, []).append(
            cs._time_kernel_ms([prep_old if name == "earlier" else prep_new] * (REPS + 1),
                               old_launch if name == "earlier" else sg_ops.bwd_launch))
    del prep_new, prep_old
    torch.cuda.empty_cache()
    rows = torch.clamp(idx, 0, n_rows - 1).long()
    lib_ms = cs._time_ms(lambda: torch.zeros(n_rows, cols, device=dev).index_add_(0, rows, g), REPS)
    by_kernel = _breakdown(lambda: new(g, idx, n_rows))
    n_tiles = -(-n // sg_ops.BWD_TILE)
    pairs = int(torch.unique((torch.arange(n, device=dev) // sg_ops.BWD_TILE) * n_rows
                             + rows).numel())
    del rows
    nbytes = n * cols * 4 + n * 4 + n_rows * cols * 4
    bound = cs._bound(n * cols, nbytes)[0]
    masks = sg_ops.bwd_word_masks(n_rows, cols)
    bands, band_rows = (0, 0) if masks else sg_ops.bwd_bands(n_tiles, n_rows, cols)
    r = dict(lanes=n, cols=cols, rows=n_rows, tiles=n_tiles, tile_row_pairs=pairs,
             range_stage="word masks" if masks else "bands",
             row_list_bytes=0 if masks else n_tiles * min(sg_ops.BWD_TILE, n_rows) * 4,
             bands=bands, band_rows=band_rows,
             ranges=-(-n_tiles // sg_ops.bwd_range_tiles(n_tiles)),
             scratch_bytes=sg_ops.bwd_scratch_floats(cols, n, n_rows) * 4,
             earlier_scratch_bytes=old_size(cols, n, n_rows) * 4,
             earlier_ms=calls["earlier"], current_ms=calls["current"],
             earlier_kernels_ms=kernels["earlier"], current_kernels_ms=kernels["current"],
             index_add_ms=lib_ms, bound_ms=bound, by_kernel=by_kernel,
             speedup=min(calls["earlier"]) / max(calls["current"]),
             current_over_index_add=max(calls["current"]) / lib_ms,
             bit_equal_to_earlier=bit_equal, deterministic=deterministic,
             equals_emulation=emulated)
    print(f"[gather_bwd] {label}: {json.dumps(r)}", flush=True)
    return r


def main(old_dir, labels):
    import torch

    if not torch.cuda.is_available():
        print("ab_gather_bwd: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi}")
    with ThreadPoolExecutor(3) as pool:
        f_old, f_new, f_rep = (pool.submit(_earlier, old_dir), pool.submit(sg_ops.get_bwd_lib),
                               pool.submit(_ptxas_report))
        earlier = f_old.result()
        f_new.result()
        for ln in f_rep.result():
            print(f"[ptxas] {ln}")
    results = {"device": smi, "shapes": {}}
    for label in labels:
        g, idx, n_rows = _capture(label, dev)
        results["shapes"][label] = _measure(label, g, idx, n_rows, earlier, dev)
        del g, idx
        torch.cuda.empty_cache()
    print(json.dumps(results))
    ok = all(r["bit_equal_to_earlier"] and r["deterministic"] and r["equals_emulation"]
             for r in results["shapes"].values())
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], sys.argv[2:] or list(SHAPES)))
