#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments: `python3 chip_smoke.py`.
It imports nothing of JAX. Phases, each of which raises on failure:

  1. device: the card's name and power limit (nvidia-smi), the device count;
  2. build: the five CUDA sources (nvcc, sm_90a, one process per source,
     all started together) and the SBVH builder (g++, the port's own
     native/bvh_builder.cpp) from the sources in the checkout, each timed;
  3. kernel vs plain, `intersect_dense`: against its plain PyTorch version
     on the same CUDA tensors, closest-hit and any-hit, at the Cornell path's
     shapes (60 Woop rows vs the camera rays and first-bounce rays of a
     256x256, 16-spp pass), at the PPM path's (its arguments captured in a
     warm bench-config-5 pass at seed 0: the first photon-walk launch, 2^17
     lanes x 3,160 rows, the first eye launch and the shadow-ray launch,
     65,536 lanes each) and at the top of the dense band (a random
     4096-triangle soup vs 2^20 random rays). Tolerance: `valid` agrees on
     >= 99.999% of rays and every disagreement is edge-grazing; on rays both
     hit at equal Woop rows, t within 1e-4 * max(1, t) and the barycentrics
     within 1e-4. The wrapper, the kernel alone (prebuilt ranges and
     outputs) and the plain version are timed with CUDA events. The bound
     counts every box test plus the rows of the chunks each ray's box test
     passes at its final t (`cull_sweep`, the plain cull emulation); the
     all-rows figure of the old sweep is printed beside it. As a yardstick,
     not gated, `intersect_bvh` is timed on the PPM rays over the caustic
     BVH;
  4. Cornell path: the Cornell box at bench config 1 (256x256, 16 spp, depth
     5), built on the card by default: one counted pass at seed 3, whose
     image mean must be within 0.5% of 0.13256 (the JAX package's CPU value,
     pinned by tests/test_torch_render.py), then 5 passes through
     `render_progressive`, timed. The launch counts are reset just before
     those 5 passes, read just after, and must show closest-hit and
     shadow-ray launches of `intersect_dense`;
  5. kernel vs plain, `intersect_bvh`: against its plain version (the
     lockstep oracle) with the tolerances of 3, closest-hit and any-hit, on
     the glossy scene's camera rays of a 256x256, 16-spp pass (2^20) and
     their first-bounce rays, and on a random 65,536-triangle soup vs 2^20
     random rays (a deep tree). The oracle also counts node and leaf visits
     and the leaf rows that pass the t test, from which the kernel's bound
     is computed. The wrapper and the kernel alone (each launch with its own
     zeroed ray counter, made beforehand) are timed;
  6. kernel vs plain, `packed_gather`: the glossy shade pack at the first-hit
     prims of those 2^20 camera rays, plus indices out of range on purpose;
     the output must be bit-equal to `table[idx.clamp(0, Tr - 1)]`. The
     kernel, the plain version and `torch.index_select` are timed on the
     main path's indices;
  7. glossy path (bench config 2): `render_wavefront_counted` on the glossy
     scene at 128x128, 8 spp, depth 5, seed 3, whose mean must be within 1%
     of the JAX package's CPU value below; then 256x256 at 80 spp (16 spp x 5
     passes pooled), depth 5, warm at seed 0 and timed at seed 7. The launch
     counts are reset just before the timed render, read just after, and
     must show both kinds of `intersect_bvh` launches and `packed_gather`
     launches;
  8. kernel vs plain, `photon_density`: on the photon tiles and cell-sorted
     gather queries of one bench-config-5 PPM pass (both photon maps,
     captured in the warm seed-0 pass of 3), and on a synthetic hotspot
     where every query has thousands of photons within the radius. Every
     sum within 1e-4 relative (+1e-6 of the largest): the per-pair weights
     are bit-equal, the sums run in another order; invalid queries 0; two
     launches bit-equal. The pairs of each cull basis (block x tile, the
     kernel's warp x 32-photon chunk, within r, w > 0) and the surviving
     tiles per block are counted; the kernel alone (arguments and scratch
     made beforehand), the wrapper and the plain version are timed with CUDA
     events; the bound charges the operations of the pairs within r (what
     the inputs need) against the bytes, the other bases printed beside it;
  9. PPM path (bench config 5's PPM half, `render_ppm_pass` on the caustic
     scene, built on the card by default): a pinned pass (64x64, 4 spp,
     2^15 photons, seed 3, pass 1) whose mean must be within 0.1% of the
     JAX package's CPU value below, then 128x128, 4 spp, `PPMConfig()`
     (2^17 photons, depth 6), pass 1, warm at seed 0 and timed at seed 7.
     Rays are counted as bench.py counts them: the photon walk's rays
     (`trace_photons` with_stats, seed 3) plus W*H*spp camera rays. The
     launch counts are reset just before the timed pass, read just after,
     and must show `photon_density`, both kinds of `intersect_dense`
     launches and `packed_gather`;
  10. profile: `torch.profiler` over one Cornell pass, one bench-config-2
     glossy render and one bench-config-5 PPM pass: wall, device kernel
     time, busy share, kernel launches, the top kernels by device time, and
     the port's own kernels' launches and shares (phases 15 and 16 profile
     the bench-config-3 render and the BDPT pass the same way, once their
     scenes are built);
  11. kernel vs plain, `packed_gather`'s backward, at three shapes: the
     pack (a seeded uniform (2^20, 64) cotangent at phase 6's first-hit
     prims onto the glossy pack's rows), the texture lookup (2^20 x 3 onto
     Cornell's 5 texture rows, at the texture ids of the first colour lookup
     whose backward a bench-config-1 Cornell gradient pass sums, captured
     there) and the hit refinement's Woop rows (2^20 x 12 at the first-hit
     prims onto the glossy Woop rows). At each: against the float64 plain
     version within 1e-5 relative, zero on rows no lane hit, two launches
     bit-equal, bit-equal to the plain emulation of its summation order on
     4,096 lanes; the kernels alone, the whole call, the plain version and
     `index_add_` timed against the bytes bound;
  12. gradient gates: the card's gradients of TestGradients' albedo and
     radiance cases (Cornell 32x32, 8 spp, depth 4, rr_start 99, seed 0)
     against the JAX package's CPU values pinned below; central differences
     against AD for the camera origin and FOV on the point-lit wall at JAX's
     10%; `PTConfig.remat` on against off (the loss equal, gradients within
     1e-4 of the largest entry);
  13. the full-size gradient passes: Cornell at bench config 1 with respect
     to (color_a, radiance) and the glossy scene through `render` at 256x256,
     16 spp, depth 5 (the shade pack on) with respect to (alpha_u, alpha_v,
     color_a): forward-only and forward+backward wall, each the median (with
     min and max) of 11 alternating pairs, the median of the pairs' ratios,
     rays (as `render_counted` counts the forward), peak memory with remat off
     and on, the launch counts (reset just before one forward+backward, read
     just after: the glossy one must launch `intersect_bvh`, the gather and
     its backward), and the profiler's idle share; central differences
     against AD on the glossy albedo entry with the largest gradient, at 5%;
  14. inverse rendering: three `entry.inverse_step`s at bench config 1 from
     the example's grey start scene toward the Cornell box; the loss must
     fall at each step and, read at the first step's seed, after the three;
  15. bigscene, bench config 3: `build_big_scene()` on the card (~1M-triangle
     target: 628,232 triangles), its triangle and Woop-row counts, tree
     depth, whole build and host SBVH build times; a pinned render
     (`build_big_scene(100_000)`, 64x64, 4 spp, seed 3, depth 5) whose mean
     must be within 1% of the JAX package's CPU value below; then
     `render_wavefront_counted` at 512x512, 16 spp, depth 5, warm at seed 0
     and timed at seed 7 (rays as the engine counts them). The launch counts
     are reset just before the timed render, read just after, and must show
     both kinds of `intersect_bvh` launches. Then `intersect_bvh` against
     its oracle, with the tolerances of 3, on the pool's first wave of
     camera rays (2^20) and their first-bounce rays, closest and any hit,
     the kernel alone and the wrapper timed, the bound from the oracle's
     visit counts; the lanes whose oracle stack (48 entries) overflowed are
     counted; the render is profiled as in 10;
  16. BDPT, bench config 5's other half: a pinned pass (caustic scene,
     64x64, 4 spp, seed 3) whose mean must be within 0.1% of the JAX
     package's CPU value below and its rays within 0.1%; in a warm
     bench-config-5 pass (128x128, 4 spp, `BDPTConfig()`, seed 0) the
     arguments of `intersect_dense` (the first light-walk, eye, t=1 splat
     and connection launches: 65,536 lanes x 3,160 rows), `packed_gather`
     (the eye hits and the light vertices' re-fetch) and the splat sum are
     captured, and each is held against its plain version as in 3, 6 and 11
     (the splat sum within 1e-5 relative of the float64 plain version, two
     launches bit-equal) and timed; then the pass at seed 7, timed, with
     Mrays/s from its own ray count; the launch counts are reset just
     before it, read just after, and must show both kinds of
     `intersect_dense`, `packed_gather` and the splat sum; the pass is
     profiled as in 10;
  17. the light tracer and VCM: pinned renders (64x64, 16,384 paths / 4
     spp, seed 3, VCM pass 1) within 0.1% of the JAX package's CPU values
     below; the light tracer's splat sum (65,536 paths) held against its
     plain version as in 16; each timed once at bench config 5's size
     (128x128, 65,536 paths / 4 spp, seed 7), its launch counts reset just
     before and read just after; VCM's pass also with the merge's neighbour
     cap lifted to 512 (not gated);
  18. the heterogeneous volume, bench config 4: bench.py's smoke plume (a
     32^3 grid, 6 Gaussians from seed 0) built on the card in the Cornell
     box; a pinned `render_vol_counted` (64x64, 4 spp, depth 6, seed 3)
     whose mean must be within 7.5% (three times the mean's spread over
     seeds 3-5) of the JAX package's CPU value below and its rays within
     1%, with its delta-tracking trip counts by bounce printed beside
     JAX's (equal trips mean the card drew every lane's numbers as JAX
     did; not gated); then `render_vol_stepwise` at 256x256, 8 spp, depth
     6, 3 passes as bench.py runs it: warm at seed 0 (intersect_dense's
     arguments captured: the camera rays, the first bounce's rays and the
     first shadow rays, many from medium scatter points inside the plume,
     524,288 lanes each, held against the plain version as in 3 and
     timed), rays counted at seed 3 (with_stats), timed at seed 7 with
     Mrays/s, the launch counts reset just before it and read just after
     (both kinds of `intersect_dense`), the first pass's trip counts
     printed, one pass profiled as in 10;
  19. bench config 4's transmittance gradients: (a) the card's gradients of
     three pinned cases against the JAX package's CPU values in
     tools/volume_grad_reference.npz (TestVolumetric's sigma_a slab and 6^3
     voxel grid in the furnace, 16x16, 4 spp, depth 3; the plume in the
     Cornell box at 64x64, 4 spp, depth 6, seed 3, with respect to
     grid_data, sigma_a and sigma_s): each entry within 1e-3 relative plus
     1e-3 of the field's largest, the loss within 1e-4, with the tracking
     trips printed beside JAX's; where the trips differ the render is
     another sample of the estimator and the gate is JAX's own FD against
     AD (the sign, 50%; along the grid's gradient for the grids, as
     JAX's grid test); remat on against off on the plume (the loss equal,
     gradients within 1e-4 of the largest entry). (b) the gradient of
     mean(render_vol) at bench config 4 (256x256, 8 spp, depth 6, seed 7)
     with respect to grid_data, sigma_a and sigma_s: forward and
     forward+backward walls (medians of 5 alternating pairs, with min, max
     and their ratio), rays, peak memory with remat on and off, the launch
     counts over one forward+backward (reset just before, read just after:
     both kinds of intersect_dense and the three gather-backward kernels),
     intersect_dense's arguments in it held against the plain version as in
     3, the profiler's idle share and top kernels, and the directional FD
     along grid_data's gradient against its norm, printed beside JAX's 50%
     and not gated (with the noise held the forward moves with the grid
     only where a tracking decision flips: the weights' values cancel their
     detached pdfs, so the FD sees the flips, the AD the integrand). (c) the gather
     backward at the grid shape, on the (g, idx) of the first transmittance
     lookup that pass's backward sums (B x 32 steps x 8 corners onto the
     32,769 grid rows): two launches bit-equal, unhit rows 0, each row within
     1e-5 of its sum of |g| from the float64 plain version; then phase 11's
     checks at those indices, the times beside the plain version and
     index_add_, the scratch and its row-mask share; the same at a
     per-volume table's shape (sigma_a[vid], captured in a gradient of
     per-channel grids, 64x64, 4 spp);
  20. SPPM: pinned runs (render_sppm_pass at 64x64 on the Cornell box and
     the caustic scene, 4 passes of 2^15 photons, within 0.1% of the JAX
     package's CPU means; the plume with VOL_BEAMBEAM and VOL_POINT, 2
     passes of 2^13 photons, within three times the mean's spread over
     seeds 3-5, the first photon bounce's tracking trips beside JAX's),
     then at full size, warm at seed 0 (intersect_dense's and
     packed_gather's arguments captured and held against their plain
     versions as in 3 and 6) and timed at seed 7 with the launch counts
     reset just before and read just after: the caustic scene at 128x128,
     `SPPMConfig()` (2^17 photons, max_gather 128), 4 passes (both kinds of
     intersect_dense and packed_gather), and the plume at 256x256 with
     VOL_BEAMBEAM, 2 passes; pass time, photons and pixels a second, the
     profiler's idle share of one pass;
  21. closed-form surface shading: each case pinned at 64x64, 4 spp (the
     light tracer 16,384 paths), seed 3, within 0.5% of the JAX package's
     CPU mean (tools/shading_reference_mean.py), then at full size, warm at
     seed 0 and one pass timed at seed 7 with the launch counts reset just
     before and read just after, and the profiler's idle share: (a) the
     furnace sphere (2,208 triangles) at bench config 1's size (256x256, 16
     spp, depth 5) through render_counted for each BSDF this slice ports
     (ROUGHDIFFUSE, THINDIELECTRIC, PLASTIC, PHONG, WARD, HK, NULL_BSDF) and
     for COATING, ROUGHCOATING and BLEND over DIFFUSE, each mean below 1.1
     (no type gains energy), both kinds of intersect_dense and the
     shade-pack gather launched; intersect_dense's camera, first-bounce and
     shadow rays and the pack gather of the PLASTIC pass held to their plain
     versions as in 3 and 6; (b) the Cornell box through THINLENS,
     ORTHOGRAPHIC, SPHERICAL and TELECENTRIC cameras; (c) the Gaussian film
     (rec_radius 1.5) beside the box film, its taps (9 x 2^20 lanes x
     (rgb w, w) onto 65,537 rows, the last the dropped out-of-image row)
     summed in one splat call and held to the float64 plain version as the
     splat sums of 16-17, timed beside index_add_; the same film at
     1024x1024, 16 spp (seeded samples in the path tracer's order), which
     goes in runs of at most 1 GiB of the kernel's scratch, held to the
     float64 plain sum of every tap at once, and one Gaussian Cornell pass
     at 1024x1024; (d) the caustic scene
     with regularization 0.1; (e) the light tracer (65,536 paths), BDPT and
     VCM at 128x128, 4 spp on the Cornell box lit by a point and a spot
     light, and the light tracer on the constant-environment furnace.
Each phase's seconds are printed as it ends.

Before its last line it prints one JSON object describing each kernel; the
last line is {"ok": true, "device": {...}}. Without a CUDA device, or without
the port package beside it, it exits non-zero and prints no result.
"""
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REF_MEAN_SEED3 = 0.13256   # JAX CPU render_counted(cornell, 256, 256, 16, seed 3, depth 5)
# JAX package on the CPU, computed once with
#   JAX_PLATFORMS=cpu python -c "from cudatracerlib_tpu.scene.shapes import glossy_scene;
#   from cudatracerlib_tpu.render.path_tracer import PTConfig;
#   from cudatracerlib_tpu.render.wavefront import render_wavefront_counted as r;
#   print(r(glossy_scene(), 128, 128, 8, 3, PTConfig(max_depth=5)))"
# -> mean 0.166997, 507,368 rays
REF_GLOSSY_MEAN = 0.166997
GLOSSY_PIN = dict(width=128, height=128, spp=8, seed=3)
GLOSSY_TOL = 0.01
# JAX package on the CPU with the neighbour cap lifted above every query's
# candidate count (max_gather 891), so the estimate is exhaustive like the
# port's kernel; computed once with
#   JAX_PLATFORMS=cpu python tools/ppm_reference_mean.py
# -> mean 0.326837 (render_ppm_pass(caustic_scene(), 64, 64, 4, seed 3,
#    pass 1, PPMConfig(n_photons=2**15)))
REF_PPM_MEAN = 0.326837
PPM_PIN = dict(width=64, height=64, spp=4, seed=3, pass_idx=1, n_photons=1 << 15)
# JAX package on the CPU, computed with `JAX_PLATFORMS=cpu python tools/grad_reference.py`:
# d mean(render(cornell_box(), 32, 32, 8, seed 0, PTConfig(max_depth=4, rr_start=99))) with
# respect to textures.color_a and lights.radiance (TestGradients' albedo and radiance cases).
# The CPU port matches them to ~1e-6 relative (tests/test_torch_grad.py); on the card the
# transcendental functions and the sums round otherwise, and one lane that grazes an edge the
# other way moves a gradient by ~1/8192 of it: each entry within 1e-3 relative plus 1e-3 of the
# largest, the loss within 1e-4.
REF_GRAD_LOSS = 0.138246357
REF_GRAD_COLOR_A = [[0.0614892542, 0.0388920829, 0.0104801087],
                    [0.0187696256, 0.0127294026, 0.00362673984],
                    [0.0213251263, 0.0134160239, 0.00393973663], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]]
REF_GRAD_RADIANCE = [[0.00439097453, 0.00409484375, 0.00361541752]]
GRAD_PIN = dict(width=32, height=32, spp=8, seed=0, max_depth=4, rr_start=99)
REF_GRAD_RTOL, REF_LOSS_RTOL = 1e-3, 1e-4
FD_TOL_CAMERA, FD_TOL_GLOSSY, REMAT_TOL = 0.10, 0.05, 1e-4
BWD_RTOL = 1e-5
GRAD_PAIRS = 11            # phase 13: alternating forward / forward+backward walls
PPM_TOL = 1e-3            # the CPU port's photon-major render agrees to 1e-6
# Bench config 3's pinned render, JAX package on the CPU (`JAX_PLATFORMS=cpu python
# tools/bigscene_reference_mean.py`): render_wavefront_counted(build_big_scene(100_000), 64, 64,
# 4, seed 3, PTConfig(max_depth=5)) -> mean 0.144138113, 37,674 rays (the CPU port: the same
# mean to 9 digits and the same rays, `--port`). Gate 1%, as glossy's.
REF_BIG_MEAN, REF_BIG_RAYS = 0.144138113, 37674
BIG_PIN = dict(n_tris=100_000, width=64, height=64, spp=4, seed=3)
BIG_TOL = 0.01
BIG_W = BIG_H = 512        # bench config 3 (bench.py:216-241): 512^2, 16 spp, depth 5
BIG_SPP = 16
BIG_CMP_LANES = 1 << 20    # the wavefront pool's width: one launch of the main path
# The bidirectional engines' pinned renders on the caustic scene, JAX package on the CPU
# (`JAX_PLATFORMS=cpu python tools/bdpt_reference_mean.py`) at 64x64, 4 spp, seed 3, one light
# path a sample (VCM: pass 1): BDPT mean 0.353301913 and 397,101 rays, the light tracer
# 0.311668307 (16,384 paths), VCM 0.334288925. The CPU port (`--port`) gives BDPT and the light
# tracer to 9 digits and BDPT's rays exactly, VCM within 1.3e-6; 0.1% leaves the card's
# rounding room, as the PPM gate does.
REF_BDPT_MEAN, REF_BDPT_RAYS = 0.353301913, 397101
REF_LT_MEAN, REF_VCM_MEAN = 0.311668307, 0.334288925
BIDIR_PIN = dict(width=64, height=64, spp=4, seed=3, pass_idx=1)
BIDIR_TOL = 1e-3
VCM_OPEN_CAP = 512         # phase 17's VCM pass with the merge's neighbour cap lifted
# Bench config 4's pinned render, JAX package on the CPU (`JAX_PLATFORMS=cpu python
# tools/volume_reference_mean.py`): render_vol_counted(cornell_box(), bench.py's plume, 64, 64, 4,
# seed 3, PTConfig(max_depth=6)) -> mean 0.137044162, 100,872 rays, delta-tracking trips by
# bounce [9, 8, 9, 8, 9, 10]. Seeds 3-5 spread 2.5005% of that mean (0.135914892-0.139341697), and
# the gate is three times the spread. The CPU port gives the same mean, rays and trips (`--port`).
# On the card the transcendentals round otherwise, and a tracking decision of the slowest lane
# that one ulp flips changes T and with it every later draw of every lane: the card's render is
# then another sample of the same estimator, which the spread bounds.
REF_VOL_MEAN = 0.137044162
REF_VOL_RAYS = 100_872
REF_VOL_TRIPS = [9, 8, 9, 8, 9, 10]
VOL_PIN = dict(width=64, height=64, spp=4, seed=3)
VOL_TOL = 0.075
VOL_RAYS_TOL = 0.01
VOL_W = VOL_H = 256        # bench config 4 (bench.py:244-286): 256^2, 8 spp, depth 6, 3 passes
VOL_SPP, VOL_DEPTH, VOL_PASSES = 8, 6, 3
# Bench config 4's transmittance gradients, the JAX package on the CPU: `JAX_PLATFORMS=cpu python
# tools/volume_grad_reference.py` writes them to VGRAD_REF, which phase 19 reads: d mean(render_vol)
# of TestVolumetric's sigma_a slab and 6^3 voxel grid (furnace, 16x16, 4 spp, seed 0, depth 3, no
# roulette) and of the plume in the Cornell box (64x64, 4 spp, seed 3, depth 6) with respect to
# grid_data, sigma_a and sigma_s, each with its tracking trips by bounce. The CPU port equals them
# within 1.1e-5 of each field's largest entry, with the same trips (`--port`). Where the card's
# trips equal JAX's the gate is phase 12's; where they differ the render is another sample of the
# estimator and the gate is JAX's own FD-vs-AD one (tests/test_engines.py:148-152, :213-220).
VGRAD_REF = os.path.join("tools", "volume_grad_reference.npz")
VGRAD_PATHS = ["grid_data", "sigma_a", "sigma_s"]
VGRAD_FD_TOL = 0.5
VGRAD_PAIRS = 5            # phase 19: alternating forward / forward+backward walls
VGRAD_SEED = 7
# SPPM's pinned runs, the JAX package on the CPU (`JAX_PLATFORMS=cpu python
# tools/sppm_reference_mean.py`): the image mean after `passes` passes of render_sppm_pass at
# 64x64 with seeds 0, 1, ... on one state. The CPU port (`--port`) gives the surface means within
# 2.8e-6, VOL_POINT's equal and VOL_BEAMBEAM's 4.7e-4 apart (21 of its 420,016 beam sample points
# lie in another grid cell after ulps of the photon walk, which moves the subsampled queries
# there), with the same first-bounce trips. Surface runs within 0.1%; the volume runs within three
# times their mean's spread over runs started at seeds 3-5 (a tracking decision an ulp flips on
# the card re-draws every lane, as in phase 18).
# name: (scene, vol estimator, photons, passes, JAX's mean, tolerance, JAX's first-bounce trips)
SPPM_PINS = {
    "cornell": ("cornell", 0, 1 << 15, 4, 0.127222791, 1e-3, None),
    "caustic": ("caustic", 0, 1 << 15, 4, 0.310399890, 1e-3, None),
    "beambeam": ("cornell", 3, 1 << 13, 2, 0.121620677, 3 * 0.047088, 10),
    "point": ("cornell", 1, 1 << 13, 2, 0.122724421, 3 * 0.048505, 10),
}
SPPM_PIN_SIZE = 64
SPPM_CAUSTIC_PASSES, SPPM_VOL_PASSES = 4, 2   # phase 20 at full size (bench config 5's scene)
# Phase 21's pins, the JAX package on the CPU (`JAX_PLATFORMS=cpu python
# tools/shading_reference_mean.py`): each case at 64x64, 4 spp (the light tracer 16,384 paths),
# seed 3, depth 5 -- the furnace through render_counted with each BSDF this slice ports (and the
# nested ones over DIFFUSE), the Cornell box through the other cameras, with the Gaussian film,
# the caustic scene regularized, the light tracer, BDPT and VCM on the point- and spot-lit
# Cornell box and the light tracer on the furnace. The CPU port gives the same means (`--port`);
# 0.5% leaves the card's rounding room.
SHADING_PINS = {
    "furnace_roughdiffuse": 0.871637046, "furnace_thindielectric": 0.996276855,
    "furnace_plastic": 0.905668020, "furnace_phong": 0.964307606, "furnace_ward": 0.951584518,
    "furnace_hk": 0.496545523, "furnace_null": 0.475524902, "furnace_coating": 0.870351791,
    "furnace_roughcoating": 0.872076213, "furnace_blend": 0.895575047,
    "cornell_thinlens": 0.133199692, "cornell_orthographic": 0.080959074,
    "cornell_spherical": 1.066703439, "cornell_telecentric": 0.081005581,
    "gaussian": 0.132881090, "caustic_reg": 0.316012979,
    "lt_ps": 0.248347595, "bdpt_ps": 0.423273593, "vcm_ps": 0.392754227,
    "lt_furnace": 0.385445118,
}
SHADING_TOL = 0.005
SHADING_PAIRS = 7          # phase 21: alternating box / Gaussian film passes
SHADING_PIN_SIZE, SHADING_PIN_SPP, SHADING_PIN_SEED = 64, 4, 3
PPM_W = PPM_H = 128        # bench config 5 (bench.py:289-340)
PPM_SPP, PPM_PASS = 4, 1
DENSITY_RTOL, DENSITY_ATOL = 1e-4, 1e-6
W = H = 256
SPP, DEPTH, N_PASS = 16, 5, 5
SOUP_RAYS = 1 << 20
SOUP_TRIS = 65536          # the deep-tree soup of phase 5
VALID_AGREE = 0.99999
ERR_TOL = 1e-4
# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# operations per unit of work, counted from the kernels' sources (a min,
# max or compare counts as one, as a multiply or an add does)
FLOPS_DENSE_PAIR = 30      # one ray / Woop-row test, t and u, v
FLOPS_BOX_TEST = 25        # one ray / chunk-box slab test (6 sub, 6 mul, 10 min/max, 3 compare)
FLOPS_BVH_INNER = 50       # two slab tests
FLOPS_WOOP_T = 17          # per leaf row: t and its test
FLOPS_WOOP_UV = 31         # per leaf row that passed the t test: u, v and their tests
FLOPS_PHOTON_PAIR = 32     # per (valid query, photon) pair weighed (an FMA counts two)
LEAF_SIZE = 4
PORT_KERNELS = ("dense_kernel", "bvh_kernel", "gather_kernel", "gather_bwd_tile_kernel",
                "gather_bwd_range_kernel", "gather_bwd_final_kernel", "photon_kernel",
                "photon_reduce_kernel")  # __global__ names in csrc/


def _require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _time_ms(fn, reps):
    import torch

    fn()  # warm
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(flops, nbytes):
    """(bound_ms, bound_by): the larger of the two times at the card's peaks."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _check_hits(label, mode, r, t_scale):
    print(f"[kernel vs plain] {label} {mode}: {json.dumps(r)}")
    _require(r["valid_mismatch"] <= (1.0 - VALID_AGREE) * r["rays"],
             f"{label} {mode}: valid disagrees on {r['valid_mismatch']} of {r['rays']} rays")
    _require(r["valid_mismatch_not_grazing"] == 0,
             f"{label} {mode}: {r['valid_mismatch_not_grazing']} non-grazing valid mismatches")
    _require(r["hits"] > 0, f"{label} {mode}: no ray hit anything")
    if mode == "closest":
        _require(r["prim_mismatch_not_grazing"] == 0,
                 f"{label}: {r['prim_mismatch_not_grazing']} non-grazing prim mismatches")
        _require(r["max_abs_err_t"] <= ERR_TOL * t_scale and r["max_abs_err_bary"] <= ERR_TOL,
                 f"{label}: t/bary error {r['max_abs_err_t']}/{r['max_abs_err_bary']}")
        return max(r["max_abs_err_t"], r["max_abs_err_bary"])
    return 0.0


def _time_kernel_ms(prepared, launch):
    """Kernel-only time: launches of prebuilt arguments (ranges, outputs and,
    for the BVH kernel, a zeroed ray counter each), under CUDA events."""
    import torch

    launch(prepared[0])  # warm
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for p in prepared[1:]:
        launch(p)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (len(prepared) - 1)


def _dense_work(woop, boxes, o, d, t_min, t_max):
    """Operations the dense query needs on these inputs: every ray's box
    tests plus FLOPS_DENSE_PAIR for each row of the chunks its box test
    passes at its final t (the plain cull emulation's count); also the
    all-rows figure of the old sweep and how far the emulation's hits
    differ from the plain version's (0 expected)."""
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops

    import torch
    from cudatracerlib_tpu_torch.accel.traversal import _slab_test

    hit, n_chunks, n_rows = ops.cull_sweep(woop, boxes, o, d, t_min, t_max)
    plain = ops.intersect_dense_plain(woop, o, d, t_min, t_max)
    off = int((hit.prim != plain.prim).sum()) + int((hit.t != plain.t).sum())
    B, C, T = o.shape[0], boxes.shape[0], woop.shape[0]
    rows = int(n_rows.sum())
    flops = FLOPS_BOX_TEST * B * C + FLOPS_DENSE_PAIR * rows
    # what a warp sweeps: the union of its 32 lanes' chunks (at the final t,
    # so a floor of what the running t enters)
    t_lo = torch.as_tensor(t_min, dtype=torch.float32, device=o.device).expand(B)
    inv_d = 1.0 / torch.where(d.abs() < 1e-20, torch.where(d < 0, -1e-20, 1e-20), d)
    union = 0
    for s in range(0, B - B % 32, 1 << 15):
        sl = slice(s, min(s + (1 << 15), B - B % 32))
        enter, _ = _slab_test(boxes[None, :, 0:3], boxes[None, :, 4:7], o[sl, None],
                              inv_d[sl, None], t_lo[sl, None], hit.t[sl, None])
        union += int(enter.reshape(-1, 32, C).any(1).sum())
    return dict(flops=flops, all_rows_flops=FLOPS_DENSE_PAIR * B * T, rows=rows,
                mean_chunks=float(n_chunks.double().mean()), emulation_off=off,
                warp_chunks=union / max(1, B // 32),
                nbytes=B * (24 + 8 + 16) + (woop.numel() + boxes.numel()) * 4)


def _compare(label, woop, o, d, t_min, t_max, reps, boxes=None):
    """intersect_dense vs its plain version on the same CUDA tensors, closest
    and any-hit; times the wrapper, the kernel alone and the plain version,
    and counts the work for the bound. Returns a dict."""
    import torch
    from cudatracerlib_tpu_torch.accel.bvh import chunk_boxes_from_woop
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops

    if boxes is None:
        boxes = chunk_boxes_from_woop(woop)
    plain = ops.intersect_dense_plain(woop, o, d, t_min, t_max)
    t_scale = float(torch.clamp(plain.t[plain.valid].abs().max(), min=1.0))
    worst = 0.0
    for any_hit in (False, True):
        kern = ops.intersect_dense(woop, o, d, t_min, t_max, any_hit=any_hit, boxes=boxes)
        torch.cuda.synchronize()
        r = ops.compare_hits(kern, plain, woop, t_min, t_max, any_hit=any_hit)
        worst = max(worst, _check_hits(label, "any_hit" if any_hit else "closest", r, t_scale))
    wrap_ms = _time_ms(lambda: ops.intersect_dense(woop, o, d, t_min, t_max, boxes=boxes), reps)
    prepared, _ = ops.launch_args(woop, o, d, t_min, t_max, boxes=boxes)
    ms = _time_kernel_ms([prepared] * (reps + 1), ops.launch)
    plain_ms = _time_ms(lambda: ops.intersect_dense_plain(woop, o, d, t_min, t_max),
                        max(1, reps // 10))
    work = _dense_work(woop, boxes, o, d, t_min, t_max)
    bound = _bound(work["flops"], work["nbytes"])
    old_bound = _bound(work["all_rows_flops"], work["nbytes"])
    print(f"[time] {label}: {o.shape[0]} rays x {woop.shape[0]} rows ({boxes.shape[0]} chunks): "
          f"kernel {ms:.4f} ms, wrapper {wrap_ms:.4f} ms, plain {plain_ms:.4f} ms")
    print(f"[work] {label}: mean chunks entered {work['mean_chunks']:.3f} of {boxes.shape[0]} "
          f"(a warp's union {work['warp_chunks']:.2f}), "
          f"rows {work['rows']} ({work['rows'] / o.shape[0]:.2f} a ray), {work['flops']} "
          f"operations, bound {bound[0]:.5f} ms ({bound[1]}); all-rows sweep (the old bound) "
          f"{work['all_rows_flops']} operations, {old_bound[0]:.5f} ms; cull emulation vs "
          f"plain: {work['emulation_off']} differing t / prim")
    return dict(err=worst, ms=ms, wrap_ms=wrap_ms, plain_ms=plain_ms, bound=bound,
                old_bound=old_bound)


def _compare_bvh(label, bvh, o, d, t_min, t_max, reps):
    """intersect_bvh vs the oracle on the same CUDA tensors, closest and
    any-hit; returns (worst error, kernel ms, plain ms, flops, bytes) of
    the closest-hit query, the work counted by the oracle, and the lanes
    whose oracle stack overflowed (either kind)."""
    import torch
    from cudatracerlib_tpu_torch.ops import intersect_bvh as bvh_ops
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops

    worst, overflow = 0.0, 0
    for any_hit in (False, True):
        plain, n_inner, n_leaf, n_tpass, n_over = bvh_ops.intersect_bvh_plain(
            bvh, o, d, t_min, t_max, any_hit=any_hit, with_counts=True, with_overflow=True)
        overflow += int((n_over > 0).sum())
        if not any_hit:
            t_scale = float(torch.clamp(plain.t[plain.valid].abs().max(), min=1.0))
            flops = (FLOPS_BVH_INNER * int(n_inner.sum())
                     + FLOPS_WOOP_T * LEAF_SIZE * int(n_leaf.sum())
                     + FLOPS_WOOP_UV * int(n_tpass.sum()))
            print(f"[work] {label}: {o.shape[0]} rays, inner visits {int(n_inner.sum())} "
                  f"(mean {float(n_inner.double().mean()):.2f}), leaf visits "
                  f"{int(n_leaf.sum())} (mean {float(n_leaf.double().mean()):.2f}), rows "
                  f"past the t test {int(n_tpass.sum())} "
                  f"(mean {float(n_tpass.double().mean()):.2f}), {flops} operations")
        kern = bvh_ops.intersect_bvh(bvh, o, d, t_min, t_max, any_hit=any_hit)
        torch.cuda.synchronize()
        r = ops.compare_hits(kern, plain, bvh.woop, t_min, t_max, any_hit=any_hit)
        if not any_hit and r["prim_mismatch"]:
            lanes = ((kern.prim != plain.prim) & kern.valid & plain.valid).nonzero()[:4, 0]
            for i in lanes.tolist():
                print(f"[kernel vs plain] {label} lane {i}: kernel t {float(kern.t[i])!r} prim "
                      f"{int(kern.prim[i])} bary {kern.bary[i].tolist()}, oracle t "
                      f"{float(plain.t[i])!r} prim {int(plain.prim[i])} bary "
                      f"{plain.bary[i].tolist()}")
        worst = max(worst, _check_hits(label, "any_hit" if any_hit else "closest", r, t_scale))
    wrap_ms = _time_ms(lambda: bvh_ops.intersect_bvh(bvh, o, d, t_min, t_max), reps)
    ms = _bvh_kernel_ms(bvh, o, d, t_min, t_max, reps)
    plain_ms = _time_ms(lambda: bvh_ops.intersect_bvh_plain(bvh, o, d, t_min, t_max), 1)
    nbytes = o.shape[0] * (24 + 8 + 16) + 4 * (bvh.nodes.numel() + bvh.woop.numel())
    print(f"[time] {label}: {o.shape[0]} rays x {bvh.woop.shape[0]} rows: kernel {ms:.4f} ms, "
          f"wrapper {wrap_ms:.4f} ms, plain {plain_ms:.4f} ms; oracle stack overflowed on "
          f"{overflow} lanes")
    return dict(err=worst, ms=ms, wrap_ms=wrap_ms, plain_ms=plain_ms, flops=flops, nbytes=nbytes,
                bound=_bound(flops, nbytes), overflow=overflow)


def _bvh_kernel_ms(bvh, o, d, t_min, t_max, reps, any_hit=False):
    """intersect_bvh's kernel alone: each launch gets its own zeroed ray
    counter, all made beforehand."""
    import torch
    from cudatracerlib_tpu_torch.ops import intersect_bvh as bvh_ops

    counters = torch.zeros(reps + 1, dtype=torch.int32, device=o.device)
    prepared = [bvh_ops.launch_args(bvh, o, d, t_min, t_max, any_hit, next_ray=counters[k:k + 1])[0]
                for k in range(reps + 1)]
    return _time_kernel_ms(prepared, bvh_ops.launch)


def _capture_ppm(caustic, pcfg):
    """One warm bench-config-5 PPM pass (seed 0) with intersect_dense's and
    photon_density's arguments captured: ({label: (woop, o, d, t_min,
    t_max, any_hit, boxes)} of the first photon-walk launch, the first eye
    launch and the shadow-ray launch, [photon_density's argument tuples])."""
    import torch
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops
    from cudatracerlib_tpu_torch.ops import photon_gather as pg_ops
    from cudatracerlib_tpu_torch.render import ppm

    dense_calls, density_calls = [], []
    real_dense, real_density = ops.intersect_dense, pg_ops.photon_density

    def capture_dense(woop, o, d, t_min=1e-4, t_max=ops.T_MAX_CLAMP, any_hit=False, boxes=None):
        keep = lambda x: x.clone() if isinstance(x, torch.Tensor) else x  # noqa: E731
        dense_calls.append((woop, keep(o), keep(d), keep(t_min), keep(t_max), any_hit, boxes))
        return real_dense(woop, o, d, t_min, t_max, any_hit=any_hit, boxes=boxes)

    def capture_density(*args):
        density_calls.append(args)
        return real_density(*args)

    ops.intersect_dense, pg_ops.photon_density = capture_dense, capture_density
    try:
        ppm.render_ppm_pass(caustic, PPM_W, PPM_H, PPM_SPP, 0, PPM_PASS, pcfg)
        torch.cuda.synchronize()
    finally:
        ops.intersect_dense, pg_ops.photon_density = real_dense, real_density
    _require(len(density_calls) == 2,
             f"a PPM pass called photon_density {len(density_calls)} times, not 2")
    n_eye = PPM_W * PPM_H * PPM_SPP
    return {
        "ppm photon rays": next(c for c in dense_calls if c[1].shape[0] == pcfg.n_photons),
        "ppm eye rays": next(c for c in dense_calls if c[1].shape[0] == n_eye and not c[5]),
        "ppm shadow rays": next(c for c in dense_calls if c[5]),
    }, density_calls


def _soup(seed, n_tri, spread, dev):
    """A random triangle soup (numpy, (n_tri, 3, 3)) and SOUP_RAYS random
    rays through it on `dev`."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1.0, 1.0, (n_tri, 1, 3))
    tris = (centers + rng.normal(scale=spread, size=(n_tri, 3, 3))).astype(np.float32)
    o = torch.from_numpy(rng.uniform(-1.5, 1.5, (SOUP_RAYS, 3)).astype(np.float32)).to(dev)
    d = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(SOUP_RAYS, 3)).astype(np.float32)).to(dev), dim=-1)
    return tris, o, d


def _first_bounce(scene, cfg, o, d, sampler, pack=None):
    """The continuing rays of one `surface_bounce` from all-active lanes."""
    import torch
    from cudatracerlib_tpu_torch.render import path_tracer as pt

    n, dev = o.shape[0], o.device
    b = pt.surface_bounce(scene, cfg, o=o, d=d, active=torch.ones(n, dtype=torch.bool, device=dev),
                          throughput=torch.ones(n, 3, device=dev),
                          prev_pdf=torch.zeros(n, device=dev),
                          prev_delta=torch.ones(n, dtype=torch.bool, device=dev),
                          eta_scale=torch.ones(n, device=dev), sampler=sampler, depth=0,
                          pack=pack)
    return b.o[b.cont].contiguous(), b.d[b.cont].contiguous()


def _hotspot(dev):
    """photon_density's arguments on a synthetic hotspot: 2^15 photons and
    2^14 cell-sorted queries within a few cm, every query with thousands of
    photons within the radius."""
    import numpy as np
    import torch
    from cudatracerlib_tpu_torch.ops import photon_gather as pg_ops

    rng = np.random.default_rng(2)
    n_hot = 1 << 15
    hpos = np.zeros((n_hot, 3), np.float32)
    hpos[:, :2] = rng.normal(scale=0.03, size=(n_hot, 2))
    hn = np.tile(np.float32([[0, 0, 1]]), (n_hot, 1))
    hwi = rng.normal(size=(n_hot, 3)).astype(np.float32) + hn
    hwi /= np.linalg.norm(hwi, axis=-1, keepdims=True)
    hq = np.zeros((1 << 14, 3), np.float32)
    hq[:, :2] = rng.normal(scale=0.03, size=(1 << 14, 2))
    hqv = rng.random(1 << 14) >= 0.05
    hq = hq[np.argsort(np.where(hqv, np.floor(hq[:, 0] / 0.05) * 1e3 + np.floor(hq[:, 1] / 0.05),
                                1e9), kind="stable")]
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    htiles, haabbs = pg_ops.build_photon_tiles(t(hpos), t(rng.uniform(0, 1, (n_hot, 3))
                                                         .astype(np.float32)),
                                               t(hn), t(rng.random(n_hot) >= 0.1), [-1, -1, -1],
                                               [1, 1, 1], 40, wi=t(hwi))
    return (htiles, haabbs, t(hq), t(np.tile(hn[:1], (1 << 14, 1))), t(hqv), np.float32(0.05))


def _check_density(label, args):
    """photon_density vs its plain version on the same CUDA tensors, and two
    launches bit-equal; returns the largest absolute difference."""
    import torch
    from cudatracerlib_tpu_torch.ops import photon_gather as pg_ops

    kf, kw = pg_ops.photon_density(*args)
    kf2, kw2 = pg_ops.photon_density(*args)
    pf, pw = pg_ops.photon_density_plain(*args)
    torch.cuda.synchronize()
    _require(torch.equal(kf, kf2) and torch.equal(kw, kw2),
             f"photon_density {label}: two launches differ")
    err, rel = 0.0, 0.0
    for what, k, p in (("flux", kf, pf), ("sum_w", kw, pw)):
        diff = (k - p).abs()
        bad = diff > DENSITY_RTOL * p.abs() + DENSITY_ATOL * float(p.abs().max())
        _require(not bool(bad.any()), f"photon_density {label} {what}: {int(bad.sum())} sums "
                                      f"outside tolerance, worst {float(diff.max())}")
        err = max(err, float(diff.max()))
        big = p.abs() > 1e-3 * float(p.abs().max())
        rel = max(rel, float((diff[big] / p.abs()[big]).max()) if bool(big.any()) else 0.0)
    q_valid = args[4]
    _require(bool((kw[~q_valid] == 0).all()) and bool((kf[~q_valid] == 0).all()),
             f"photon_density {label}: an invalid query got a nonzero sum")
    print(f"[kernel vs plain] photon_density {label}: {args[2].shape[0]} queries "
          f"({int(q_valid.sum())} valid) x {args[0].shape[0]} tiles, radius "
          f"{float(args[5]):.6f}, max abs err {err:.3g}, max rel err {rel:.3g}, two launches "
          f"bit-equal")
    return err


def _density_work(label, args):
    """The pairs each cull basis keeps and the bound: the larger of the
    operations of the pairs within r (the work these inputs need) and the
    bytes, the 12 used rows of every non-empty tile, the tile boxes, the
    queries and the output, each once. The bounds on the kernel's own warp x
    32-photon chunk basis and on PR 3's block x tile basis are returned
    beside it."""
    from cudatracerlib_tpu_torch.ops import photon_gather as pg_ops

    tiles, aabbs, q = args[0], args[1], args[2]
    c = pg_ops.cull_counts(*args)
    per_block = c.pop("tiles_per_block").double()
    non_empty = int((aabbs[:, 0] <= aabbs[:, 3]).sum())
    nbytes = (non_empty * 12 * pg_ops.PT + aabbs.numel()) * 4 + q.shape[0] * (12 + 12 + 1 + 16)
    bound = _bound(FLOPS_PHOTON_PAIR * c["within_r"], nbytes)
    chunk_bound = _bound(FLOPS_PHOTON_PAIR * c["warp_chunk"], nbytes)
    old_bound = _bound(FLOPS_PHOTON_PAIR * c["block_tile"], nbytes)
    print(f"[work] photon_density {label}: {tiles.shape[0]} tiles ({non_empty} non-empty), "
          f"surviving tiles per block of {pg_ops.BQ}: median {float(per_block.median()):.0f}, "
          f"mean {float(per_block.mean()):.2f}, max {int(per_block.max())}; pairs: block x tile "
          f"{c['block_tile']}, warp x chunk {c['warp_chunk']}, within r {c['within_r']}, "
          f"w > 0 {c['positive']}; bound {bound[0]:.5f} ms ({bound[1]}: "
          f"{FLOPS_PHOTON_PAIR * c['within_r']} operations on the pairs within r, "
          f"{_bound(FLOPS_PHOTON_PAIR * c['within_r'], 0)[0]:.5f} ms; {nbytes} bytes, "
          f"{_bound(0, nbytes)[0]:.5f} ms); on the warp x chunk basis {chunk_bound[0]:.5f} ms "
          f"({chunk_bound[1]}), on the block x tile basis {old_bound[0]:.5f} ms "
          f"({old_bound[1]})")
    return dict(c, bound=bound, chunk_bound=chunk_bound, old_bound=old_bound)


def _profile(label, fn, top_n=8):
    """Device kernel time, busy share and launches of one call of `fn`,
    with its `top_n` kernels by time; returns the idle share and the port
    kernels' launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:  # union of kernel intervals, in microseconds
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top_n]
    print(f"[profile] {label}: wall {wall * 1e3:.3f} ms (profiled), device kernel time "
          f"{busy / 1e3:.3f} ms, busy {busy / 1e6 / wall:.3f}, idle {1 - busy / 1e6 / wall:.3f}, "
          f"{len(kernels)} kernel launches")
    for name, us in top:
        print(f"[profile] {label}:   {us / 1e3:9.3f} ms {100 * us / busy:5.1f}%  {name[:90]}")
    port = {}
    for kernel in PORT_KERNELS:  # the port's own kernels, wherever they rank
        mine = [e for e in kernels
                if e.name.startswith((f"(anonymous namespace)::{kernel}(",
                                      f"void (anonymous namespace)::{kernel}<",
                                      f"(anonymous namespace)::{kernel}<"))]
        us = sum(e.time_range.end - e.time_range.start for e in mine)
        n = port[kernel] = len(mine)
        if n == 0:
            continue
        print(f"[profile] {label}: port kernel {kernel}: {n} launches, {us / 1e3:.3f} ms, "
              f"{100 * us / max(busy, 1e-9):.2f}% of device time, "
              f"{100 * us / 1e6 / wall:.2f}% of wall")
    return dict(idle=1 - busy / 1e6 / wall, wall_ms=wall * 1e3, device_ms=busy / 1e3,
                launches=len(kernels), port=port)


def _paired_walls_ms(fn_a, fn_b, pairs):
    """Host walls in ms of `fn_a` and `fn_b`, run in `pairs` alternating
    pairs after a warm call of each, every run ending in a synchronize (a
    render's launches are host-bound): two lists, pair by pair."""
    import torch

    walls = ([], [])
    for fn in (fn_a, fn_b):
        fn()
    for _ in range(pairs):
        for fn, out in zip((fn_a, fn_b), walls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
    return walls


def _median(xs):
    xs = sorted(xs)
    return 0.5 * (xs[(len(xs) - 1) // 2] + xs[len(xs) // 2])


def _capture_texture_ids(scene, cfg):
    """The (lanes,) texture ids of the first texture-colour lookup whose
    cotangent the backward sums in one Cornell forward+backward at bench
    config 1 (w.r.t. color_a and radiance): the texture shape of phase 11."""
    from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops

    n_tex, seen = scene.textures.color_a.shape[0], []
    real = sg_ops.packed_gather_bwd

    def record(g, idx, n_rows):
        if n_rows == n_tex and g.shape[1] == 3 and not seen:
            seen.append(idx.clone())
        return real(g, idx, n_rows)

    sg_ops.packed_gather_bwd = record
    try:
        _loss_and_grads(scene, ["textures.color_a", "lights.radiance"], W, H, SPP, 3, cfg)
    finally:
        sg_ops.packed_gather_bwd = real
    _require(bool(seen), "the Cornell gradient pass made no texture-colour backward call")
    return seen[0]


def _check_gather_bwd(label, idx, n_rows, cols, dev):
    """Phase 11 at one shape: packed_gather's backward kernels against the
    float64 plain version on a seeded uniform cotangent (so a row no lane hit
    sums to 0 and every hit row is positive), twice bit-equal, bit-equal to
    the plain emulation of their order on 4,096 lanes; the kernels alone,
    the whole call, the plain version and index_add_ timed against the
    bytes the inputs need (g and idx read once, the table written once)."""
    import torch
    from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops

    n = idx.shape[0]
    g = torch.rand(n, cols, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    k1 = sg_ops.packed_gather_bwd(g, idx, n_rows)
    k2 = sg_ops.packed_gather_bwd(g, idx, n_rows)
    plain = sg_ops.packed_gather_bwd_plain(g, idx, n_rows)
    torch.cuda.synchronize()
    _require(torch.equal(k1, k2), f"packed_gather_bwd {label}: two launches differ")
    hit = plain > 0
    _require(bool((k1[~hit] == 0).all()), f"packed_gather_bwd {label}: an unhit row is not 0")
    rel = float(((k1 - plain).abs()[hit] / plain[hit]).max())
    err = float((k1 - plain).abs().max())
    _require(rel <= BWD_RTOL, f"packed_gather_bwd {label}: max relative error {rel} > {BWD_RTOL}")
    gs, ids = g[:4096].contiguous(), idx[:4096]
    emu = sg_ops.packed_gather_bwd_emulated(gs.cpu(), ids.cpu(), n_rows)
    _require(torch.equal(sg_ops.packed_gather_bwd(gs, ids, n_rows).cpu(), emu),
             f"packed_gather_bwd {label}: not bit-equal to the emulation of its order")
    counts = torch.bincount(torch.clamp(idx, 0, n_rows - 1).long(), minlength=n_rows)
    T = sg_ops.BWD_TILE
    tile_of = torch.arange(n, device=dev) // T
    rows_in_tiles = int(torch.unique(tile_of * n_rows
                                     + torch.clamp(idx, 0, n_rows - 1).long()).numel())
    del tile_of
    print(f"[kernel vs plain] packed_gather_bwd {label}: {n} lanes x {cols} onto {n_rows} rows "
          f"({int((counts > 0).sum())} hit, the most hit {int(counts.max())} lanes), tiles of "
          f"{T} lanes hold {rows_in_tiles} (tile, row) partials ({rows_in_tiles * cols * 4} bytes), "
          f"max rel err {rel:.3g}, max abs err {err:.3g}, two launches bit-equal, bit-equal to "
          f"the emulation on 4,096 lanes")
    prepared, _ = sg_ops.bwd_launch_args(g, idx, n_rows)
    ms = _time_kernel_ms([prepared] * 21, sg_ops.bwd_launch)
    wrap_ms = _time_ms(lambda: sg_ops.packed_gather_bwd(g, idx, n_rows), 20)
    plain_ms = _time_ms(lambda: sg_ops.packed_gather_bwd_plain(g, idx, n_rows), 3)
    rows = torch.clamp(idx, 0, n_rows - 1).long()
    lib_ms = _time_ms(lambda: torch.zeros(n_rows, cols, device=dev).index_add_(0, rows, g), 20)
    nbytes = n * cols * 4 + n * 4 + n_rows * cols * 4
    bound = _bound(n * cols, nbytes)
    print(f"[time] packed_gather_bwd {label} {n} x {cols}: kernels {ms:.4f} ms, whole call "
          f"{wrap_ms:.4f} ms, plain (float64 index_add_) {plain_ms:.4f} ms, index_add_ (float32, "
          f"atomics) {lib_ms:.4f} ms, bound {bound[0]:.5f} ms ({bound[1]}: {nbytes} bytes); "
          f"{100 * bound[0] / ms:.1f}% of the bound alone, {100 * bound[0] / wrap_ms:.1f}% whole")
    return dict(err=err, rel=rel, ms=ms, wrap_ms=wrap_ms, plain_ms=plain_ms, lib_ms=lib_ms,
                bound=bound)


def _wall_scene(device="cuda"):
    """TestGradients' camera scene (the JAX package's tests/test_render.py:
    163-173): one wall filling the frame, lit by a point light."""
    import numpy as np
    from cudatracerlib_tpu_torch.scene import bsdf as B
    from cudatracerlib_tpu_torch.scene import lights as L
    from cudatracerlib_tpu_torch.scene.scene import Materials, build_scene
    from cudatracerlib_tpu_torch.scene.sensors import Camera
    from cudatracerlib_tpu_torch.scene.shapes import quad
    from cudatracerlib_tpu_torch.scene.textures import Textures

    wall = quad([-50, 5, -50], [50, 5, -50], [50, 5, 50], [-50, 5, 50])
    return build_scene(wall, None, None, np.zeros(len(wall), np.int32),
                       Materials.build([{"bsdf_type": B.DIFFUSE, "tex_albedo": 0}]),
                       Textures.build([{"type": 0, "color_a": [0.7, 0.6, 0.5]}]),
                       [{"type": L.POINT, "position": [0, 1.0, 0.5], "radiance": [30.0] * 3}],
                       Camera.look_at([0, 0, 0], [0, 5, 0], up=[0, 0, 1], fov_deg=40.0),
                       device=device)


def _loss_and_grads(scene, paths, width, height, spp, seed, cfg):
    """mean(render) and its gradient with respect to the fields `paths`."""
    from cudatracerlib_tpu_torch.convert import grads, with_grad
    from cudatracerlib_tpu_torch.render import path_tracer as pt

    s = with_grad(scene, paths)
    loss = pt.render(s, width, height, spp, seed, cfg).mean()
    loss.backward()
    return float(loss.detach()), grads(s, paths)


def _grad_gates(cornell, device="cuda"):
    """Phase 12: the pinned gradients, FD against AD on the camera, remat."""
    import numpy as np
    import torch
    from cudatracerlib_tpu_torch.convert import set_field
    from cudatracerlib_tpu_torch.render import path_tracer as pt

    p = GRAD_PIN
    cfg = pt.PTConfig(max_depth=p["max_depth"], rr_start=p["rr_start"])
    paths = ["textures.color_a", "lights.radiance"]
    args = (p["width"], p["height"], p["spp"], p["seed"])
    loss, g = _loss_and_grads(cornell, paths, *args, cfg)
    worst = 0.0
    for path, ref in zip(paths, (REF_GRAD_COLOR_A, REF_GRAD_RADIANCE)):
        ref = np.asarray(ref)
        err = np.abs(g[path] - ref)
        worst = max(worst, float((err / np.maximum(np.abs(ref), 1e-30)).max()))
        _require(bool((err <= REF_GRAD_RTOL * (np.abs(ref) + np.abs(ref).max())).all()),
                 f"pinned gradient {path}: {g[path].tolist()} against JAX's {ref.tolist()}")
    _require(abs(loss - REF_GRAD_LOSS) <= REF_LOSS_RTOL * REF_GRAD_LOSS,
             f"pinned loss {loss} against JAX's {REF_GRAD_LOSS}")
    print(f"[grad] pinned {p}: loss {loss:.9g} (JAX {REF_GRAD_LOSS}), d/dcolor_a "
          f"{np.round(g['textures.color_a'][:3], 9).tolist()}, d/dradiance "
          f"{np.round(g['lights.radiance'], 9).tolist()}; largest relative difference from JAX's "
          f"{worst:.3g} (tolerance {REF_GRAD_RTOL} + {REF_GRAD_RTOL} of the largest)")

    loss_r, g_r = _loss_and_grads(cornell, paths, *args, cfg._replace(remat=True))
    gap = max(float(np.abs(g_r[k] - g[k]).max() / np.abs(g[k]).max()) for k in paths)
    _require(abs(loss_r - loss) <= 1e-7 * abs(loss) and gap <= REMAT_TOL,
             f"remat changes the loss ({loss_r} vs {loss}) or the gradients ({gap})")
    same = "bit-equal" if loss_r == loss else "differs"
    print(f"[grad] remat on vs off: loss {loss_r:.9g} vs {loss:.9g} ({same}), "
          f"gradients within {gap:.3g} of the largest entry")

    wall = _wall_scene(device)
    wcfg = pt.PTConfig(max_depth=2, rr_start=99)
    wargs = (24, 24, 8, 0)
    _, wg = _loss_and_grads(wall, ["camera.to_world", "camera.tan_half_fov"], *wargs, wcfg)
    fov = float(wall.camera.tan_half_fov)

    def origin(s, dy):
        m = s.camera.to_world.clone()
        m[1, 3] += dy
        return set_field(s, "camera.to_world", m)

    def zoom(s, k):
        return set_field(s, "camera.tan_half_fov", s.camera.tan_half_fov * k)

    for label, make, x0, ad in (("camera origin", origin, 0.0, float(wg["camera.to_world"][1, 3])),
                                ("camera fov", zoom, 1.0, float(wg["camera.tan_half_fov"]) * fov)):
        h = 1e-2
        with torch.no_grad():
            up = float(pt.render(make(wall, x0 + h), *wargs, wcfg).mean())
            dn = float(pt.render(make(wall, x0 - h), *wargs, wcfg).mean())
        fd = (up - dn) / (2 * h)
        _require(abs(fd - ad) < FD_TOL_CAMERA * max(abs(fd), 1e-4) + 1e-4,
                 f"{label}: FD {fd} vs AD {ad}")
        print(f"[grad] {label} (wall, point light, 24x24, 8 spp, depth 2): FD {fd:.6g}, AD "
              f"{ad:.6g}, {100 * abs(fd - ad) / abs(fd):.3f}% apart (gate {FD_TOL_CAMERA:.0%})")



def _grad_pass(label, scene, cfg, paths, counters, reset_counts, width, height, spp, seed):
    """Phase 13: one full-size gradient pass, measured."""
    import torch
    from cudatracerlib_tpu_torch.render import path_tracer as pt

    def fwd():
        with torch.no_grad():
            return pt.render(scene, width, height, spp, seed, cfg)

    def fwd_bwd(remat=False):
        return _loss_and_grads(scene, paths, width, height, spp, seed, cfg._replace(remat=remat))

    _, rays = pt.render_counted(scene, width, height, spp, seed, cfg)
    mem = {}
    for remat in (True, False):
        fwd_bwd(remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fwd_bwd(remat)
        torch.cuda.synchronize()
        mem[remat] = (torch.cuda.max_memory_allocated() - base) / 1e9
    fwd_walls, fb_walls = _paired_walls_ms(fwd, fwd_bwd, GRAD_PAIRS)
    ratios = [b / a for a, b in zip(fwd_walls, fb_walls)]
    fwd_ms, fb_ms, ratio = _median(fwd_walls), _median(fb_walls), _median(ratios)
    torch.cuda.synchronize()
    reset_counts()
    loss, g = fwd_bwd()
    torch.cuda.synchronize()
    launches = {k: dict(c) for k, c in counters.items()}
    for k, v in g.items():
        _require(bool(torch.isfinite(torch.from_numpy(v)).all()) and abs(v).max() > 0,
                 f"{label}: the gradient of {k} is not finite or is all zero")
    prof = _profile(f"{label} forward+backward", fwd_bwd)
    print(f"[grad pass] {label} {width}x{height} spp {spp} depth {cfg.max_depth} seed {seed}: "
          f"loss {loss:.6g}, rays {int(rays)} (the forward's, as render_counted counts), forward "
          f"{fwd_ms:.3f} ms (min {min(fwd_walls):.3f}, max {max(fwd_walls):.3f}), "
          f"forward+backward {fb_ms:.3f} ms (min {min(fb_walls):.3f}, max {max(fb_walls):.3f}), "
          f"ratio {ratio:.3f} (min {min(ratios):.3f}, max {max(ratios):.3f}; medians of "
          f"{GRAD_PAIRS} alternating pairs), "
          f"{int(rays) / fb_ms / 1e3:.3f} Mrays/s with the backward; peak device memory above "
          f"the scene: remat off {mem[False]:.3f} GB, on {mem[True]:.3f} GB; idle "
          f"{prof['idle']:.3f} under the profiler")
    print(f"[grad pass] {label} launches over one forward+backward: {json.dumps(launches)}")
    return dict(loss=loss, grads=g, rays=int(rays), fwd_ms=fwd_ms, fb_ms=fb_ms, ratio=ratio,
                mem=mem, launches=launches, idle=prof["idle"])


def _capture_bdpt(caustic, bcfg):
    """One warm bench-config-5 BDPT pass (seed 0) with the arguments of
    intersect_dense, packed_gather's forward and the splat sum captured:
    ({label: dense arguments} of the first light-walk launch, the first eye
    launch, the first t=1 splat launch and the first connection launch,
    [(table, idx)] of every gather, [(pixel_id, value, n_px)] of the splat
    sums)."""
    import torch
    from cudatracerlib_tpu_torch.image import film as film_mod
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops
    from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops
    from cudatracerlib_tpu_torch.render import bdpt

    dense_calls, gather_calls, splat_calls = [], [], []
    real_dense, real_gather, real_splat = ops.intersect_dense, sg_ops._gather, film_mod.splat_sum

    def capture_dense(woop, o, d, t_min=1e-4, t_max=ops.T_MAX_CLAMP, any_hit=False, boxes=None):
        keep = lambda x: x.clone() if isinstance(x, torch.Tensor) else x  # noqa: E731
        dense_calls.append((woop, keep(o), keep(d), keep(t_min), keep(t_max), any_hit, boxes))
        return real_dense(woop, o, d, t_min, t_max, any_hit=any_hit, boxes=boxes)

    def capture_gather(table, idx):
        gather_calls.append((table, idx.clone()))
        return real_gather(table, idx)

    def capture_splat(pixel_id, value, n_px):
        splat_calls.append((pixel_id.clone(), value.clone(), n_px))
        return real_splat(pixel_id, value, n_px)

    ops.intersect_dense, sg_ops._gather = capture_dense, capture_gather
    film_mod.splat_sum = capture_splat
    try:
        bdpt.render_bdpt_counted(caustic, PPM_W, PPM_H, PPM_SPP, 0, bcfg)
        torch.cuda.synchronize()
    finally:
        ops.intersect_dense, sg_ops._gather = real_dense, real_gather
        film_mod.splat_sum = real_splat
    closest = [c for c in dense_calls if not c[5]]
    shadow = [c for c in dense_calls if c[5]]
    S = bcfg.s_max  # light walk: S closest; splats: S any-hit; eye: closest, NEE, S connections
    _require(len(closest) == S + bcfg.base.max_depth and len(splat_calls) == 1,
             f"a BDPT pass made {len(closest)} closest-hit launches and {len(splat_calls)} "
             f"splat sums, not {S + bcfg.base.max_depth} and 1")
    return {"bdpt light rays": closest[0], "bdpt eye rays": closest[S],
            "bdpt splat rays": shadow[0], "bdpt connection rays": shadow[S + 1]}, \
        gather_calls, splat_calls


def _capture_splats(fn):
    """The splat sums' arguments of one call of `fn`."""
    from cudatracerlib_tpu_torch.image import film as film_mod

    calls, real = [], film_mod.splat_sum

    def capture(pixel_id, value, n_px):
        calls.append((pixel_id.clone(), value.clone(), n_px))
        return real(pixel_id, value, n_px)

    film_mod.splat_sum = capture
    try:
        fn()
    finally:
        film_mod.splat_sum = real
    return calls


def _check_splat(label, pix, val, n_px, dev):
    """The splat film's sum (packed_gather's backward kernels at C = 3, or
    4 for the filtered film's (rgb w, w) rows) on captured splats: within
    1e-5 relative of the float64 plain version
    where the sum is positive, 0 where it is 0, two launches bit-equal; the
    kernels alone, the whole call, the plain version and `index_add_`
    (float32, atomics) timed against the bytes the inputs need."""
    import torch
    from cudatracerlib_tpu_torch.image import film as film_mod
    from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops

    idx = pix.to(torch.int32)
    k1 = film_mod.splat_sum(pix, val, n_px)
    k2 = film_mod.splat_sum(pix, val, n_px)
    plain = sg_ops.packed_gather_bwd_plain(val, idx, n_px)
    torch.cuda.synchronize()
    _require(torch.equal(k1, k2), f"splat sum {label}: two launches differ")
    _require(bool((val >= 0).all()), f"splat sum {label}: a negative splat")
    pos = plain > 0
    _require(bool((k1[~pos] == 0).all()), f"splat sum {label}: a pixel with no light is not 0")
    rel = float(((k1 - plain).abs()[pos] / plain[pos]).max()) if bool(pos.any()) else 0.0
    err = float((k1 - plain).abs().max())
    _require(rel <= BWD_RTOL, f"splat sum {label}: max relative error {rel} > {BWD_RTOL}")
    n = val.shape[0]
    prepared, _ = sg_ops.bwd_launch_args(val, idx, n_px)
    ms = _time_kernel_ms([prepared] * 21, sg_ops.bwd_launch)
    wrap_ms = _time_ms(lambda: film_mod.splat_sum(pix, val, n_px), 20)
    plain_ms = _time_ms(lambda: sg_ops.packed_gather_bwd_plain(val, idx, n_px), 3)
    rows, C = pix.long(), val.shape[1]
    lib_ms = _time_ms(lambda: torch.zeros(n_px, C, device=dev).index_add_(0, rows, val), 20)
    nbytes = n * C * 4 + n * 4 + n_px * C * 4
    bound = _bound(n * C, nbytes)
    scratch = sg_ops.bwd_scratch_floats(C, n, n_px) * 4
    print(f"[kernel vs plain] splat sum {label}: {n} splats onto {n_px} pixels "
          f"({int(pos.any(-1).sum())} lit, {int((val > 0).any(-1).sum())} nonzero splats), max rel "
          f"err {rel:.3g}, max abs err {err:.3g}, two launches bit-equal; scratch {scratch} bytes")
    print(f"[time] splat sum {label}: kernels {ms:.4f} ms, whole call {wrap_ms:.4f} ms, plain "
          f"(float64 index_add_) {plain_ms:.4f} ms, index_add_ (float32, atomics) {lib_ms:.4f} ms, "
          f"bound {bound[0]:.5f} ms ({bound[1]}: {nbytes} bytes)")
    return dict(err=err, rel=rel, ms=ms, wrap_ms=wrap_ms, plain_ms=plain_ms, lib_ms=lib_ms,
                bound=bound, scratch=scratch)


def _check_film_runs(width, height, spp):
    """The filtered film (Gaussian, radius 1.5, 3x3 taps) at width x height
    x spp samples in the path tracer's order (32x32 screen tiles, repeated
    per sample), with seeded positions and values: the runs it splits into
    and the largest call's scratch against SPLAT_SCRATCH_FLOATS, rgb and
    weight within BWD_RTOL of the float64 plain sum of every tap at once,
    two calls bit-equal; the call, the plain sum and `index_add_` of the same
    taps timed, and the call's peak memory."""
    import torch
    from cudatracerlib_tpu_torch.image import film as film_mod
    from cudatracerlib_tpu_torch.image import pipeline
    from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops
    from cudatracerlib_tpu_torch.render import path_tracer as pt

    gen = torch.Generator(device="cuda").manual_seed(11)
    pix = torch.from_numpy(pt.block_order_pixels_np(width, height)).cuda().repeat(spp)
    n = pix.shape[0]
    sx = (pix % width).float() + torch.rand(n, generator=gen, device="cuda")
    sy = (pix // width).float() + torch.rand(n, generator=gen, device="cuda")
    val = torch.rand(n, 3, generator=gen, device="cuda")
    del pix

    def call():
        f = film_mod.add_samples_filtered(film_mod.Film.create(height, width), sx, sy, val,
                                          pipeline.GAUSSIAN, 1.5, 1)
        return torch.cat([f.rgb.reshape(-1, 3), f.weight.reshape(-1, 1)], 1)

    runs = list(film_mod.splat_runs(sy, 9, 1, height, width))
    scratch = max(sg_ops.bwd_scratch_floats(4, 9 * (b1 - b0), (y1 + 1 - y0) * width + 1)
                  for b0, b1, y0, y1 in runs) * 4
    _require(scratch <= film_mod.SPLAT_SCRATCH_FLOATS * 4,
             f"filtered film {width}x{height}: a call takes {scratch} bytes of scratch")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    _require(torch.equal(got, call()), f"filtered film {width}x{height}: two calls differ")
    ms = _time_ms(call, 3)
    pid, taps = film_mod.filter_taps(sx, sy, val, pipeline.GAUSSIAN, 1.5, 1, height, width)
    n_px = width * height
    plain = sg_ops.packed_gather_bwd_plain(taps, pid, n_px + 1)[:n_px]
    pos = plain > 0
    rel = float(((got - plain).abs()[pos] / plain[pos]).max())
    _require(bool((got[~pos] == 0).all()) and rel <= BWD_RTOL,
             f"filtered film {width}x{height}: max relative error {rel} > {BWD_RTOL}")
    plain_ms = _time_ms(lambda: sg_ops.packed_gather_bwd_plain(taps, pid, n_px + 1), 1)
    rows = pid.long()
    lib_ms = _time_ms(lambda: torch.zeros(n_px + 1, 4, device="cuda").index_add_(0, rows, taps), 3)
    one_call = sg_ops.bwd_scratch_floats(4, taps.shape[0], n_px + 1) * 4
    print(f"[kernel vs plain] filtered film {width}x{height} at {spp} spp ({n} samples, "
          f"{taps.shape[0]} taps): {len(runs)} runs, the largest call's scratch {scratch} bytes "
          f"(one call would take {one_call}), peak memory {peak} bytes; max rel err {rel:.3g}, "
          f"two calls bit-equal")
    print(f"[time] filtered film {width}x{height}: whole call (taps, runs, sums) {ms:.4f} ms, "
          f"plain (taps at once, float64 index_add_) {plain_ms:.4f} ms, index_add_ (float32, "
          f"atomics) of the taps {lib_ms:.4f} ms")
    return dict(runs=len(runs), scratch=scratch, one_call=one_call, peak=peak, rel=rel, ms=ms,
                plain_ms=plain_ms, lib_ms=lib_ms)


def _check_gather_at(label, table, idx):
    """packed_gather's forward on captured arguments: bit-equal to the plain
    version; kernel, plain version and `index_select` timed against the
    bytes bound."""
    import torch
    from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops

    kern = sg_ops.packed_gather(table, idx)
    plain = sg_ops.packed_gather_plain(table, idx)
    torch.cuda.synchronize()
    _require(torch.equal(kern, plain), f"packed_gather {label}: not bit-equal")
    ms = _time_ms(lambda: sg_ops.packed_gather(table, idx), 50)
    plain_ms = _time_ms(lambda: sg_ops.packed_gather_plain(table, idx), 50)
    lib_idx = torch.clamp(idx, 0, table.shape[0] - 1)
    lib_ms = _time_ms(lambda: torch.index_select(table, 0, lib_idx), 50)
    n = idx.shape[0]
    bound = _bound(0, n * table.shape[1] * 4 + n * 4 + table.numel() * 4)
    print(f"[kernel vs plain] packed_gather {label}: {n} rows of {table.shape[1]} from "
          f"{table.shape[0]}, bit-equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"index_select {lib_ms:.4f} ms, bound {bound[0]:.5f} ms ({bound[1]})")
    return dict(err=0.0, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms, bound=bound)


def _capture_volume(fn):
    """intersect_dense's arguments in one call of `fn` (volume renders):
    {label: (woop, o, d, t_min, t_max, any_hit, boxes)} of the first
    closest-hit launch (the camera rays), the second (the first bounce's
    continuations, medium scatter points among their origins) and the first
    any-hit launch (the first shadow rays, from the surface hits and from
    the medium scatter points, inside the plume, away from any surface)."""
    import torch
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops

    closest, shadow = [], []
    real = ops.intersect_dense

    def capture(woop, o, d, t_min=1e-4, t_max=ops.T_MAX_CLAMP, any_hit=False, boxes=None):
        keep = lambda x: x.clone() if isinstance(x, torch.Tensor) else x  # noqa: E731
        calls = shadow if any_hit else closest
        if len(calls) < 2:
            calls.append((woop, keep(o), keep(d), keep(t_min), keep(t_max), any_hit, boxes))
        return real(woop, o, d, t_min, t_max, any_hit=any_hit, boxes=boxes)

    ops.intersect_dense = capture
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        ops.intersect_dense = real
    _require(len(closest) == 2 and shadow, "the volume pass made too few intersect_dense launches")
    return {"volume camera rays": closest[0], "volume bounce-1 rays": closest[1],
            "volume shadow rays": shadow[0]}


def _vol_trips(scene, media, cfg, width, height, spp, seed):
    """The delta-tracking trip counts, bounce by bounce, of one volume pass
    (the same draws as the render's), read from lane 0's sampler state."""
    import torch
    from cudatracerlib_tpu_torch.render import volpath

    cfg = volpath._specialize(scene, media, cfg)
    _, o, d, _, smp = volpath._camera_batch(scene, width, height, spp, seed)
    carry, out = volpath.init_vol_carry(o, d, smp), []
    with torch.no_grad():
        for depth in range(cfg.max_depth):
            s0 = int(carry.sampler.state[0])
            carry = volpath.vol_bounce(scene, media, cfg, carry, depth)
            out.append(volpath.tracking_trips(s0, carry.sampler.state[0]))
    return out


def _volume_phase(scene, smi, reset_counts):
    """Phase 18 on the Cornell box `scene` (module docstring); returns the
    intersect_dense comparisons, the timed render's launch counts and the
    profile."""
    import torch
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops
    from cudatracerlib_tpu_torch.render import path_tracer as pt
    from cudatracerlib_tpu_torch.render import volpath
    from cudatracerlib_tpu_torch.scene import media as media_mod

    t0 = time.perf_counter()
    plume = media_mod.Media.build(media_mod.plume_records(scene.bvh.world_min,
                                                          scene.bvh.world_max))
    torch.cuda.synchronize()
    vol_build_s = time.perf_counter() - t0
    _require(plume.grid_data.device.type == "cuda", "Media.build did not build on the card")
    vcfg = pt.PTConfig(max_depth=VOL_DEPTH)
    vp = VOL_PIN
    v_img, v_rays = volpath.render_vol_counted(scene, plume, vp["width"], vp["height"],
                                               vp["spp"], vp["seed"], vcfg)
    v_mean = float(v_img.mean())
    v_trips = _vol_trips(scene, plume, vcfg, vp["width"], vp["height"], vp["spp"], vp["seed"])
    _require(bool(torch.isfinite(v_img).all()), "the pinned volume image is not finite")
    _require(abs(v_mean - REF_VOL_MEAN) <= VOL_TOL * REF_VOL_MEAN,
             f"pinned volume mean {v_mean} is not within {VOL_TOL:.1%} of {REF_VOL_MEAN}")
    _require(abs(int(v_rays) - REF_VOL_RAYS) <= VOL_RAYS_TOL * REF_VOL_RAYS,
             f"pinned volume rays {int(v_rays)} are not within 1% of {REF_VOL_RAYS}")
    print(f"[main path] volume: plume {tuple(plume.res[0].tolist())} grid, modes {plume.modes}, "
          f"built in {vol_build_s:.3f} s; pinned {vp}: mean {v_mean:.9f} (ref {REF_VOL_MEAN}, "
          f"{100 * (v_mean / REF_VOL_MEAN - 1):+.5f}%), rays {int(v_rays)} (ref {REF_VOL_RAYS}); "
          f"tracking trips by bounce {v_trips} (JAX's CPU {REF_VOL_TRIPS}: "
          f"{'matched' if v_trips == REF_VOL_TRIPS else 'differ'})")
    # bench.py's order: warm at seed 0 (intersect_dense's arguments captured), rays counted at
    # seed 3, the render timed at seed 7, 3 passes each
    vol_args = _capture_volume(lambda: volpath.render_vol_stepwise(
        scene, plume, VOL_W, VOL_H, VOL_SPP, VOL_PASSES, 0, vcfg))
    vol_r = {label: _compare(label, c[0], c[1], c[2], c[3], c[4], 20, c[6])
             for label, c in vol_args.items()}
    _, vol_rays = volpath.render_vol_stepwise(scene, plume, VOL_W, VOL_H, VOL_SPP, VOL_PASSES, 3,
                                              vcfg, with_stats=True)
    torch.cuda.synchronize()
    reset_counts()
    dt_v, img_v = _timed(lambda: volpath.render_vol_stepwise(scene, plume, VOL_W, VOL_H, VOL_SPP,
                                                              VOL_PASSES, 7, vcfg))
    launch_v = dict(ops.launches)
    print(f"[main path] volume launches {json.dumps(launch_v)}")
    _require(launch_v["closest"] > 0 and launch_v["any_hit"] > 0,
             f"the volume path did not launch intersect_dense for both ray kinds: {launch_v}")
    _require(bool(torch.isfinite(img_v).all()) and tuple(img_v.shape) == (VOL_H, VOL_W, 3),
             "the bench-config-4 image is not finite or has the wrong shape")
    v_trips7 = _vol_trips(scene, plume, vcfg, VOL_W, VOL_H, VOL_SPP, 7)
    print(f"[main path] volume {VOL_W}x{VOL_H} spp {VOL_SPP} depth {VOL_DEPTH} x {VOL_PASSES} "
          f"passes, seed 7: {dt_v:.4f} s ({dt_v / VOL_PASSES:.4f} s a pass), rays {int(vol_rays)} "
          f"(seed 3, as bench.py counts), {int(vol_rays) / dt_v / 1e6:.3f} Mrays/s, mean "
          f"{float(img_v.mean()):.6f}; tracking trips by bounce of the first pass {v_trips7}; "
          f"{smi}")
    prof_v = _profile("volume bench config 4 pass", lambda: volpath.render_vol_counted(
        scene, plume, VOL_W, VOL_H, VOL_SPP, 7, vcfg))
    return dict(compare=vol_r, launches=launch_v, profile=prof_v)


def _vgrad_cases():
    """Phase 19's pinned cases on the card: name: (scene, media records,
    fields, (width, height, spp, seed, max_depth, rr_start)), as
    tools/volume_grad_reference.py builds them."""
    import numpy as np
    from cudatracerlib_tpu_torch.scene import media as media_mod
    from cudatracerlib_tpu_torch.scene.shapes import cornell_box, furnace_scene

    slab_box = dict(box_min=[-2, -3, -2], box_max=[2, -1.5, 2])
    dens = (0.5 + 0.5 * np.random.default_rng(3).random((6, 6, 6))).astype(np.float32)
    furnace, box = furnace_scene(albedo=0.7), cornell_box()
    return {
        "slab": (furnace, [dict(type=media_mod.HOMOGENEOUS, sigma_a=[0.3] * 3, sigma_s=[0.1] * 3,
                                **slab_box)], ["sigma_a"], (16, 16, 4, 0, 3, 99)),
        "grid6": (furnace, [dict(type=media_mod.GRID, sigma_a=[0.4] * 3, sigma_s=[0.0] * 3,
                                 density=dens, **slab_box)], ["grid_data"], (16, 16, 4, 0, 3, 99)),
        "plume": (box, media_mod.plume_records(box.bvh.world_min, box.bvh.world_max), VGRAD_PATHS,
                  (64, 64, 4, 3, 6, 5)),
    }


def _vol_loss_and_grads(scene, media, paths, width, height, spp, seed, cfg):
    """mean(render_vol) and its gradient with respect to the media fields `paths`."""
    from cudatracerlib_tpu_torch.convert import grads, with_grad
    from cudatracerlib_tpu_torch.render import volpath

    m = with_grad(media, paths)
    loss = volpath.render_vol(scene, m, width, height, spp, seed, cfg).mean()
    loss.backward()
    return float(loss.detach()), grads(m, paths)


def _vol_fd(scene, media, g, width, height, spp, seed, cfg, h, entry=None):
    """Central differences of mean(render_vol) against AD: along one entry
    (path, index) of the gradient `g`, or, as the JAX package's grid test
    does, along the unit direction of g's `grid_data` part, whose
    directional derivative is that part's norm. Returns (fd, ad)."""
    import numpy as np
    import torch
    from cudatracerlib_tpu_torch.convert import get_field, set_field
    from cudatracerlib_tpu_torch.render import volpath

    if entry is None:
        norm = float(np.linalg.norm(g["grid_data"].astype(np.float64)))
        step, ad = {"grid_data": g["grid_data"] / norm}, norm
    else:
        path, i = entry
        e = np.zeros_like(g[path])
        e.flat[i] = 1.0
        step, ad = {path: e}, float(g[path].flat[i])
    out = []
    for sign in (1.0, -1.0):
        m = media
        for path, e in step.items():
            base = get_field(media, path)
            m = set_field(m, path, base + sign * h * torch.from_numpy(e).to(base.device))
        with torch.no_grad():
            out.append(float(volpath.render_vol(scene, m, width, height, spp, seed, cfg).mean()))
    return (out[0] - out[1]) / (2 * h), ad


def _vgrad_gates():
    """Phase 19 (a): the card's gradients of the three pinned cases against
    the JAX package's CPU values (or JAX's FD-vs-AD gate where the trips
    differ), and remat on against off on the plume."""
    import numpy as np
    from cudatracerlib_tpu_torch.render import path_tracer as pt
    from cudatracerlib_tpu_torch.scene import media as media_mod

    ref = np.load(VGRAD_REF)
    out = {}
    for name, (scene, records, paths, (w, h, spp, seed, depth, rr)) in _vgrad_cases().items():
        media = media_mod.Media.build(records)
        cfg = pt.PTConfig(max_depth=depth, rr_start=rr)
        loss, g = _vol_loss_and_grads(scene, media, paths, w, h, spp, seed, cfg)
        trips = _vol_trips(scene, media, cfg, w, h, spp, seed)
        ref_trips = [int(x) for x in ref[f"{name}/trips"]]
        ref_loss = float(ref[f"{name}/loss"])
        worst = max(float(np.abs(g[p] - ref[f"{name}/{p}"]).max() / np.abs(ref[f"{name}/{p}"]).max())
                    for p in paths)
        if trips == ref_trips:
            for p in paths:
                r = ref[f"{name}/{p}"]
                err = np.abs(g[p] - r)
                _require(bool((err <= REF_GRAD_RTOL * (np.abs(r) + np.abs(r).max())).all()),
                         f"volume gradient {name} d/d{p}: the largest difference from JAX's is "
                         f"{float(err.max())} (largest entry {float(np.abs(r).max())})")
            _require(abs(loss - ref_loss) <= REF_LOSS_RTOL * abs(ref_loss),
                     f"volume gradient {name}: loss {loss} against JAX's {ref_loss}")
            gate = (f"pinned: every entry within {REF_GRAD_RTOL} relative + {REF_GRAD_RTOL} of the "
                    f"largest, loss within {REF_LOSS_RTOL}")
        else:
            # another sample of the estimator: JAX's own FD-vs-AD gate
            if name == "slab":
                fd, ad = _vol_fd(scene, media, g, w, h, spp, seed, cfg, 1e-2, ("sigma_a", 0))
                ok = fd < 0 and ad < 0 and abs(fd - ad) < VGRAD_FD_TOL * abs(fd)
            else:
                fd, ad = _vol_fd(scene, media, g, w, h, spp, seed, cfg, 5e-2)
                ok = fd > 0 and abs(fd - ad) < VGRAD_FD_TOL * abs(fd)
            _require(ok, f"volume gradient {name}: trips {trips} differ from JAX's {ref_trips}, "
                         f"and FD {fd} vs AD {ad} fails JAX's {VGRAD_FD_TOL:.0%} gate")
            gate = f"trips differ: FD {fd:.6g} vs AD {ad:.6g} within JAX's {VGRAD_FD_TOL:.0%}"
        print(f"[vol grad] {name} {w}x{h} spp {spp} seed {seed} depth {depth} d/d{paths}: loss "
              f"{loss:.9g} (JAX {ref_loss:.9g}), tracking trips by bounce {trips} (JAX's CPU "
              f"{ref_trips}: {'matched' if trips == ref_trips else 'differ'}), largest difference "
              f"from JAX's {worst:.3g} of the field's largest entry; gate: {gate}")
        out[name] = dict(loss=loss, trips=trips, matched=trips == ref_trips, worst=worst)
        if name == "plume":
            loss_r, g_r = _vol_loss_and_grads(scene, media, paths, w, h, spp, seed,
                                              cfg._replace(remat=True))
            gap = max(float(np.abs(g_r[k] - g[k]).max() / np.abs(g[k]).max()) for k in paths)
            _require(abs(loss_r - loss) <= 1e-7 * abs(loss) and gap <= REMAT_TOL,
                     f"volume remat changes the loss ({loss_r} vs {loss}) or the gradients ({gap})")
            print(f"[vol grad] plume remat on vs off: loss {loss_r:.9g} vs {loss:.9g} "
                  f"({'bit-equal' if loss_r == loss else 'differs'}), gradients within {gap:.3g} "
                  f"of the largest entry")
    return out


def _capture_bwd(fn, want):
    """packed_gather_bwd's (g, idx, n_rows) of the first call in one call of
    `fn` for which want(g, idx, n_rows) holds (clones), and fn's result."""
    from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops

    seen, real = [], sg_ops.packed_gather_bwd

    def record(g, idx, n_rows):
        if not seen and want(g, idx, n_rows):
            seen.append((g.clone(), idx.clone(), n_rows))
        return real(g, idx, n_rows)

    sg_ops.packed_gather_bwd = record
    try:
        out = fn()
    finally:
        sg_ops.packed_gather_bwd = real
    _require(bool(seen), "no packed_gather_bwd call of the wanted shape was made")
    return seen[0], out


def _check_bwd_captured(label, g, idx, n_rows, dev):
    """The gather backward on a captured (g, idx): two launches bit-equal,
    rows no lane hit 0, and each row within 1e-5 of its sum of |g| from the
    float64 plain version (a captured cotangent has both signs, so a row's
    sum may cancel: Σ|g| is the scale its float32 rounding errs on). Then
    phase 11's checks and times at the captured indices (a seeded uniform
    cotangent, within 1e-5 relative), the scratch and its row-mask share."""
    import torch
    from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops

    n, cols = g.shape
    k1 = sg_ops.packed_gather_bwd(g, idx, n_rows)
    k2 = sg_ops.packed_gather_bwd(g, idx, n_rows)
    plain = sg_ops.packed_gather_bwd_plain(g, idx, n_rows)
    scale = sg_ops.packed_gather_bwd_plain(g.abs(), idx, n_rows)
    torch.cuda.synchronize()
    _require(torch.equal(k1, k2), f"packed_gather_bwd {label}: two launches differ")
    hit = torch.bincount(torch.clamp(idx, 0, n_rows - 1).long(), minlength=n_rows) > 0
    _require(bool((k1[~hit] == 0).all()), f"packed_gather_bwd {label}: an unhit row is not 0")
    live = scale > 0
    rel = float(((k1 - plain).abs()[live] / scale[live]).max()) if bool(live.any()) else 0.0
    _require(rel <= BWD_RTOL, f"packed_gather_bwd {label}: {rel} of a row's sum of |g| > {BWD_RTOL}")
    print(f"[kernel vs plain] packed_gather_bwd {label}, captured cotangent: {n} lanes x {cols} "
          f"onto {n_rows} rows ({int(hit.sum())} hit), max error {rel:.3g} of the row's sum of "
          f"|g|, max abs err {float((k1 - plain).abs().max()):.3g}, two launches bit-equal")
    del k1, k2, plain, scale
    r = _check_gather_bwd(label, idx, n_rows, cols, dev)
    n_tiles, n_words = -(-n // sg_ops.BWD_TILE), -(-n_rows // 32)
    scratch = sg_ops.bwd_scratch_floats(cols, n, n_rows) * 4
    masks = 2 * n_tiles * n_words * 4
    print(f"[scratch] packed_gather_bwd {label}: {scratch} bytes, of which the tiles' row masks "
          f"{masks} ({100 * masks / scratch:.1f}%); g and idx {n * cols * 4 + n * 4} bytes")
    return dict(r, captured_rel=rel, scratch=scratch, masks=masks, lanes=n, rows=n_rows)


def _volume_grad_phase(scene, smi, reset_counts):
    """Phase 19 (module docstring) on the Cornell box `scene`: the gates,
    the bench-config-4 gradient pass and the gather backward at its shapes."""
    import numpy as np
    import torch
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops
    from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops
    from cudatracerlib_tpu_torch.render import path_tracer as pt
    from cudatracerlib_tpu_torch.render import volpath
    from cudatracerlib_tpu_torch.scene import media as media_mod
    from cudatracerlib_tpu_torch.scene.shapes import furnace_scene

    gates = _vgrad_gates()
    plume = media_mod.Media.build(media_mod.plume_records(scene.bvh.world_min,
                                                          scene.bvh.world_max))
    cfg = pt.PTConfig(max_depth=VOL_DEPTH)
    args = (VOL_W, VOL_H, VOL_SPP, VGRAD_SEED)
    n_grid = plume.grid_data.shape[0]

    def fwd():
        with torch.no_grad():
            return volpath.render_vol(scene, plume, *args, cfg)

    def fwd_bwd(remat=False):
        return _vol_loss_and_grads(scene, plume, VGRAD_PATHS, *args, cfg._replace(remat=remat))

    _, rays = volpath.render_vol_counted(scene, plume, *args, cfg)
    mem = {}
    for remat in (True, False):
        fwd_bwd(remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fwd_bwd(remat)
        torch.cuda.synchronize()
        mem[remat] = (torch.cuda.max_memory_allocated() - base) / 1e9
    fwd_walls, fb_walls = _paired_walls_ms(fwd, fwd_bwd, VGRAD_PAIRS)
    ratios = [b / a for a, b in zip(fwd_walls, fb_walls)]
    fwd_ms, fb_ms, ratio = _median(fwd_walls), _median(fb_walls), _median(ratios)

    # one forward+backward with the launches counted; intersect_dense's arguments and the
    # first transmittance lookup's backward (the last bounce's shadow-ray Tr, the first the
    # backward runs: B x TAU_STEPS x 8 corner lanes onto the grid) captured
    lanes = VOL_W * VOL_H * VOL_SPP * media_mod.TAU_STEPS * 8
    torch.cuda.synchronize()
    reset_counts()
    captured = {}

    def counted():
        captured["grid"], captured["result"] = _capture_bwd(
            fwd_bwd, lambda g, i, r: r == n_grid and g.shape == (lanes, 1))

    dense_args = _capture_volume(counted)
    loss, g = captured.pop("result")
    torch.cuda.synchronize()
    launches = {"intersect_dense": dict(ops.launches), "shade_gather": dict(sg_ops.launches)}
    print(f"[vol grad pass] launches over one forward+backward: {json.dumps(launches)}")
    lv = launches
    _require(lv["intersect_dense"]["closest"] > 0 and lv["intersect_dense"]["any_hit"] > 0
             and all(lv["shade_gather"][k] > 0 for k in ("gather_bwd_tile", "gather_bwd_range",
                                                          "gather_bwd_final")),
             f"the volume gradient pass did not launch its kernels: {lv}")
    for k, v in g.items():
        _require(bool(np.isfinite(v).all()) and np.abs(v).max() > 0,
                 f"the volume gradient of {k} is not finite or is all zero")
    prof = _profile("volume gradient pass forward+backward", fwd_bwd)
    # reported, not gated: with the noise held, the weights' values cancel their detached pdfs,
    # so the forward moves with the grid only where a tracking decision flips (PERF.md, PR 10)
    fd, ad = _vol_fd(scene, plume, g, *args, cfg, 5e-2)
    fd_ok = fd > 0 and abs(fd - ad) < VGRAD_FD_TOL * abs(fd)
    print(f"[vol grad pass] {VOL_W}x{VOL_H} spp {VOL_SPP} depth {VOL_DEPTH} seed {VGRAD_SEED} "
          f"d/d{VGRAD_PATHS}: loss {loss:.6g}, rays {int(rays)} (the forward's, as "
          f"render_vol_counted counts), forward {fwd_ms:.3f} ms (min {min(fwd_walls):.3f}, max "
          f"{max(fwd_walls):.3f}), forward+backward {fb_ms:.3f} ms (min {min(fb_walls):.3f}, max "
          f"{max(fb_walls):.3f}), ratio {ratio:.3f} (min {min(ratios):.3f}, max {max(ratios):.3f}; "
          f"medians of {VGRAD_PAIRS} alternating pairs); peak device memory above the scene: remat "
          f"on {mem[True]:.3f} GB, off {mem[False]:.3f} GB; idle {prof['idle']:.3f} under the "
          f"profiler; directional FD along grid_data's gradient {fd:.6g} against its norm {ad:.6g} "
          f"({100 * abs(fd - ad) / max(abs(fd), 1e-30):.2f}% apart; within JAX's "
          f"{VGRAD_FD_TOL:.0%}: {'yes' if fd_ok else 'no'}, not gated)")
    dense_r = {f"vgrad {label.split(' ', 1)[1]}": _compare(f"vgrad {label.split(' ', 1)[1]}",
                                                            c[0], c[1], c[2], c[3], c[4], 20, c[6])
               for label, c in dense_args.items()}

    # (c) the gather backward at the grid shape, then at a per-volume table's
    g_cap, idx_cap, rows_cap = captured.pop("grid")
    grid_r = _check_bwd_captured("grid", g_cap, idx_cap, rows_cap, scene.bvh.woop.device)
    del g_cap, idx_cap
    torch.cuda.empty_cache()
    ga = np.zeros((8, 8, 8, 3), np.float32)
    ga[..., 0], ga[..., 2] = 1.0, 0.2
    gs = (0.5 * np.random.default_rng(5).random((8, 8, 8))).astype(np.float32)
    gen = media_mod.Media.build([dict(type=media_mod.GRID, sigma_a=[0.8] * 3, sigma_s=[0.3] * 3,
                                      sigma_a_grid=ga, sigma_s_grid=gs, box_min=[-2, -3, -2],
                                      box_max=[2, -1.5, 2])])
    furnace = furnace_scene(albedo=0.7)
    (g_t, idx_t, rows_t), _ = _capture_bwd(
        lambda: _vol_loss_and_grads(furnace, gen, VGRAD_PATHS, 64, 64, 4, 0,
                                    pt.PTConfig(max_depth=3, rr_start=99)),
        lambda g_, i, r: r == gen.sigma_a.shape[0] and g_.shape[1] == 3)
    table_r = _check_bwd_captured("per-volume table", g_t, idx_t, rows_t, scene.bvh.woop.device)
    return dict(gates=gates, loss=loss, rays=int(rays), fwd_ms=fwd_ms, fb_ms=fb_ms, ratio=ratio,
                mem=mem, launches=launches, idle=prof["idle"], fd=fd, ad=ad, fd_ok=fd_ok,
                dense=dense_r,
                grid=grid_r, table=table_r)


def _sppm_runs(scene, media, size, passes, seed0, cfg):
    """`passes` SPPM passes on one fresh state, seeds seed0, seed0 + 1, ...:
    (last image, state)."""
    from cudatracerlib_tpu_torch.render import sppm

    img, state = None, None
    for i in range(passes):
        img, state = sppm.render_sppm_pass(scene, size, size, seed0 + i, state, cfg, media=media)
    return img, state


def _sppm_first_trips(scene, media, n_photons, seed):
    """The tracking trips of the photon walk's first bounce (lane 0's
    sampler around sample_distance), as tools/sppm_reference_mean.py counts."""
    import torch
    from cudatracerlib_tpu_torch.render import path_tracer as pt
    from cudatracerlib_tpu_torch.render import sppm
    from cudatracerlib_tpu_torch.render.light_tracer import emit_particles
    from cudatracerlib_tpu_torch.sampling.rng import Sampler, draws_between
    from cudatracerlib_tpu_torch.scene import media as media_mod
    from cudatracerlib_tpu_torch.scene import scene as scene_mod

    with torch.no_grad():
        cfg = pt.specialize_config(scene, sppm.SPPMConfig().base)
        smp = Sampler.create(seed, torch.arange(n_photons, device=scene.light_cdf.device), 0xF00D)
        o, d, _, _, _, smp = emit_particles(scene, n_photons, smp, cfg)
        hit = scene_mod.scene_intersect(scene, o, d)
        s = media_mod.sample_distance(media, o, d, cfg.ray_eps,
                                      torch.where(hit.valid, hit.t, 1e8), smp)[0]
    return (draws_between(smp.state[0], s.state[0]) - 1) // 2


def _capture_sppm(fn):
    """intersect_dense's and packed_gather's arguments in one call of `fn`
    (SPPM passes): the first closest-hit launch (the photon walk's), the
    first closest-hit launch with the eye batch's lane count, the first
    any-hit launch, and the first gather."""
    import torch
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops
    from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops

    dense, gathers = [], []
    real_dense, real_gather = ops.intersect_dense, sg_ops._gather

    def capture_dense(woop, o, d, t_min=1e-4, t_max=ops.T_MAX_CLAMP, any_hit=False, boxes=None):
        keep = lambda x: x.clone() if isinstance(x, torch.Tensor) else x  # noqa: E731
        if len(dense) < 64:
            dense.append((woop, keep(o), keep(d), keep(t_min), keep(t_max), any_hit, boxes))
        return real_dense(woop, o, d, t_min, t_max, any_hit=any_hit, boxes=boxes)

    def capture_gather(table, idx):
        if not gathers:
            gathers.append((table, idx.clone()))
        return real_gather(table, idx)

    ops.intersect_dense, sg_ops._gather = capture_dense, capture_gather
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        ops.intersect_dense, sg_ops._gather = real_dense, real_gather
    closest = [c for c in dense if not c[5]]
    photon = closest[0]
    eye = next(c for c in closest if c[1].shape[0] != photon[1].shape[0])
    shadow = next(c for c in dense if c[5])
    return {"photon rays": photon, "eye rays": eye, "shadow rays": shadow}, gathers


def _sppm_phase(cornell, caustic, smi, reset_counts):
    """Phase 20 (module docstring): the pinned SPPM runs, then the caustic
    scene and the plume at full size."""
    import torch
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops
    from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops
    from cudatracerlib_tpu_torch.render import sppm
    from cudatracerlib_tpu_torch.scene import media as media_mod

    plume = media_mod.Media.build(media_mod.plume_records(cornell.bvh.world_min,
                                                          cornell.bvh.world_max))
    scenes = {"cornell": cornell, "caustic": caustic}
    pins = {}
    for name, (scene_name, vol, photons, passes, ref, tol, ref_trips) in SPPM_PINS.items():
        cfg = sppm.SPPMConfig(n_photons=photons, vol_estimator=vol)
        img, state = _sppm_runs(scenes[scene_name], plume if vol else None, SPPM_PIN_SIZE, passes,
                                0, cfg)
        mean = float(img.mean())
        r2 = float(state.r2.mean())
        share = float((state.n_acc > 0).float().mean())
        _require(bool(torch.isfinite(img).all()), f"the pinned SPPM {name} image is not finite")
        _require(abs(mean - ref) <= tol * ref,
                 f"pinned SPPM {name} mean {mean} is not within {tol:.2%} of JAX's {ref}")
        trips = _sppm_first_trips(scenes[scene_name], plume, photons, 0) if vol else None
        print(f"[main path] sppm pinned {name} ({SPPM_PIN_SIZE}x{SPPM_PIN_SIZE}, {photons} photons, "
              f"{passes} passes): mean {mean:.9f} (JAX {ref}, {100 * (mean / ref - 1):+.5f}%, "
              f"tolerance {tol:.3%}), mean r2 {r2:.9g}, gathered share {share:.6f}"
              + (f", first photon bounce's tracking trips {trips} (JAX's CPU {ref_trips}: "
                 f"{'matched' if trips == ref_trips else 'differ'})" if vol else ""))
        pins[name] = dict(mean=mean, rel=mean / ref - 1, trips=trips)

    runs = {}
    for label, scene, media, vol, passes, size in (
            ("caustic", caustic, None, sppm.VOL_NONE, SPPM_CAUSTIC_PASSES, PPM_W),
            ("plume beambeam", cornell, plume, sppm.VOL_BEAMBEAM, SPPM_VOL_PASSES, VOL_W)):
        cfg = sppm.SPPMConfig(vol_estimator=vol)
        dense_args, gathers = _capture_sppm(
            lambda: _sppm_runs(scene, media, size, passes, 0, cfg))  # noqa: B023 (warm, seed 0)
        dense_r = {f"sppm {label} {k}": _compare(f"sppm {label} {k}", c[0], c[1], c[2], c[3],
                                                 c[4], 10, c[6])
                   for k, c in dense_args.items()}
        gather_r = _check_gather_at(f"sppm {label}", *gathers[0]) if gathers else None
        torch.cuda.synchronize()
        reset_counts()
        dt, (img, _) = _timed(lambda: _sppm_runs(scene, media, size, passes, 7, cfg))  # noqa: B023
        launches = {"intersect_dense": dict(ops.launches), "packed_gather": dict(sg_ops.launches)}
        print(f"[main path] sppm {label} launches {json.dumps(launches)}")
        _require(launches["intersect_dense"]["closest"] > 0
                 and launches["intersect_dense"]["any_hit"] > 0,
                 f"SPPM {label} did not launch intersect_dense for both ray kinds: {launches}")
        if label == "caustic":
            _require(launches["packed_gather"]["gather"] > 0,
                     f"SPPM {label} did not launch packed_gather: {launches}")
        _require(bool(torch.isfinite(img).all()) and tuple(img.shape) == (size, size, 3),
                 f"the SPPM {label} image is not finite or has the wrong shape")
        prof = _profile(f"sppm {label} pass", lambda: _sppm_runs(  # noqa: B023
            scene, media, size, 1, 7, cfg))
        pass_s = dt / passes
        print(f"[main path] sppm {label} {size}x{size}, {cfg.n_photons} photons, max_gather "
              f"{cfg.max_gather}, {passes} passes from seed 7: {dt:.4f} s ({pass_s:.4f} s a pass), "
              f"{cfg.n_photons / pass_s / 1e6:.4f} M photons/s, {size * size / pass_s / 1e6:.4f} "
              f"M pixels/s, mean {float(img.mean()):.6f}; idle {prof['idle']:.3f} of one pass; "
              f"{smi}")
        runs[label] = dict(dt=dt, pass_s=pass_s, launches=launches, idle=prof["idle"],
                           dense=dense_r, gather=gather_r)
    return dict(pins=pins, runs=runs)


def _capture_render(fn):
    """intersect_dense's, packed_gather's and the splat sum's arguments in
    one call of `fn` (a render): the first two closest-hit launches (the
    camera rays and the first bounce's), the first any-hit launch, the first
    gather and the first splat sum."""
    import torch
    from cudatracerlib_tpu_torch.image import film as film_mod
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops
    from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops

    dense, gathers = [], []
    real_dense, real_gather = ops.intersect_dense, sg_ops._gather

    def capture_dense(woop, o, d, t_min=1e-4, t_max=ops.T_MAX_CLAMP, any_hit=False, boxes=None):
        keep = lambda x: x.clone() if isinstance(x, torch.Tensor) else x  # noqa: E731
        if len(dense) < 3:
            dense.append((woop, keep(o), keep(d), keep(t_min), keep(t_max), any_hit, boxes))
        return real_dense(woop, o, d, t_min, t_max, any_hit=any_hit, boxes=boxes)

    def capture_gather(table, idx):
        if not gathers:
            gathers.append((table, idx.clone()))
        return real_gather(table, idx)

    ops.intersect_dense, sg_ops._gather = capture_dense, capture_gather
    try:
        splats = _capture_splats(fn)
        torch.cuda.synchronize()
    finally:
        ops.intersect_dense, sg_ops._gather = real_dense, real_gather
    closest = [c for c in dense if not c[5]]
    shadow = [c for c in dense if c[5]]
    out = {"camera rays": closest[0], "first-bounce rays": closest[1]}
    if shadow:
        out["shadow rays"] = shadow[0]
    return out, gathers, splats


def _shading_phase(cornell, caustic, smi, reset_counts):
    """Phase 21 (module docstring): the closed-form surface shading at full
    size, its pins, and intersect_dense, packed_gather and the filtered
    film's splat sum held to their plain versions at their new shapes."""
    import torch
    from cudatracerlib_tpu_torch.image import film as film_mod
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops
    from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops
    from cudatracerlib_tpu_torch.render import bdpt, light_tracer, vcm
    from cudatracerlib_tpu_torch.render import path_tracer as pt
    from cudatracerlib_tpu_torch.scene import shapes
    from cudatracerlib_tpu_torch.scene.sensors import Camera

    def counts():
        return {"intersect_dense": dict(ops.launches), "shade_gather": dict(sg_ops.launches)}

    def pin(name, img, rays=None):
        m, ref = float(img.mean()), SHADING_PINS[name]
        _require(bool(torch.isfinite(img).all()), f"the pinned {name} image is not finite")
        _require(abs(m - ref) <= SHADING_TOL * ref,
                 f"pinned {name} mean {m} is not within {SHADING_TOL:.1%} of JAX's {ref}")
        print(f"[pin] {name} ({SHADING_PIN_SIZE}x{SHADING_PIN_SIZE}, {SHADING_PIN_SPP} spp, seed "
              f"{SHADING_PIN_SEED}): mean {m:.9f} (JAX {ref}, {100 * (m / ref - 1):+.5f}%)"
              + ("" if rays is None else f", rays {int(rays)}"))
        return m / ref - 1

    ps, cfg = SHADING_PIN_SIZE, pt.PTConfig(max_depth=DEPTH)
    pins, runs = {}, {}

    def pinned(name, scene, config=cfg):
        img, rays = pt.render_counted(scene, ps, ps, SHADING_PIN_SPP, SHADING_PIN_SEED, config)
        pins[name] = pin(name, img, rays)

    def bench(label, scene, config=cfg, require_pack=False, energy=False):
        """Warm at seed 0, then one counted pass at seed 7 with the counts
        reset just before and read just after, and its profile."""
        pt.render_counted(scene, W, H, SPP, 0, config)
        torch.cuda.synchronize()
        reset_counts()
        dt, (img, rays) = _timed(lambda: pt.render_counted(scene, W, H, SPP, 7, config))
        launch = counts()
        _require(launch["intersect_dense"]["closest"] > 0
                 and launch["intersect_dense"]["any_hit"] > 0,
                 f"{label} did not launch intersect_dense for both ray kinds: {launch}")
        if require_pack:
            _require(launch["shade_gather"]["gather"] > 0,
                     f"{label} did not launch packed_gather: {launch}")
        if config.rec_filter:
            _require(launch["shade_gather"]["gather_bwd_tile"] == 1,
                     f"{label} did not sum its taps in one splat call: {launch}")
        _require(bool(torch.isfinite(img).all()) and tuple(img.shape) == (H, W, 3),
                 f"the {label} image is not finite or has the wrong shape")
        mean = float(img.mean())
        if energy:
            _require(mean < 1.1, f"{label} gains energy in the furnace: mean {mean}")
        prof = _profile(label, lambda: pt.render_counted(scene, W, H, SPP, 7, config), top_n=3)
        print(f"[main path] {label} {W}x{H} spp {SPP} depth {DEPTH} seed 7: rays {int(rays)}, "
              f"{dt:.4f} s, {int(rays) / dt / 1e6:.3f} Mrays/s, mean {mean:.6f}, idle "
              f"{prof['idle']:.3f}; launches {json.dumps(launch)}; {smi}")
        runs[label] = dict(dt=dt, mrays=int(rays) / dt / 1e6, mean=mean, idle=prof["idle"],
                           launches=launch)
        return img

    # (a) the furnace: every closed-form type, then the nested types over DIFFUSE
    furnaces = {name: (lambda kw=kw: shapes.furnace_scene(**kw))
                for name, kw in shapes.FURNACE_CASES.items()}
    furnaces.update({name: (lambda tag=tag: shapes.nested_furnace(tag, **shapes.NESTED_KW))
                     for name, tag in shapes.NESTED_CASES.items()})
    checks = {}
    for name, make in furnaces.items():
        scene = make()
        pinned(f"furnace_{name}", scene)
        if name == "plastic":   # the kernels at the furnace's shapes, from a warm pass
            dense, gathers, _ = _capture_render(
                lambda: pt.render_counted(scene, W, H, SPP, 0, cfg))  # noqa: B023
            checks["dense"] = {f"furnace {k}": _compare(f"furnace {k}", c[0], c[1], c[2], c[3],
                                                        c[4], 10, c[6])
                               for k, c in dense.items()}
            checks["gather"] = _check_gather_at("furnace pack", *gathers[0])
        bench(f"furnace {name}", scene, require_pack=True, energy=True)

    # (b) the Cornell box through the other cameras
    for name, view in shapes.CORNELL_CAMERAS.items():
        scene = cornell._replace(camera=Camera.look_at(**view).to("cuda"))
        pinned(f"cornell_{name}", scene)
        bench(f"cornell {name}", scene)

    # (c) the Gaussian-filtered film beside the box film
    fcfg = pt.PTConfig(max_depth=DEPTH, rec_filter=1, rec_radius=1.5)
    pins["gaussian"] = pin("gaussian", pt.render(cornell, ps, ps, SHADING_PIN_SPP,
                                                 SHADING_PIN_SEED, fcfg))
    _, _, splats = _capture_render(lambda: pt.render_counted(cornell, W, H, SPP, 0, fcfg))
    pix, val, n_rows = splats[0]
    print(f"[splat] filtered film: {val.shape[0]} taps x {val.shape[1]} columns onto {n_rows} "
          f"rows; scratch {sg_ops.bwd_scratch_floats(val.shape[1], val.shape[0], n_rows) * 4} "
          f"bytes, of which row masks "
          f"{2 * -(-val.shape[0] // sg_ops.BWD_TILE) * -(-n_rows // 32) * 4} bytes")
    checks["splat"] = _check_splat("filtered film (gaussian, 3x3 taps)", pix, val, n_rows,
                                   val.device)
    # the alternative design, one call a tap: the same rows' sums from 9 calls of 2^20 lanes
    lanes = W * H * SPP   # the taps lie tap after tap (film.filter_taps)
    taps = [(pix[k * lanes:(k + 1) * lanes], val[k * lanes:(k + 1) * lanes])
            for k in range(pix.shape[0] // lanes)]
    per_tap_ms = _time_ms(lambda: [film_mod.splat_sum(p_, v_, n_rows) for p_, v_ in taps], 10)
    checks["splat"]["per_tap_ms"] = per_tap_ms
    print(f"[time] splat sum filtered film, one call a tap ({len(taps)} calls of "
          f"{taps[0][1].shape[0]} lanes, the sum of the taps' images left out): {per_tap_ms:.4f} ms "
          f"against one call's {checks['splat']['wrap_ms']:.4f} ms")
    checks["film_runs"] = _check_film_runs(1024, 1024, SPP)
    bench("cornell gaussian", cornell, fcfg)
    bench("cornell box film", cornell)
    # a filtered pass at 1024x1024 (the splat sum in runs), once
    reset_counts()
    dt, (img, rays) = _timed(lambda: pt.render_counted(cornell, 1024, 1024, SPP, 7, fcfg))
    launch = counts()
    n_runs = checks["film_runs"]["runs"]
    _require(bool(torch.isfinite(img).all()) and tuple(img.shape) == (1024, 1024, 3)
             and launch["shade_gather"]["gather_bwd_tile"] >= 2,
             f"the 1024x1024 Gaussian pass failed: {launch}")
    print(f"[main path] cornell gaussian 1024x1024 spp {SPP} depth {DEPTH} seed 7: rays "
          f"{int(rays)}, {dt:.4f} s, {int(rays) / dt / 1e6:.3f} Mrays/s, mean "
          f"{float(img.mean()):.6f}, splat calls {launch['shade_gather']['gather_bwd_tile']} "
          f"(the seeded film: {n_runs}); launches {json.dumps(launch)}; {smi}")
    runs["cornell gaussian 1024"] = dict(dt=dt, mrays=int(rays) / dt / 1e6,
                                         mean=float(img.mean()), launches=launch)
    box_w, gauss_w = _paired_walls_ms(lambda: pt.render_counted(cornell, W, H, SPP, 7, cfg),
                                      lambda: pt.render_counted(cornell, W, H, SPP, 7, fcfg),
                                      SHADING_PAIRS)
    checks["film_walls"] = dict(box_ms=_median(box_w), gaussian_ms=_median(gauss_w))
    print(f"[main path] cornell pass walls, medians of {SHADING_PAIRS} alternating pairs: box "
          f"film {_median(box_w):.3f} ms, Gaussian film {_median(gauss_w):.3f} ms "
          f"(+{_median(gauss_w) - _median(box_w):.3f} ms); {smi}")

    # (d) the caustic scene with regularization
    rcfg = pt.PTConfig(max_depth=DEPTH, regularization=0.1)
    pins["caustic_reg"] = pin("caustic_reg", pt.render(caustic, ps, ps, SHADING_PIN_SPP,
                                                       SHADING_PIN_SEED, rcfg))
    bench("caustic regularized", caustic, rcfg, require_pack=True)

    # (e) the bidirectional engines on the point- and spot-lit Cornell box and the furnace
    point_spot = shapes.cornell_point_spot()
    furnace = shapes.furnace_scene()
    n_pin, n_lt = ps * ps * SHADING_PIN_SPP, PPM_W * PPM_H * PPM_SPP
    bidir = {
        "lt_ps": (point_spot, lambda s, w, n, seed: light_tracer.render_light_trace(s, w, w, n, seed)),
        "bdpt_ps": (point_spot, lambda s, w, n, seed: bdpt.render_bdpt(s, w, w, n, seed)),
        "vcm_ps": (point_spot, lambda s, w, n, seed: vcm.render_vcm(s, w, w, n, seed, 1)),
        "lt_furnace": (furnace, lambda s, w, n, seed: light_tracer.render_light_trace(
            s, w, w, n, seed)),
    }
    for name, (scene, run) in bidir.items():
        lt = name.startswith("lt")
        pins[name] = pin(name, run(scene, ps, n_pin if lt else SHADING_PIN_SPP, SHADING_PIN_SEED))
        n = n_lt if lt else PPM_SPP
        run(scene, PPM_W, n, 0)   # warm
        torch.cuda.synchronize()
        reset_counts()
        dt, img = _timed(lambda: run(scene, PPM_W, n, 7))  # noqa: B023
        launch = counts()
        _require(launch["intersect_dense"]["any_hit"] > 0
                 and launch["shade_gather"]["gather_bwd_tile"] == 1,
                 f"{name} did not launch intersect_dense and the splat sum: {launch}")
        _require(bool(torch.isfinite(img).all()) and tuple(img.shape) == (PPM_H, PPM_W, 3),
                 f"the {name} image is not finite or has the wrong shape")
        print(f"[main path] {name} {PPM_W}x{PPM_H}, {f'{n} paths' if lt else f'{n} spp'}, "
              f"seed 7: {dt:.4f} s a pass, mean {float(img.mean()):.6f}; launches "
              f"{json.dumps(launch)}; {smi}")
        runs[name] = dict(dt=dt, mean=float(img.mean()), launches=launch)
    return dict(pins=pins, runs=runs, **checks)


def _timed(fn):
    """Host wall in seconds of one call of `fn`, ending in a synchronize,
    and its result."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "cudatracerlib_tpu_torch")):
        print("chip_smoke: the cudatracerlib_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    from cudatracerlib_tpu_torch import entry as entry_mod
    from cudatracerlib_tpu_torch import native
    from cudatracerlib_tpu_torch.accel import bvh as bvh_mod
    from cudatracerlib_tpu_torch.accel.bvh import build_bvh, tree_depth, woop_transform
    from cudatracerlib_tpu_torch.accel.traversal import STACK_DEPTH
    from cudatracerlib_tpu_torch.ops import intersect_bvh as bvh_ops
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops
    from cudatracerlib_tpu_torch.ops import photon_gather as pg_ops
    from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops
    from cudatracerlib_tpu_torch.render import bdpt, light_tracer, vcm
    from cudatracerlib_tpu_torch.render import path_tracer as pt
    from cudatracerlib_tpu_torch.render import ppm
    from cudatracerlib_tpu_torch.render import wavefront as wf
    from cudatracerlib_tpu_torch.scene import scene as scene_mod
    from cudatracerlib_tpu_torch.scene import shade_pack
    from cudatracerlib_tpu_torch.scene.bigscene import build_big_scene
    from cudatracerlib_tpu_torch.scene.shapes import caustic_scene, cornell_box, glossy_scene

    t_start = time.perf_counter()
    marks = [t_start]

    def lap(phase):
        marks.append(time.perf_counter())
        print(f"[wall] phase {phase}: {marks[-1] - marks[-2]:.1f} s")

    counters = (ops.launches, bvh_ops.launches, sg_ops.launches, pg_ops.launches)

    def reset_counts():
        for c in counters:
            for k in c:
                c[k] = 0

    # ---- 1. device ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"[device] {name}, {count} device(s), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    lap(1)
    # ---- 2. build, every source at once ----
    def timed(get):
        t0 = time.perf_counter()
        get()
        return time.perf_counter() - t0

    builds = {"intersect_dense.cu": ops.get_lib, "intersect_bvh.cu": bvh_ops.get_lib,
              "shade_gather.cu": sg_ops.get_lib, "shade_gather_bwd.cu": sg_ops.get_bwd_lib,
              "photon_gather.cu": pg_ops.get_lib, "bvh_builder.cpp (g++)": native.get_lib}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        secs = dict(zip(builds, pool.map(timed, builds.values())))
    print(f"[build] {', '.join(f'{k} {v:.2f} s' for k, v in secs.items())}; "
          f"all in {time.perf_counter() - t0:.2f} s (nvcc sm_90a, in parallel)")

    lap(2)
    # ---- 3. intersect_dense vs plain at the Cornell and PPM paths' shapes and at the band top ----
    scene = cornell_box()
    _require(scene.bvh.woop.device.type == "cuda", "cornell_box() did not build on the card")
    cfg = pt.specialize_config(scene, pt.PTConfig(max_depth=DEPTH))
    o, d, _, sampler = pt.camera_rays(scene, W, H, SPP, 3)
    woop, boxes = scene.bvh.woop, scene.bvh.chunk_boxes
    cam = _compare("cornell camera rays", woop, o, d, 1e-4, torch.inf, 50, boxes)
    bounce = _compare("cornell first-bounce rays", woop,
                      *_first_bounce(scene, cfg, o, d, sampler), 1e-4, torch.inf, 50, boxes)

    tris, so, sd = _soup(0, 4096, 0.08, dev)
    soup = torch.from_numpy(woop_transform(tris[:, 0], tris[:, 1], tris[:, 2])).to(dev)
    soup_r = _compare("soup4096", soup, so, sd, 1e-4, 2.0, 10)

    # the PPM path: intersect_dense's and photon_density's arguments, captured
    # in bench config 5's warm pass (seed 0; 9 times the pass at seed 7)
    caustic = caustic_scene()
    _require(caustic.bvh.woop.device.type == "cuda", "caustic_scene() did not build on the card")
    pcfg = ppm.PPMConfig()
    ppm_args, captured = _capture_ppm(caustic, pcfg)
    ppm_r = {label: _compare(label, c[0], c[1], c[2], c[3], c[4], 20, c[6])
             for label, c in ppm_args.items()}
    for label in ("ppm photon rays", "ppm eye rays"):  # yardstick, not gated
        c = ppm_args[label]
        ms_y = _bvh_kernel_ms(caustic.bvh, c[1], c[2], c[3], c[4], 20)
        print(f"[yardstick] {label}: {c[1].shape[0]} rays x {c[0].shape[0]} rows: intersect_bvh "
              f"kernel over the caustic BVH {ms_y:.4f} ms, intersect_dense kernel "
              f"{ppm_r[label]['ms']:.4f} ms")
    dense_err = max(r["err"] for r in [cam, bounce, soup_r, *ppm_r.values()])

    lap(3)
    # ---- 4. the Cornell path at bench config 1 ----
    img1, rays = pt.render_counted(scene, W, H, SPP, 3, cfg)
    mean1 = float(img1.mean())
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    img = pt.render_progressive(scene, W, H, SPP, N_PASS, 7, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ops.launches)
    print(f"[main path] cornell launches {launches}")
    _require(launches["closest"] > 0 and launches["any_hit"] > 0,
             f"the Cornell path did not launch the kernel for both ray kinds: {launches}")
    _require(bool(torch.isfinite(img).all()) and tuple(img.shape) == (H, W, 3),
             "the progressive image is not finite or has the wrong shape")
    _require(bool(torch.isfinite(img1).all()), "the counted image is not finite")
    _require(abs(mean1 - REF_MEAN_SEED3) <= 5e-3 * REF_MEAN_SEED3,
             f"seed-3 image mean {mean1} is not within 0.5% of {REF_MEAN_SEED3}")
    rays_pass = int(rays)
    mrays = rays_pass * N_PASS / dt / 1e6
    print(f"[main path] cornell {W}x{H} spp {SPP} depth {DEPTH}: seed-3 mean {mean1:.6f} "
          f"(ref {REF_MEAN_SEED3}), rays/pass {rays_pass}, {N_PASS} passes in {dt:.4f} s, "
          f"{mrays:.3f} Mrays/s, progressive mean {float(img.mean()):.6f}")
    print(f"[summary] intersect_dense kernel: cornell camera {cam['ms']:.4f} ms (bound "
          f"{cam['bound'][0]:.5f}), ppm photon {ppm_r['ppm photon rays']['ms']:.4f} ms (bound "
          f"{ppm_r['ppm photon rays']['bound'][0]:.5f}), soup4096 {soup_r['ms']:.4f} ms; "
          f"max abs err {dense_err:.3g}")

    lap(4)
    # ---- 5. intersect_bvh vs its plain version on glossy rays and a deep soup ----
    glossy = glossy_scene()
    gcfg = pt.specialize_config(glossy, pt.PTConfig(max_depth=DEPTH))
    ids = torch.arange(W * H * SPP, device=dev)
    _, go, gd, gstate = wf._camera_ray(glossy, ids, 3, W, H)
    bvh_cam = _compare_bvh("glossy camera rays", glossy.bvh, go, gd, 1e-4, torch.inf, 20)
    err_g, ms_bvh, plain_ms_bvh = bvh_cam["err"], bvh_cam["ms"], bvh_cam["plain_ms"]
    g1o, g1d = _first_bounce(glossy, gcfg, go, gd, pt.Sampler(state=gstate),
                             shade_pack.build_shade_pack(glossy))
    err_g1 = _compare_bvh("glossy first-bounce rays", glossy.bvh, g1o, g1d, 1e-4, torch.inf,
                          20)["err"]
    tris, so, sd = _soup(1, SOUP_TRIS, 0.03, dev)
    t0 = time.perf_counter()
    soup_bvh = build_bvh(tris)
    print(f"[build] soup65536 BVH: {soup_bvh.nodes.shape[0]} nodes, "
          f"{soup_bvh.woop.shape[0]} rows, {time.perf_counter() - t0:.2f} s")
    s65 = _compare_bvh("soup65536", soup_bvh, so, sd, 1e-4, torch.inf, 5)
    err_s65 = s65["err"]
    bvh_bound, s65_bound = bvh_cam["bound"], s65["bound"]
    print(f"[bound] intersect_bvh glossy camera rays {bvh_bound[0]:.5f} ms ({bvh_bound[1]}), "
          f"soup65536 {s65_bound[0]:.5f} ms ({s65_bound[1]})")

    lap(5)
    # ---- 6. packed_gather vs its plain version ----
    pack = shade_pack.build_shade_pack(glossy)
    first = scene_mod.scene_intersect(glossy, go, gd)
    idx_main = torch.clamp(first.prim, min=0)
    idx_odd = torch.cat([first.prim, torch.tensor([-7, pack.shape[0], pack.shape[0] + 999,
                                                   -(2 ** 31), 2 ** 31 - 1],
                                                  dtype=torch.int32, device=dev)])
    gather_err = 0.0
    for label, idx in (("first-hit prims", idx_main), ("with out-of-range indices", idx_odd)):
        kern = sg_ops.packed_gather(pack, idx)
        plain = sg_ops.packed_gather_plain(pack, idx)
        torch.cuda.synchronize()
        _require(torch.equal(kern, plain), f"packed_gather {label}: not bit-equal")
        gather_err = max(gather_err, float((kern - plain).abs().max()))
        print(f"[kernel vs plain] packed_gather {label}: {idx.shape[0]} rows of "
              f"{pack.shape[1]}, bit-equal")
    ms_g = _time_ms(lambda: sg_ops.packed_gather(pack, idx_main), 50)
    plain_ms_g = _time_ms(lambda: sg_ops.packed_gather_plain(pack, idx_main), 50)
    lib_ms_g = _time_ms(lambda: torch.index_select(pack, 0, idx_main), 50)
    gn_idx = idx_main.shape[0]
    gather_bound = _bound(0, gn_idx * pack.shape[1] * 4 + gn_idx * 4 + pack.numel() * 4)
    print(f"[time] packed_gather {gn_idx} x {pack.shape[1]}: kernel {ms_g:.4f} ms, plain "
          f"{plain_ms_g:.4f} ms, index_select {lib_ms_g:.4f} ms, bound "
          f"{gather_bound[0]:.5f} ms ({gather_bound[1]})")

    lap(6)
    # ---- 7. the glossy path: bench config 2 ----
    gimg, grays = wf.render_wavefront_counted(glossy, GLOSSY_PIN["width"], GLOSSY_PIN["height"],
                                              GLOSSY_PIN["spp"], GLOSSY_PIN["seed"], gcfg)
    gmean = float(gimg.mean())
    _require(bool(torch.isfinite(gimg).all()), "the pinned glossy image is not finite")
    _require(abs(gmean - REF_GLOSSY_MEAN) <= GLOSSY_TOL * REF_GLOSSY_MEAN,
             f"glossy pinned mean {gmean} is not within 1% of {REF_GLOSSY_MEAN}")
    print(f"[main path] glossy pinned {GLOSSY_PIN}: mean {gmean:.6f} (ref {REF_GLOSSY_MEAN}, "
          f"{100 * (gmean / REF_GLOSSY_MEAN - 1):+.4f}%), rays {int(grays)} (ref 507368)")
    spp2 = SPP * N_PASS
    wf.render_wavefront_counted(glossy, W, H, spp2, 0, gcfg)   # warm
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    bimg, brays = wf.render_wavefront_counted(glossy, W, H, spp2, 7, gcfg)
    torch.cuda.synchronize()
    gdt = time.perf_counter() - t0
    glaunch = {"intersect_bvh": dict(bvh_ops.launches), "packed_gather": dict(sg_ops.launches),
               "intersect_dense": dict(ops.launches)}
    print(f"[main path] glossy launches {json.dumps(glaunch)}")
    _require(glaunch["intersect_bvh"]["closest"] > 0 and glaunch["intersect_bvh"]["any_hit"] > 0,
             f"the glossy path did not launch intersect_bvh for both ray kinds: {glaunch}")
    _require(glaunch["packed_gather"]["gather"] > 0,
             f"the glossy path did not launch packed_gather: {glaunch}")
    _require(bool(torch.isfinite(bimg).all()) and tuple(bimg.shape) == (H, W, 3),
             "the bench-config-2 image is not finite or has the wrong shape")
    print(f"[main path] glossy {W}x{H} spp {spp2} depth {DEPTH} seed 7: rays {int(brays)}, "
          f"{gdt:.4f} s, {int(brays) / gdt / 1e6:.3f} Mrays/s, mean {float(bimg.mean()):.6f}")

    lap(7)
    # ---- 8. photon_density vs its plain version, on bench-config-5 inputs (captured in 3) ----
    dens_err, work = 0.0, {}
    for label, args in zip(("global map", "caustic map"), captured):
        dens_err = max(dens_err, _check_density(label, args))
        work[label] = _density_work(label, args)
    dens_err = max(dens_err, _check_density("hotspot", _hotspot(dev)))
    info = pg_ops.kernel_info()
    print(f"[build] photon_density: {json.dumps(info)}, {pg_ops.kernel_config()[1]} splits a "
          f"block of {pg_ops.kernel_config()[0]} queries")
    pd_ms = {}
    for label, args in zip(("global map", "caustic map"), captured):
        prepared, _ = pg_ops.launch_args(*args)
        pd_ms[label] = dict(
            ms=_time_kernel_ms([prepared] * 21, pg_ops.launch),
            wrap_ms=_time_ms(lambda: pg_ops.photon_density(*args), 20))  # noqa: B023
    main_args = captured[0]
    plain_ms_pd = _time_ms(lambda: pg_ops.photon_density_plain(*main_args), 2)
    pd_bound = work["global map"]["bound"]
    for label, t in pd_ms.items():
        print(f"[time] photon_density {label}: kernel {t['ms']:.4f} ms, wrapper "
              f"{t['wrap_ms']:.4f} ms, bound {work[label]['bound'][0]:.5f} ms "
              f"({100 * work[label]['bound'][0] / t['ms']:.2f}% of it; warp x chunk basis "
              f"{work[label]['chunk_bound'][0]:.5f} ms, "
              f"{100 * work[label]['chunk_bound'][0] / t['ms']:.1f}%; block x tile basis "
              f"{work[label]['old_bound'][0]:.5f} ms, "
              f"{100 * work[label]['old_bound'][0] / t['ms']:.1f}%)")
    print(f"[time] photon_density global map: plain {plain_ms_pd:.4f} ms")

    lap(8)
    # ---- 9. the PPM path: pinned pass, then bench config 5's PPM half ----
    pin = PPM_PIN
    pin_img = ppm.render_ppm_pass(caustic, pin["width"], pin["height"], pin["spp"], pin["seed"],
                                  pin["pass_idx"], pcfg._replace(n_photons=pin["n_photons"]))
    pmean = float(pin_img.mean())
    _require(bool(torch.isfinite(pin_img).all()), "the pinned PPM image is not finite")
    _require(abs(pmean - REF_PPM_MEAN) <= PPM_TOL * REF_PPM_MEAN,
             f"pinned PPM mean {pmean} is not within {PPM_TOL:.1%} of {REF_PPM_MEAN}")
    print(f"[main path] ppm pinned {pin}: mean {pmean:.6f} (ref {REF_PPM_MEAN}, "
          f"{100 * (pmean / REF_PPM_MEAN - 1):+.4f}%)")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    pimg = ppm.render_ppm_pass(caustic, PPM_W, PPM_H, PPM_SPP, 7, PPM_PASS, pcfg)
    torch.cuda.synchronize()
    pdt = time.perf_counter() - t0
    plaunch = {"photon_density": dict(pg_ops.launches), "intersect_dense": dict(ops.launches),
               "packed_gather": dict(sg_ops.launches), "intersect_bvh": dict(bvh_ops.launches)}
    print(f"[main path] ppm launches {json.dumps(plaunch)}")
    _require(plaunch["photon_density"]["density"] > 0,
             f"the PPM path did not launch photon_density: {plaunch}")
    _require(plaunch["intersect_dense"]["closest"] > 0 and plaunch["intersect_dense"]["any_hit"] > 0,
             f"the PPM path did not launch intersect_dense for both ray kinds: {plaunch}")
    _require(plaunch["packed_gather"]["gather"] > 0,
             f"the PPM path did not launch packed_gather: {plaunch}")
    _require(bool(torch.isfinite(pimg).all()) and tuple(pimg.shape) == (PPM_H, PPM_W, 3),
             "the bench-config-5 PPM image is not finite or has the wrong shape")
    base5 = pt.specialize_config(caustic, pcfg.base)
    _, ph_rays = ppm.trace_photons(caustic, pcfg.n_photons, 3, base5, with_stats=True)
    rays5 = int(ph_rays) + PPM_W * PPM_H * PPM_SPP
    print(f"[main path] ppm {PPM_W}x{PPM_H} spp {PPM_SPP} {pcfg.n_photons} photons depth "
          f"{pcfg.base.max_depth} pass {PPM_PASS} seed 7: rays {rays5} ({int(ph_rays)} photon + "
          f"{PPM_W * PPM_H * PPM_SPP} camera), {pdt:.4f} s, {rays5 / pdt / 1e6:.3f} Mrays/s, "
          f"mean {float(pimg.mean()):.6f}")

    lap(9)
    # ---- 10. profile ----
    _profile("cornell pass", lambda: pt.render(scene, W, H, SPP, 7, cfg))
    _profile("glossy bench config 2",
             lambda: wf.render_wavefront_counted(glossy, W, H, spp2, 7, gcfg))
    _profile("ppm bench config 5 pass",
             lambda: ppm.render_ppm_pass(caustic, PPM_W, PPM_H, PPM_SPP, 7, PPM_PASS, pcfg))

    lap(10)
    # ---- 11. packed_gather's backward vs its plain version, at three shapes ----
    tex_ids = _capture_texture_ids(scene, cfg)
    bwd = {"pack": _check_gather_bwd("pack", idx_main, pack.shape[0], pack.shape[1], dev),
           "texture": _check_gather_bwd("texture", tex_ids, scene.textures.color_a.shape[0], 3,
                                        dev),
           "woop": _check_gather_bwd("woop", idx_main, glossy.bvh.woop.shape[0], 12, dev)}

    lap(11)
    # ---- 12. gradient gates: pinned JAX gradients, FD vs AD, remat ----
    _grad_gates(scene)

    lap(12)
    # ---- 13. the full-size gradient passes ----
    named = {"intersect_dense": ops.launches, "intersect_bvh": bvh_ops.launches,
             "shade_gather": sg_ops.launches}
    cgrad = _grad_pass("cornell config 1", scene, cfg, ["textures.color_a", "lights.radiance"],
                       named, reset_counts, W, H, SPP, 3)
    _require(cgrad["launches"]["intersect_dense"]["closest"] > 0
             and cgrad["launches"]["intersect_dense"]["any_hit"] > 0,
             f"the Cornell gradient pass did not launch intersect_dense: {cgrad['launches']}")
    gpaths = ["materials.alpha_u", "materials.alpha_v", "textures.color_a"]
    ggrad = _grad_pass("glossy", glossy, gcfg, gpaths, named, reset_counts, W, H, SPP, 3)
    gl = ggrad["launches"]
    _require(gl["intersect_bvh"]["closest"] > 0 and gl["intersect_bvh"]["any_hit"] > 0
             and gl["shade_gather"]["gather"] > 0
             and all(gl["shade_gather"][k] > 0 for k in ("gather_bwd_tile", "gather_bwd_range",
                                                          "gather_bwd_final")),
             f"the glossy gradient pass did not launch its kernels: {gl}")
    g_tex = ggrad["grads"]["textures.color_a"]
    i, c = divmod(int(abs(g_tex).argmax()), g_tex.shape[1])
    ad, h = float(g_tex[i, c]), 1e-2
    fd_vals = []
    for sign in (1.0, -1.0):
        ca = glossy.textures.color_a.clone()
        ca[i, c] += sign * h
        with torch.no_grad():
            fd_vals.append(float(pt.render(glossy._replace(textures=glossy.textures._replace(
                color_a=ca)), W, H, SPP, 3, gcfg).mean()))
    fd = (fd_vals[0] - fd_vals[1]) / (2 * h)
    _require(abs(fd - ad) <= FD_TOL_GLOSSY * abs(fd),
             f"glossy color_a[{i}, {c}]: FD {fd} vs AD {ad}")
    print(f"[grad pass] glossy d/dcolor_a[{i}, {c}] (the largest): FD {fd:.6g}, AD {ad:.6g}, "
          f"{100 * abs(fd - ad) / abs(fd):.3f}% apart (gate {FD_TOL_GLOSSY:.0%})")

    lap(13)
    # ---- 14. inverse rendering: three steps at bench config 1 ----
    with torch.no_grad():
        target = pt.render(cornell_box(), W, H, SPP, 0, cfg)
    start = entry_mod.grey_start()
    params = p0 = (start.textures.color_a, start.lights.radiance)
    steps = []
    for k in range(3):
        step = entry_mod.inverse_step(start, params, target, k + 1, W, H, SPP, cfg)
        params = step.params
        steps.append(float(step.loss))
    with torch.no_grad():
        after = float(entry_mod.inverse_loss(start, params, target, W, H, SPP, 1, cfg))
    _require(steps[0] > steps[1] > steps[2] and after < steps[0],
             f"the inverse-rendering loss did not fall: steps {steps}, after at seed 1 {after}")
    print(f"[inverse] 3 steps at {W}x{H} spp {SPP} depth {DEPTH} from the grey start: losses "
          f"{steps}, after the three at the first step's seed {after:.6g}; radiance "
          f"{p0[1].tolist()} -> {params[1].tolist()}")

    lap(14)
    # ---- 15. bigscene, bench config 3 ----
    sbvh_s = []
    real_native = bvh_mod.build_bvh_native

    def timed_native(*args):
        t0 = time.perf_counter()
        out = real_native(*args)
        sbvh_s.append(time.perf_counter() - t0)
        return out

    bvh_mod.build_bvh_native = timed_native
    try:
        build_s, big = _timed(build_big_scene)
    finally:
        bvh_mod.build_bvh_native = real_native
    _require(big.bvh.woop.device.type == "cuda", "build_big_scene() did not build on the card")
    depth_big = tree_depth(big.bvh.nodes.cpu().numpy(), int(big.bvh.root_code))
    n_tris_big = int(big.bvh.tri_index.max()) + 1
    print(f"[build] bigscene (build_big_scene(), bench config 3): {n_tris_big} triangles, "
          f"{big.bvh.woop.shape[0]} Woop rows (bench.py's n_tris), {big.bvh.nodes.shape[0]} nodes, "
          f"tree depth {depth_big} inner levels (stack {STACK_DEPTH} entries), whole "
          f"build {build_s:.2f} s, of which the host SBVH build {sbvh_s[0]:.2f} s")
    p3 = BIG_PIN
    pin_big = build_big_scene(p3["n_tris"])
    cfg3 = pt.specialize_config(big, pt.PTConfig(max_depth=DEPTH))
    bimg3, brays3 = wf.render_wavefront_counted(pin_big, p3["width"], p3["height"], p3["spp"],
                                                p3["seed"], pt.PTConfig(max_depth=DEPTH))
    bmean3 = float(bimg3.mean())
    _require(bool(torch.isfinite(bimg3).all()), "the pinned bigscene image is not finite")
    _require(abs(bmean3 - REF_BIG_MEAN) <= BIG_TOL * REF_BIG_MEAN,
             f"bigscene pinned mean {bmean3} is not within 1% of {REF_BIG_MEAN}")
    print(f"[main path] bigscene pinned {p3}: mean {bmean3:.9f} (ref {REF_BIG_MEAN}, "
          f"{100 * (bmean3 / REF_BIG_MEAN - 1):+.5f}%), rays {int(brays3)} (ref {REF_BIG_RAYS})")
    wf.render_wavefront_counted(big, BIG_W, BIG_H, BIG_SPP, 0, cfg3)   # warm
    torch.cuda.synchronize()
    reset_counts()
    dt3, (img3, rays3) = _timed(lambda: wf.render_wavefront_counted(big, BIG_W, BIG_H, BIG_SPP,
                                                                     7, cfg3))
    launch3 = {"intersect_bvh": dict(bvh_ops.launches), "packed_gather": dict(sg_ops.launches),
               "intersect_dense": dict(ops.launches)}
    print(f"[main path] bigscene launches {json.dumps(launch3)}")
    _require(launch3["intersect_bvh"]["closest"] > 0 and launch3["intersect_bvh"]["any_hit"] > 0,
             f"the bigscene path did not launch intersect_bvh for both ray kinds: {launch3}")
    _require(bool(torch.isfinite(img3).all()) and tuple(img3.shape) == (BIG_H, BIG_W, 3),
             "the bench-config-3 image is not finite or has the wrong shape")
    print(f"[main path] bigscene {BIG_W}x{BIG_H} spp {BIG_SPP} depth {DEPTH} seed 7: rays "
          f"{int(rays3)}, {dt3:.4f} s, {int(rays3) / dt3 / 1e6:.3f} Mrays/s, mean "
          f"{float(img3.mean()):.6f}")
    # intersect_bvh at the bigscene shape: the pool's first wave of camera rays and its
    # continuing first-bounce rays, against the oracle
    bo, bd_, bstate = wf._camera_ray(big, torch.arange(BIG_CMP_LANES, device=dev), 3, BIG_W,
                                     BIG_H)[1:]
    big_cam = _compare_bvh("bigscene camera rays", big.bvh, bo, bd_, 1e-4, torch.inf, 10)
    b1o, b1d = _first_bounce(big, cfg3, bo, bd_, pt.Sampler(state=bstate))
    big_b1 = _compare_bvh("bigscene first-bounce rays", big.bvh, b1o, b1d, 1e-4, torch.inf, 10)
    overflow_big = big_cam["overflow"] + big_b1["overflow"]
    print(f"[bound] intersect_bvh bigscene camera rays {big_cam['bound'][0]:.5f} ms "
          f"({big_cam['bound'][1]}; kernel at {100 * big_cam['bound'][0] / big_cam['ms']:.2f}% of "
          f"it), first-bounce rays {big_b1['bound'][0]:.5f} ms ({big_b1['bound'][1]}; "
          f"{100 * big_b1['bound'][0] / big_b1['ms']:.2f}%); tree depth {depth_big}, lanes whose "
          f"oracle stack overflowed: {overflow_big}")
    prof3 = _profile("bigscene bench config 3",
                     lambda: wf.render_wavefront_counted(big, BIG_W, BIG_H, BIG_SPP, 7, cfg3))
    del bo, bd_, bstate, b1o, b1d

    lap(15)
    # ---- 16. BDPT, bench config 5's other half ----
    bcfg = bdpt.BDPTConfig()
    bp = BIDIR_PIN
    bd_img, bd_rays = bdpt.render_bdpt_counted(caustic, bp["width"], bp["height"], bp["spp"],
                                               bp["seed"], bcfg)
    bd_mean = float(bd_img.mean())
    _require(bool(torch.isfinite(bd_img).all()), "the pinned BDPT image is not finite")
    _require(abs(bd_mean - REF_BDPT_MEAN) <= BIDIR_TOL * REF_BDPT_MEAN,
             f"pinned BDPT mean {bd_mean} is not within {BIDIR_TOL:.1%} of {REF_BDPT_MEAN}")
    _require(abs(int(bd_rays) - REF_BDPT_RAYS) <= 1e-3 * REF_BDPT_RAYS,
             f"pinned BDPT rays {int(bd_rays)} are not within 0.1% of {REF_BDPT_RAYS}")
    print(f"[main path] bdpt pinned {bp}: mean {bd_mean:.9f} (ref {REF_BDPT_MEAN}, "
          f"{100 * (bd_mean / REF_BDPT_MEAN - 1):+.5f}%), rays {int(bd_rays)} (ref {REF_BDPT_RAYS})")
    bdpt_args, bdpt_gathers, bdpt_splats = _capture_bdpt(caustic, bcfg)
    bdpt_r = {label: _compare(label, c[0], c[1], c[2], c[3], c[4], 20, c[6])
              for label, c in bdpt_args.items()}
    S = bcfg.s_max
    g_eye = _check_gather_at("bdpt eye hits", *bdpt_gathers[2 * S])
    g_lv = _check_gather_at("bdpt light-vertex re-fetch", *bdpt_gathers[S])
    splat_bdpt = _check_splat("bdpt t=1", *bdpt_splats[0], dev)
    torch.cuda.synchronize()
    reset_counts()
    dt5, (img5, rays5) = _timed(lambda: bdpt.render_bdpt_counted(caustic, PPM_W, PPM_H, PPM_SPP,
                                                                  7, bcfg))
    launch5 = {"intersect_dense": dict(ops.launches), "packed_gather": dict(sg_ops.launches),
               "intersect_bvh": dict(bvh_ops.launches)}
    print(f"[main path] bdpt launches {json.dumps(launch5)}")
    _require(launch5["intersect_dense"]["closest"] > 0 and launch5["intersect_dense"]["any_hit"] > 0,
             f"the BDPT path did not launch intersect_dense for both ray kinds: {launch5}")
    _require(launch5["packed_gather"]["gather"] > 0 and launch5["packed_gather"]["gather_bwd_tile"] > 0,
             f"the BDPT path did not launch packed_gather and the splat sum: {launch5}")
    _require(bool(torch.isfinite(img5).all()) and tuple(img5.shape) == (PPM_H, PPM_W, 3),
             "the bench-config-5 BDPT image is not finite or has the wrong shape")
    print(f"[main path] bdpt {PPM_W}x{PPM_H} spp {PPM_SPP} seed 7 (BDPTConfig(): depth "
          f"{bcfg.base.max_depth}, {bcfg.s_max} light vertices): rays {int(rays5)}, {dt5:.4f} s, "
          f"{int(rays5) / dt5 / 1e6:.3f} Mrays/s, mean {float(img5.mean()):.6f}")
    prof5 = _profile("bdpt bench config 5 pass",
                     lambda: bdpt.render_bdpt_counted(caustic, PPM_W, PPM_H, PPM_SPP, 7, bcfg))
    print(f"[splat] scratch of the splat sum: BDPT's {bdpt_splats[0][1].shape[0]} splats onto "
          f"{PPM_W * PPM_H} pixels {sg_ops.bwd_scratch_floats(3, bdpt_splats[0][1].shape[0], PPM_W * PPM_H) * 4} "
          f"bytes; 2^18 light paths x 6 vertices onto 512^2 "
          f"{sg_ops.bwd_scratch_floats(3, 6 << 18, 512 * 512) * 4} bytes")

    lap(16)
    # ---- 17. the light tracer and VCM: pinned renders, then bench size ----
    n_lt_pin = bp["width"] * bp["height"] * bp["spp"]
    lt_pin = light_tracer.render_light_trace(caustic, bp["width"], bp["height"], n_lt_pin,
                                             bp["seed"])
    vcm_pin = vcm.render_vcm(caustic, bp["width"], bp["height"], bp["spp"], bp["seed"],
                             bp["pass_idx"])
    for label, img_p, ref in (("light tracer", lt_pin, REF_LT_MEAN), ("vcm", vcm_pin, REF_VCM_MEAN)):
        m = float(img_p.mean())
        _require(bool(torch.isfinite(img_p).all()), f"the pinned {label} image is not finite")
        _require(abs(m - ref) <= BIDIR_TOL * ref,
                 f"pinned {label} mean {m} is not within {BIDIR_TOL:.1%} of {ref}")
        print(f"[main path] {label} pinned {bp}: mean {m:.9f} (ref {ref}, "
              f"{100 * (m / ref - 1):+.5f}%)")
    n_lt = PPM_W * PPM_H * PPM_SPP
    lt_splats = _capture_splats(lambda: light_tracer.render_light_trace(caustic, PPM_W, PPM_H,
                                                                        n_lt, 0))
    splat_lt = _check_splat("light tracer", *lt_splats[0], dev)
    reset_counts()
    dt_lt, img_lt = _timed(lambda: light_tracer.render_light_trace(caustic, PPM_W, PPM_H, n_lt, 7))
    launch_lt = {"intersect_dense": dict(ops.launches), "packed_gather": dict(sg_ops.launches)}
    _require(launch_lt["packed_gather"]["gather_bwd_tile"] == 1
             and launch_lt["intersect_dense"]["any_hit"] > 0,
             f"the light tracer did not launch its kernels: {launch_lt}")
    vcm.render_vcm(caustic, PPM_W, PPM_H, PPM_SPP, 0, 1)   # warm
    reset_counts()
    dt_vcm, img_vcm = _timed(lambda: vcm.render_vcm(caustic, PPM_W, PPM_H, PPM_SPP, 7, 1))
    launch_vcm = {"intersect_dense": dict(ops.launches), "packed_gather": dict(sg_ops.launches)}
    _require(launch_vcm["packed_gather"]["gather_bwd_tile"] == 1
             and launch_vcm["intersect_dense"]["closest"] > 0,
             f"VCM did not launch its kernels: {launch_vcm}")
    # not gated: the same pass with the merge's neighbour cap lifted (JAX's is 32), to show how
    # much light the cap drops at this size
    img_vcm_k = vcm.render_vcm(caustic, PPM_W, PPM_H, PPM_SPP, 7, 1,
                               vcm.VCMConfig(max_gather=VCM_OPEN_CAP))
    for label, img_b in (("light tracer", img_lt), ("vcm", img_vcm)):
        _require(bool(torch.isfinite(img_b).all()) and tuple(img_b.shape) == (PPM_H, PPM_W, 3),
                 f"the bench-size {label} image is not finite or has the wrong shape")
    print(f"[main path] light tracer {PPM_W}x{PPM_H}, {n_lt} paths, depth "
          f"{pt.PTConfig().max_depth}, seed 7: {dt_lt:.4f} s, mean {float(img_lt.mean()):.6f}; "
          f"launches {json.dumps(launch_lt)}")
    print(f"[main path] vcm {PPM_W}x{PPM_H} spp {PPM_SPP} pass 1 seed 7 (VCMConfig()): "
          f"{dt_vcm:.4f} s, mean {float(img_vcm.mean()):.6f}; launches {json.dumps(launch_vcm)}; "
          f"the same pass with max_gather {VCM_OPEN_CAP} (not gated): mean "
          f"{float(img_vcm_k.mean()):.6f}")

    lap(17)
    # ---- 18. bench config 4: the heterogeneous volume ----
    vol = _volume_phase(scene, smi, reset_counts)
    vol_r, launch_v, prof_v = vol["compare"], vol["launches"], vol["profile"]
    lap(18)

    # ---- 19. bench config 4's transmittance gradients ----
    vg = _volume_grad_phase(scene, smi, reset_counts)
    lap(19)

    # ---- 20. SPPM: pinned runs, the caustic scene and the plume at full size ----
    sp = _sppm_phase(scene, caustic, smi, reset_counts)
    lap(20)

    # ---- 21. closed-form surface shading: BSDFs, cameras, filters, regularization, lights ----
    sh = _shading_phase(scene, caustic, smi, reset_counts)
    lap(21)
    print(f"[wall] chip_smoke.py phases 1-21: {time.perf_counter() - t_start:.1f} s after the "
          f"imports")
    sh_launch = {k: r["launches"] for k, r in sh["runs"].items()}
    sh_dense = sum(v["intersect_dense"]["closest"] + v["intersect_dense"]["any_hit"]
                   for v in sh_launch.values())
    sp_c, sp_v = sp["runs"]["caustic"], sp["runs"]["plume beambeam"]
    vgl = vg["launches"]

    print(json.dumps({"kernels": [
        {
            "name": "intersect_dense",
            "route": "cuda",
            "source": "cudatracerlib_tpu_torch/csrc/intersect_dense.cu",
            "replaces": "cudatracerlib_tpu/ops/intersect_pallas.py:89",
            "launches": launches["closest"] + launches["any_hit"],
            "max_abs_err": max(dense_err, *(r["err"] for r in (
                *bdpt_r.values(), *vol_r.values(), *vg["dense"].values(),
                *sp_c["dense"].values(), *sp_v["dense"].values(), *sh["dense"].values()))),
            "ms": cam["ms"],
            "plain_ms": cam["plain_ms"],
            "bound_ms": cam["bound"][0],
            "bound_by": cam["bound"][1],
            "library_ms": None,
            "wrapper_ms": cam["wrap_ms"],
            "ppm_launches": plaunch["intersect_dense"]["closest"]
            + plaunch["intersect_dense"]["any_hit"],
            "ppm_ms": ppm_r["ppm photon rays"]["ms"],
            "ppm_plain_ms": ppm_r["ppm photon rays"]["plain_ms"],
            "ppm_bound_ms": ppm_r["ppm photon rays"]["bound"][0],
            "ppm_bound_by": ppm_r["ppm photon rays"]["bound"][1],
            "bdpt_launches": launch5["intersect_dense"]["closest"]
            + launch5["intersect_dense"]["any_hit"],
            "bdpt_max_abs_err": max(r["err"] for r in bdpt_r.values()),
            **{f"bdpt_{k.split()[1]}_{f}": (r[v][0] if v == "bound" else r[v])
               for k, r in bdpt_r.items()
               for f, v in (("ms", "ms"), ("plain_ms", "plain_ms"), ("bound_ms", "bound"))},
            "volume_launches": launch_v["closest"] + launch_v["any_hit"],
            "volume_max_abs_err": max(r["err"] for r in vol_r.values()),
            **{f"volume_{k.split()[1].split('-')[0]}_{f}": (r[v][0] if v == "bound" else r[v])
               for k, r in vol_r.items()
               for f, v in (("ms", "ms"), ("plain_ms", "plain_ms"), ("bound_ms", "bound"))},
            "volume_idle": prof_v["idle"],
            "vgrad_launches": vgl["intersect_dense"]["closest"] + vgl["intersect_dense"]["any_hit"],
            "vgrad_max_abs_err": max(r["err"] for r in vg["dense"].values()),
            **{f"vgrad_{k.split()[1].split('-')[0]}_{f}": (r[v][0] if v == "bound" else r[v])
               for k, r in vg["dense"].items()
               for f, v in (("ms", "ms"), ("plain_ms", "plain_ms"), ("bound_ms", "bound"))},
            "sppm_caustic_launches": sp_c["launches"]["intersect_dense"]["closest"]
            + sp_c["launches"]["intersect_dense"]["any_hit"],
            "sppm_plume_launches": sp_v["launches"]["intersect_dense"]["closest"]
            + sp_v["launches"]["intersect_dense"]["any_hit"],
            "sppm_max_abs_err": max(r["err"] for run in (sp_c, sp_v) for r in run["dense"].values()),
            **{f"sppm_{label.split()[0]}_{k.split()[-2]}_{f}": (r[v][0] if v == "bound" else r[v])
               for label, run in sp["runs"].items() for k, r in run["dense"].items()
               for f, v in (("ms", "ms"), ("plain_ms", "plain_ms"), ("bound_ms", "bound"))},
            "shading_launches": sh_dense,
            **{f"furnace_{k.split()[1].split('-')[0]}_{f}": (r[v][0] if v == "bound" else r[v])
               for k, r in sh["dense"].items()
               for f, v in (("ms", "ms"), ("plain_ms", "plain_ms"), ("bound_ms", "bound"))},
        },
        {
            "name": "intersect_bvh",
            "route": "cuda",
            "source": "cudatracerlib_tpu_torch/csrc/intersect_bvh.cu",
            "replaces": "cudatracerlib_tpu/ops/cluster_trace.py:411",
            "launches": glaunch["intersect_bvh"]["closest"] + glaunch["intersect_bvh"]["any_hit"],
            "max_abs_err": max(err_g, err_g1, err_s65, big_cam["err"], big_b1["err"]),
            "ms": ms_bvh,
            "plain_ms": plain_ms_bvh,
            "bound_ms": bvh_bound[0],
            "bound_by": bvh_bound[1],
            "library_ms": None,
            "bigscene_launches": launch3["intersect_bvh"]["closest"]
            + launch3["intersect_bvh"]["any_hit"],
            "bigscene_rows": int(big.bvh.woop.shape[0]),
            "bigscene_tree_depth": depth_big,
            "bigscene_stack_overflow_lanes": overflow_big,
            **{f"bigscene_{k}_{f}": (r[v][0] if v == "bound" else r[v])
               for k, r in (("camera", big_cam), ("bounce", big_b1))
               for f, v in (("ms", "ms"), ("wrapper_ms", "wrap_ms"), ("plain_ms", "plain_ms"),
                            ("bound_ms", "bound"))},
            "bigscene_bound_by": big_cam["bound"][1],
        },
        {
            "name": "packed_gather",
            "route": "cuda",
            "source": "cudatracerlib_tpu_torch/csrc/shade_gather.cu",
            "replaces": "cudatracerlib_tpu/ops/shade_gather.py:69",
            "launches": glaunch["packed_gather"]["gather"],
            "max_abs_err": max(gather_err, sp_c["gather"]["err"], sh["gather"]["err"]),
            "ms": ms_g,
            "plain_ms": plain_ms_g,
            "bound_ms": gather_bound[0],
            "bound_by": gather_bound[1],
            "library_ms": lib_ms_g,
            "bdpt_launches": launch5["packed_gather"]["gather"],
            **{f"bdpt_{k}_{f}": (r[v][0] if v == "bound" else r[v])
               for k, r in (("eye", g_eye), ("vertex", g_lv))
               for f, v in (("ms", "ms"), ("plain_ms", "plain_ms"), ("library_ms", "lib_ms"),
                            ("bound_ms", "bound"))},
            "furnace_max_abs_err": sh["gather"]["err"],
            "shading_launches": sum(v["shade_gather"]["gather"] for v in sh_launch.values()),
            **{f"furnace_{f}": (sh["gather"][v][0] if v == "bound" else sh["gather"][v])
               for f, v in (("ms", "ms"), ("plain_ms", "plain_ms"), ("library_ms", "lib_ms"),
                            ("bound_ms", "bound"))},
            "sppm_launches": sp_c["launches"]["packed_gather"]["gather"],
            **{f"sppm_{f}": (sp_c["gather"][v][0] if v == "bound" else sp_c["gather"][v])
               for f, v in (("ms", "ms"), ("plain_ms", "plain_ms"), ("library_ms", "lib_ms"),
                            ("bound_ms", "bound"))},
        },
        {
            "name": "packed_gather_bwd",
            "route": "cuda",
            "source": "cudatracerlib_tpu_torch/csrc/shade_gather_bwd.cu",
            "replaces": "cudatracerlib_tpu/ops/shade_gather.py:127",
            "launches": gl["shade_gather"]["gather_bwd_tile"],
            "max_abs_err": max(*(b["err"] for b in bwd.values()), splat_bdpt["err"],
                               splat_lt["err"], vg["grid"]["err"], vg["table"]["err"],
                               sh["splat"]["err"]),
            "ms": bwd["pack"]["ms"],
            "plain_ms": bwd["pack"]["plain_ms"],
            "bound_ms": bwd["pack"]["bound"][0],
            "bound_by": bwd["pack"]["bound"][1],
            "library_ms": bwd["pack"]["lib_ms"],
            "wrapper_ms": bwd["pack"]["wrap_ms"],
            "max_rel_err": max(*(b["rel"] for b in bwd.values()), vg["grid"]["rel"],
                               vg["table"]["rel"]),
            "range_launches": gl["shade_gather"]["gather_bwd_range"],
            "final_launches": gl["shade_gather"]["gather_bwd_final"],
            "cornell_launches": cgrad["launches"]["shade_gather"]["gather_bwd_tile"],
            **{f"{k}_{f}": bwd[k][v] for k in ("texture", "woop")
               for f, v in (("ms", "ms"), ("wrapper_ms", "wrap_ms"), ("plain_ms", "plain_ms"),
                            ("library_ms", "lib_ms"))},
            **{f"{k}_bound_ms": bwd[k]["bound"][0] for k in ("texture", "woop")},
            "splat_launches": launch5["packed_gather"]["gather_bwd_tile"],
            "splat_max_abs_err": max(splat_bdpt["err"], splat_lt["err"]),
            "splat_max_rel_err": max(splat_bdpt["rel"], splat_lt["rel"]),
            **{f"{k}_splat_{f}": (r[v][0] if v == "bound" else r[v])
               for k, r in (("bdpt", splat_bdpt), ("lt", splat_lt))
               for f, v in (("ms", "ms"), ("wrapper_ms", "wrap_ms"), ("plain_ms", "plain_ms"),
                            ("library_ms", "lib_ms"), ("bound_ms", "bound"))},
            "lt_splat_launches": launch_lt["packed_gather"]["gather_bwd_tile"],
            "filter_splat_launches": sh_launch["cornell gaussian"]["shade_gather"]["gather_bwd_tile"],
            "shading_splat_launches": sum(v["shade_gather"]["gather_bwd_tile"]
                                          for v in sh_launch.values()),
            **{f"filter_splat_{f}": (sh["splat"][v][0] if v == "bound" else sh["splat"][v])
               for f, v in (("ms", "ms"), ("wrapper_ms", "wrap_ms"), ("plain_ms", "plain_ms"),
                            ("library_ms", "lib_ms"), ("bound_ms", "bound"),
                            ("max_abs_err", "err"), ("max_rel_err", "rel"),
                            ("scratch_bytes", "scratch"), ("per_tap_calls_ms", "per_tap_ms"))},
            "grid_launches": vgl["shade_gather"]["gather_bwd_tile"],
            **{f"{k}_{f}": (vg[k][v][0] if v == "bound" else vg[k][v])
               for k in ("grid", "table")
               for f, v in (("lanes", "lanes"), ("rows", "rows"), ("ms", "ms"),
                            ("wrapper_ms", "wrap_ms"), ("plain_ms", "plain_ms"),
                            ("library_ms", "lib_ms"), ("bound_ms", "bound"),
                            ("max_abs_err", "err"), ("max_rel_err", "rel"),
                            ("captured_rel_err", "captured_rel"), ("scratch_bytes", "scratch"),
                            ("mask_bytes", "masks"))},
        },
        {
            "name": "photon_density",
            "route": "cuda",
            "source": "cudatracerlib_tpu_torch/csrc/photon_gather.cu",
            "replaces": "cudatracerlib_tpu/ops/photon_gather.py:164",
            "launches": plaunch["photon_density"]["density"],
            "max_abs_err": dens_err,
            "ms": pd_ms["global map"]["ms"],
            "plain_ms": plain_ms_pd,
            "bound_ms": pd_bound[0],
            "bound_by": pd_bound[1],
            "library_ms": None,
            "wrapper_ms": pd_ms["global map"]["wrap_ms"],
            "reduce_launches": plaunch["photon_density"]["density_reduce"],
            "caustic_ms": pd_ms["caustic map"]["ms"],
            "caustic_bound_ms": work["caustic map"]["bound"][0],
        },
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
