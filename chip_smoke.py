#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments: `python3 chip_smoke.py`.
It imports nothing of JAX. Phases, each of which raises on failure:

  1. device: the card's name and power limit (nvidia-smi), the device count;
  2. build: the six CUDA sources (nvcc, sm_90a, one process per source,
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
     counts every box test, FLOPS_WOOP_T for each row of the chunks each
     ray's box test passes at its final t (`cull_sweep`, the plain cull
     emulation), FLOPS_EDGE for each of those rows whose t lies below the
     ray's final t (each is edge-tested) and FLOPS_UV for each hit; the
     all-rows figure of the old sweep is printed beside it; the bytes are
     each ray's once and each row's 48 Woop bytes and 36 vertex bytes once.
     Every dense comparison also counts the rays the watertight test decides
     otherwise than the Woop test's own u, v (`woop_decision` of
     tools/crack_cases.py). As a yardstick, not gated, `intersect_bvh` is
     timed on the PPM rays over the caustic BVH;
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
     (both kinds of `intersect_dense`; the transmittance kernel's printed),
     the first pass's trip counts printed, one pass profiled as in 10; then
     one pass of the plume render cell (1024x1024, 2 spp, depth 6, seed 7:
     2,097,152 lanes a call), whose launches of the transmittance kernel
     must read 2 a bounce and its eager path's count 0, with each call's
     inputs captured and the kernel's factor and step sum held bit-equal to
     its plain version (the eager path's arithmetic); the first bounce's
     sampled segment and shadow rays timed, kernel and plain version, against
     the bound (TR_FLOPS, TR_BYTES a lane), and the kernel's sum over the pass;
     then the tracking kernel (ops/delta_track) on the inputs of that pass's
     6 tracking calls (2,097,152 lanes) and of a 256x256, 8-spp pass's
     (524,288, the grad cell's): 6 launches a pass and no eager loop, t
     bit-equal, real and T equal to the eager loop's on every call, the first
     bounce's call timed, kernel and eager loop, against the bound
     (TRACK_TRIP_OPS a lane-trip, TRACK_LANE_OPS and TRACK_BYTES a lane), and
     the kernel's sum over the pass;
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
     both kinds of intersect_dense, the three gather-backward kernels and
     the transmittance pair, 2 a bounce each),
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
     index_add_, the scratch and its row lists' share; the same at a
     per-volume table's shape (sigma_a[vid], captured in a gradient of
     per-channel grids, 64x64, 4 spp). (d) the transmittance kernels on the
     captured calls of a forward at (b)'s size (524,288 lanes a call), as
     in 18, and the first bounce's two calls' backward on a seeded
     cotangent: two calls bit-equal, the grid's and st's gradients within
     1e-5 of the plain closed form's largest entry, the backward kernel
     alone and the whole backward (with the gather backward) timed against
     the bound (TR_BWD_FLOPS, TR_BWD_BYTES a lane);
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
     shade-pack gather launched; intersect_dense's camera and shadow rays
     (a convex sphere's first bounce hits nothing) and the pack gather of
     the PLASTIC pass held to their plain versions as in 3 and 6; (b) the Cornell box through THINLENS,
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
     light, and the light tracer on the constant-environment furnace;
  22. multi-device (parallel/): this process joins a one-rank NCCL group and
     runs, each warm first (the kernels' arguments captured and held to
     their plain versions as in 3, 6, 8 and 11), then once with the launch
     counts reset just before and read just after: (a) make_sharded_render
     at bench config 1's size (mean within 0.5% and rays within 1e-3 of the
     JAX package's one-device make_sharded_render, seed 3), its pass wall
     beside render_progressive's one pass (alternating pairs) and the film
     all-reduce's own time; (c) make_train_step at the inverse-rendering
     example's size (64x64, 8 spp, depth 4): the loss within 1e-3 and each
     parameter's update within 1e-2 (plus 1e-2 of the largest) of JAX's, the
     gather backward launched; (d) make_sharded_ppm pinned at PPM_PIN's size
     (within 0.1% of JAX's exhaustive mean), then at bench config 5's size
     with its seed spread over 4 seeds, its pass wall beside
     render_ppm_pass's and the photon all-gather's own time. Then two gloo
     ranks spawned on the same card run (b) the render of (a): rays equal to
     (a)'s, every pixel within 1e-4 relative + 1e-6; (c) the train step:
     loss within 1e-5 relative, updates within 1e-3 of one rank's; (d) the
     PPM pass at bench size: finite, within three times the seed spread of
     one rank's mean; each with its launches, and the collectives' times;
  23. textures and material maps, the subsurface walk and cornell_box_deluxe
     (pins from tools/texture_reference_mean.py, 64x64, 4 spp, seed 3): (a)
     deluxe (1,428 Woop rows, the shade pack on; its back wall normal-mapped
     by an IMAGE texture) at bench config 1's size, its pin within 0.5% and
     its rays within 1e-3, a counted pass at seed 3, 5 passes through
     `render_progressive` timed with the launch counts reset just before and
     read just after (both kinds of intersect_dense and packed_gather), one
     pass profiled; (b) deluxe through `render_wavefront_counted`, its pin
     within 1%, one 256x256, 16-spp render timed; (c) tools/texture_cases.py's
     maps case (an IMAGE albedo trilinear through the ray cone, a height map
     with parallax, an alpha-tested quad; three atlas layers), its pin within
     0.5%, one pass timed; (d) tests/test_sss.py's Marble sphere at 256x256,
     16 spp, depth 8, 24 walk steps, its pin within three times JAX's seed
     spread, one pass timed, whose closest-hit launches must be depth x (1 +
     walk steps); (e) the gradients of deluxe (textures.atlas,
     textures.color_a) and of the sphere (materials.sss_sigma_s) at 64x64
     within 1e-3 of tools/texture_grad_reference.npz's, then each at full
     size (the sphere at 128x128, with remat), forward and forward+backward
     walls in 2 alternating pairs, peak memory and the launches of one
     forward+backward; (f) intersect_dense on deluxe's camera, first-bounce
     and shadow rays and the deluxe pack gather held to their plain versions
     as in 3 and 6, and the gather backward at the atlas shape (2^20 x 3
     lanes of one (level, corner) fetch onto 87,381 rows, captured in a
     deluxe gradient pass) as in 19 (c);
  24. dynamic and instanced scenes (tools/dynamic_cases.py; pins from
     tools/dynamic_reference_mean.py at 64x64, seed 3): (a) the instanced
     `_build(8)` scene (3 meshes, 10 instances, the dense band), its pin
     within 0.5% and rays within 1e-3; its 2^20 camera rays instanced
     against flattened (valid equal and t within 2e-4 on >= 99.9% of them,
     rays through the Woop test's cracks counted against the share; the
     launches of a bounce); intersect_dense held to its plain version as in
     3 on one instance's captured per-lane ranges; 5 passes at bench config
     1's size through `render_progressive`, instanced and flattened, means
     within 1% of each other, launches counted, one pass of each profiled;
     (b) the 300-instance forest: the camera rays as in (a), one 256x256,
     16-spp pass each way (the flattened one in the shade pack's band, its
     gather held bit-equal as in 6); (c) a 16,128-triangle sphere instanced
     16 times (a BLAS above the dense band): as (b), and intersect_bvh held
     to its oracle as in 5 on one instance's captured per-lane ranges, with
     their empty share; (d) two skinned spheres (2,162 and 16,002 Woop
     triangles with the floor), each with its pin at pose 2, then 8 poses
     of skin -> refit -> one 256x256, 16-spp pass (the refit timed alone);
     the refitted tree's camera-ray hits against a rebuilt tree's (a fresh
     SBVH over the posed triangles carrying the same closed-form rows, so
     only the nodes differ) as in 3 / 5; the dense kernel on the refitted chunk boxes as in 3, the BVH kernel
     on the refitted tree as in 5 with its node visits and time beside the
     rebuilt tree's; the pose gradient of the 10 x 20 sphere within 1e-3 of
     JAX's, then a full-size gradient pass on the sphere above the dense
     band (and the shade pack's) whose gather backward calls at the Woop
     (2^20 x 12) and verts (2^20 x 9) shapes are held to their float64
     plain sums as in 19 (c); (e) the adaptive pins
     (Cornell 0.5%, glossy 1%), then `render_adaptive_host` on the Cornell
     box at bench config 1's size (5 passes, warmup 1) and
     `render_wavefront_adaptive` on the glossy scene at 256x256, 16 spp, 5
     waves, each timed with its launches (the glossy waves launch
     intersect_bvh and packed_gather); (f) `render_with_counters` at config
     1 and `render_wavefront_with_counters` at config 2: n_nonfinite 0,
     n_rays equal to render_counted's / render_wavefront_counted's at the
     same seed;
  25. the remaining engines (tools/engines_cases.py; pins from
     tools/engines_reference_mean.py): (a) spectral surfaces: the Cornell
     and dispersive caustic pins (64x64, 4 spp, seed 3) within 0.5%, then
     `render_spectral` at bench config 1's size (256x256, 16 spp, depth 5)
     on Cornell, the achromatic and the dispersive (cauchy_c 0.03) caustic
     scene, each timed with its ray lanes (every lane given to the
     intersect wrappers) and launches; red and blue separate on the
     dispersive image (tests/test_spectral.py's chroma, > 1.35x the
     achromatic); the guarded gate's stopped lanes counted; intersect_dense
     held to its plain version as in 3 on the dispersive pass's camera and
     shadow rays; (b) the spectral gradients: d mean / d light radiance and
     d (ramp-weighted mean) / d cauchy_c within 1e-3 of JAX's, the spectral
     volume's d / d sigma_s scale against its central difference at JAX's
     gate (0.35), and the cauchy gradient at 256x256, 4 spp: forward and
     forward+backward walls (medians of 3 pairs), peak memory, the launches
     of one forward+backward; (c) the spectral volume (a homogeneous medium
     in the Cornell box) pinned within three seed spreads, then at bench
     config 4's size (256x256, 8 spp, depth 6); (d) guiding on the caustic
     scene: the pinned histogram's sum within 1e-5 and image within 0.5%,
     then `make_guiding(res=8)`, 4 `train_guiding` batches of 2^17 photons
     (each timed) and `render_guided` at 256x256, 16 spp; over 4 such passes
     its 4x4 block means within 0.1 of 4 path-traced passes' (tests/
     test_guided.py's gate and protocol; a second path-traced set's gap
     printed as the noise floor); the
     deposit's row sum (2^17 x 5 lanes x 1 onto 32,768 rows, captured) held
     to its float64 plain version as in 19 (c), and the pack gather
     bit-equal as in 6; (e) `render_fast` on the bigscene at 1024x1024 (one
     `intersect_bvh` launch of 2^20 rays): best of 5 passes in Mrays/s, the
     kernel alone, image and depth against the plain route (the oracle in
     the intersector's place; at most 16 pixels apart, coincident ties),
     the bound from the oracle's visits; (f) `render_game`: the pin (64x64,
     frame 7) within 0.5%, then 8 frames of Cornell at 256x256 with the hash
     grid's build and query timed; (g) `render_aovs` on Cornell at 256x256:
     each of the 17 channels' means within AOV_TOL of JAX's (pixel-centre
     rays on a quad's diagonal cross JAX's Woop test's crack, which the
     port's watertight test closes); (c)-(g) each profiled once; (h)
     `generate_fits` on the card over the full grid (5,878,656 lanes at eta
     and at 1/eta): the fitted surfaces within 2e-3 of the baked
     coefficients' (JAX's test_baked_constants_match_regeneration gate) and
     the residuals beside FIT_RESIDUAL, timed;
  26. the watertight test, scene files and the entry points
     (tools/crack_cases.py, tools/io_cases.py; pins from
     tools/io_reference_mean.py): (a) Cornell's 256x256 pixel-centre rays
     (as render_aovs makes them) through intersect_dense and through
     intersect_bvh over the same rows, each bit-equal to its plain version,
     none through a wall (a miss that a float64 test tolerant by 1e-6 in
     the barycentrics hits), the rays the Woop decision loses there
     counted; 64 random quads x 32 rays aimed at their shared diagonals at
     three scales, through both kernels: every ray hits its own quad; rows
     1-2's times at the main-path shapes of phases 3, 5 and 15 and the AOV
     deviation of 25 (g) printed; (b) bench config 3's scene
     (`_big_geometry`, the area light, the camera) written as binary PLY and
     as `.serialized` files (one shape a material) with a Mitsuba XML each,
     loaded on the card through `load_mitsuba` (each write and load timed),
     the loaded triangles and materials held to the written ones and every
     difference from `build_big_scene`'s arrays listed (the light's two
     triangles are geometry in the file, so BSDF-sampled paths reach it);
     one pass at config 3's settings (512x512, 16 spp, depth 5, seed 7,
     the wavefront engine) within BIG_TOL of phase 15's pass, its launches
     counted; the OBJ loader at BIG_PIN's size (pure-Python parsing), timed;
     (c) the media-and-maps XML (a coating nested over a diffuse sphere, a
     PNG bump map, the sunsky, a heterogeneous `.vol` medium inside an
     index-matched dielectric box) loaded on the card, `render` and
     `render_vol` (64x64, 4 spp, seed 3) within IO_PINS of JAX's CPU means;
     (d) as subprocesses, in parallel: `python -m cudatracerlib_tpu_torch.cli
     cornell 2 PT --size 256 --spp 16` and the (b) XML with `fast` (exit 0, a
     PNG, pass times printed), `--checkpoint` 2 passes resumed to 4 against
     a straight 4 (bit-equal), and `examples/inverse_rendering_torch.py
     --steps 5` (its loss falling);
  27. the math utilities and debug visualizers, each part held to the CPU
     port on a 4,096-lane slice and timed: (a) on UTIL_LANES (2^20) lanes,
     the Catmull-Rom splines (`eval_1d` / `eval_2d` / `eval_3d` of smooth
     tables, `integrate_1d`, and `sample_1d`, whose histogram must follow
     `eval_1d / total`: chi^2 under 2 per bin), `quadrature.integrate` of a
     per-lane exp(-a x) sin(b x) within 1e-5 of its closed form, the three
     compression round trips within the JAX package's own test bounds (codes
     may differ from the CPU port's by one quantization step, on a printed
     count of lanes), and a 1024^2 image of merging models (capacity 16, 64
     inserts each; knots equal to the CPU port's); (b) `hashgrid.query_reduce`
     with `kernels.density_weight(EPANECHNIKOV, d=2)` over bench config 5's
     global photon map (captured in a warm seed-0 pass) at its 65,536 eye
     queries, `max_neighbors` the largest 27-cell candidate count (printed, so
     no query is capped), in chunks of at most UTIL_PAYLOAD_BYTES of
     payload, against `photon_density` on the same queries: Sum w and flux
     within DENSITY_RTOL (+ DENSITY_ATOL of the largest) per query, and
     `normalization(EPANECHNIKOV, 2)` within 1e-6 of 2/pi; (c) `render_aovs`
     of Cornell at 256x256, then `visualize_scalar(depth)`,
     `visualize_vec3(normal)`, `overlay` and `draw_vector_field` (stride 8):
     finite, within [0, 1], and equal to the CPU port's on the same buffers.
     Each part prints a PASS line and its wall.
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
TR_RENDER = (1024, 1024, 2)  # the plume render cell's pass (2,097,152 lanes a call)
# The transmittance kernels' work a lane (csrc/transmittance.cu). Forward: 24 float operations
# for the ray-box clip (3 axes x a division, 2 differences, 2 products, 3 min / max), 58 a step
# (its t 2, the point 6, the grid coordinate 21, 7 lerps 28, the sum 1), 7 for tau and exp; o, d,
# t_max in (28 bytes), the factor out (12). Backward: the clip, 8 for tau's and st's cotangents,
# 56 a step (the point and coordinate 29, 3 complements, 8 corners x 3 products); the rays, the
# cotangent, the factor and acc in (56 bytes), st's share and 32 x 8 cotangents and rows out.
TR_FLOPS, TR_BYTES = 24 + 32 * 58 + 7, 28 + 12
TR_BWD_FLOPS, TR_BWD_BYTES = 24 + 8 + 32 * 56, 56 + 12 + 32 * 8 * 8
# The tracking kernel's work (csrc/delta_track.cu), one 'scalar' volume. A trip: two draws of 14
# (the Weyl step, the hash's 11 integer operations, the conversion and scale), 7 for dt, t_new and
# the escape test, the point 6, the box test 7, the cell's coordinates 39 (13 an axis) and corner
# rows 40 (5 a corner), 7 lerps 28, sigma_t 6, the mean, ratio and test 7, the count 2: 170. A
# lane: 10 to start and end its trips; o, d, u_near, u_far, maj, in_vol and state in (45 bytes),
# t and real out (5). The operations are counted over the lane-trips the inputs need (the sum of
# each lane's trips), not T x lanes.
TRACK_TRIP_OPS, TRACK_LANE_OPS, TRACK_BYTES = 2 * 14 + 7 + 6 + 7 + 39 + 40 + 28 + 6 + 7 + 2, 10, 50
TRACK_GRAD = (256, 256, 8)  # the grad cell's pass (524,288 lanes a call)
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
# Phase 22's pins, JAX package on the CPU, each on a one-device mesh as the card's one-rank runs
# are (`JAX_PLATFORMS=cpu python tools/sharded_reference_mean.py`):
#   make_sharded_render(cornell_box()) at bench config 1's size (256x256, 16 spp, depth 5, seed 3,
#   the config specialized as bench.py runs it) -> mean and rays; gates 0.5% (as phase 4's) and
#   1e-3;
#   make_train_step at examples/inverse_rendering.py's size (64x64, 8 spp, depth 4, rr_start 99,
#   lr 0.05; target `render` of the Cornell box at seed 0, start the grey walls and dim light, one
#   step at seed 1) -> the loss (within 1e-3) and each parameter's update, -lr times the summed
#   gradient, which pins the gradient's scale: within 1e-2 relative plus 1e-2 of the largest, as
#   the update is a difference of parameters near 0.5 (float32 rounding alone is 2.2e-4 of the
#   largest color_a update; a gradient scaled by the rank count misses by 100%);
#   make_sharded_ppm at PPM_PIN's size with every photon within the radius summed, as the card's
#   kernel does (the neighbour cap lifted on a grid whose cells cover the radius; JAX's own CPU
#   pass reads 0.309156656 with its 128-neighbour cap, 0.326323867 uncapped at grid_res 64, whose
#   cells are lower than the radius): within 0.1%, as the unsharded pin (REF_PPM_MEAN).
REF_SHARD_MEAN, REF_SHARD_RAYS = 0.132556751, 5_709_883
REF_SHARD_LOSS = 0.391012639
REF_SHARD_UPDATE_COLOR_A = [[2.74121761e-04, 1.54256821e-04, -1.50203705e-05],
                            [7.23600388e-05, 4.70876694e-06, -1.40964985e-05],
                            [3.14116478e-05, 3.53455544e-05, -1.51693821e-05],
                            [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]]
REF_SHARD_UPDATE_RADIANCE = [[0.002178669, 0.001265049, -0.000191689]]
REF_SHARD_PPM_MEAN = 0.326836854
SHARD_TOL, SHARD_RAYS_TOL, SHARD_LOSS_RTOL, SHARD_UPDATE_RTOL = 0.005, 1e-3, 1e-3, 1e-2
SHARD_SEED = 3
SHARD_TRAIN = dict(width=64, height=64, spp=8, max_depth=4, rr_start=99, lr=0.05, target_seed=0,
                   seed=1)
# across rank counts on the card: the same lanes, so only the film's float32 sums (index_add_'s
# atomics) and the gradient's summation order differ
SHARD_IMG_RTOL, SHARD_IMG_ATOL = 1e-4, 1e-6
SHARD_CROSS_LOSS_RTOL, SHARD_CROSS_UPDATE_RTOL = 1e-5, 1e-3
SHARD_PPM_SEEDS = (7, 8, 9, 10)   # the one-rank bench-size pass's seed spread (d)
SHARD_PAIRS = 5            # phase 22: alternating sharded / unsharded pass walls
SHARD_RANKS = 2            # phase 22 (b)-(d): gloo ranks sharing the card
SHARD_RANK_TIMEOUT_S = 600.0
# Phase 23's pins, the JAX package on the CPU at 64x64, 4 spp (`JAX_PLATFORMS=cpu python
# tools/texture_reference_mean.py`): cornell_box_deluxe through render_counted (seed 3, depth 5;
# gate 0.5%, as phase 4's) and render_wavefront_counted (gate 1%, as the glossy pin's), the maps
# case of tools/texture_cases.py (seed 3, depth 5; 0.5%), each with its rays (within 1e-3); the
# Marble sphere of tests/test_sss.py (depth 8, rr_start 99, 24 walk steps) at seed 3, gated at
# three times the spread of JAX's means over seeds 3-5 (a walk decision an ulp flips draws that
# lane's walk anew). The CPU port (`--port`) gives deluxe's mean and rays exactly, the wavefront's
# within 5e-7 and 2 rays, the maps case's within 1.7e-5.
TEXTURE_PINS = {"deluxe": (0.116040580, 89_172, 0.005), "deluxe_wf": (0.116319418, 89_192, 0.01),
                "maps": (0.124433614, 89_269, 0.005)}
REF_SSS_MEAN = 0.805994451
REF_SSS_SPREAD = 0.034776     # (max - min) / seed-3 mean over seeds 3, 4, 5
TEXTURE_PIN = dict(width=64, height=64, spp=4, seed=3)
SSS_CFG = dict(max_depth=8, rr_start=99, sss_steps=24)
# Phase 23's gradients, the JAX package on the CPU (`JAX_PLATFORMS=cpu python
# tools/texture_grad_reference.py` writes TGRAD_REF): d mean(render) at 64x64, 4 spp, seed 0 of
# deluxe (depth 4, rr_start 99) with respect to textures.atlas and textures.color_a, and of the
# Marble sphere (depth 6, rr_start 99, 16 walk steps) with respect to materials.sss_sigma_s. Each
# entry within 1e-3 of the field's largest (+1e-6), the loss within 1e-4, as phase 12's.
TGRAD_REF = os.path.join("tools", "texture_grad_reference.npz")
TGRAD_CASES = {"deluxe": (dict(max_depth=4, rr_start=99), ["textures.atlas", "textures.color_a"]),
               "sss": (dict(max_depth=6, rr_start=99, sss_steps=16), ["materials.sss_sigma_s"])}
TGRAD_PAIRS = 2            # phase 23 (e): alternating forward / forward+backward walls
TGRAD_SSS_SIZE = 128       # phase 23 (e): the sphere's gradient pass, 128x128 at 16 spp
# Phase 24's pins, the JAX package on the CPU (`JAX_PLATFORMS=cpu python
# tools/dynamic_reference_mean.py`), on tools/dynamic_cases.py's scenes at 64x64, seed 3, depth 5:
# render_counted of the instanced _build(8) scene (8 spp) and of the skinned spheres at pose 2 (4
# spp; 2,160 + 2 triangles in the dense band, 16,000 + 2 above it), each with its rays (gates 0.5%
# and 1e-3, as phase 4's); render_adaptive_host on the Cornell box (4 spp, 3 passes; 0.5%) and
# render_wavefront_adaptive on the glossy scene (32x32, 4 spp, 3 waves; 1%, as the glossy pin's).
# The CPU port (`--port`) gives the instanced mean and rays exactly, the spheres' rays exactly and
# means within 6e-8, the adaptive means within 3.2e-5 and 2.7e-7.
DYNAMIC_PINS = {"instanced": (0.083558880, 92_265, 0.005),
                "skinned_dense": (0.248688146, 44_013, 0.005),
                "skinned_bvh": (0.248198032, 44_052, 0.005)}
DYNAMIC_PIN = dict(size=64, seed=3, pose=2)
REF_ADAPTIVE_MEAN = 0.132675648
REF_ADAPTIVE_WF_MEAN = 0.165580675
ADAPTIVE_WF_PIN = 32
# d mean(render(animate_scene(skinned 10 x 20 sphere, pose))) / d pose at pose 2, 64x64, the JAX
# package's jax.grad on the CPU (the same tool); the CPU port's within 3e-8 of each entry. Gate as
# phase 12's: each entry within 1e-3 relative plus 1e-3 of the largest, the loss within 1e-4.
POSE_GRAD = dict(n_theta=10, n_phi=20, spp=4, seed=0, max_depth=4, rr_start=99)
REF_POSE_LOSS = 0.246825859
REF_POSE_GRAD = [0.00237852591, -0.000700105971, 0.00181664689, 0.00031911768, 0.00670840498,
                 0.00559949176, -0.00863757916, -0.0104023088, 0.00732770795, -0.00506967492,
                 0.00851382315, 0.0457827672, 0, 0, 0, 0, 0.00407258701, -0.00132088957,
                 0.00609134557, 0.00658939453, -0.002604804, -0.00547317509, 0.0117989024,
                 0.00502401125, 0.00101373228, -0.000613909797, 0.00426000124, 0.00206930493,
                 0, 0, 0, 0]
INSTANCE_AGREE = 0.999     # phase 24: instanced vs flattened camera rays (tests/test_instances.py)
# Phase 25's pins: `JAX_PLATFORMS=cpu python tools/engines_reference_mean.py` (the JAX package
# on the CPU at tools/engines_cases.PIN's sizes; --port for the CPU port's, equal to 9 digits
# but the dispersive caustic 1.9e-7, the volume 1.2e-7 and the AOV means, which differ where
# pixel-centre rays cross a quad's diagonal: there JAX's Woop test lets rays through a closed
# wall that the port's watertight test hits)
ENGINE_PINS = {"spectral_cornell": 0.132589474, "spectral_caustic": 0.317814916,
               "spectral_vol": 0.127622664, "guided": 0.297794133, "game": 0.095883340}
ENGINE_TOL = 0.005
REF_SPECTRAL_VOL_SPREAD = 0.011438   # (max - min) / seed-3 mean over seeds 3, 4, 5
REF_SPECTRAL_GRAD_RADIANCE = [0.004604860208928585, 0.004264678340405226, 0.003606081008911133]
REF_SPECTRAL_CAUCHY_LOSS = 0.141414106
REF_SPECTRAL_GRAD_CAUCHY = -0.00484975288
SPECTRAL_GRAD_TOL = 1e-3
REF_GUIDED_HIST_SUM = 87.8799515
REF_AOV_MEANS = {"albedo": 0.409643412, "albedo_non_delta": 0.409643412, "bary": 0.160925373,
                 "d3d_depth": 0.835478306, "depth": 3.27000594, "direct": 0.03401893,
                 "direct_non_delta": 0.0340284556, "emission": 0.0711669922,
                 "emission_non_delta": 0.0711669922, "mat_id": 0.0981750488,
                 "normal_geo": 0.310933441, "normal_sh": 0.310933441, "prim_id": 18.8756561,
                 "uv": 0.160925373, "v_absdot_n_geo": 0.412555635, "v_dot_n_geo": 0.575342119,
                 "v_dot_n_shade": 0.575342119}
# Phase 26 (c)'s pins: `JAX_PLATFORMS=cpu python tools/io_reference_mean.py` (the JAX package on
# the CPU at tools/io_cases.PIN's size; --port for the CPU port's: render 3.5e-5 below, its
# watertight test hitting rays JAX's Woop test loses). render within 0.5% as phase 21's pins;
# render_vol within 1%, a sixth of its seeds 3-5 spread (5.7%).
IO_PINS = {"render": (0.256625742, 0.005), "render_vol": (0.257475942, 0.01)}
CRACK_SIZE = 256           # phase 26 (a): Cornell's pixel-centre rays, as render_aovs makes them
CRACK_QUADS, CRACK_QUAD_RAYS = 64, 32   # shared-diagonal rays a scale (tools/crack_cases.py)
# JAX's means keep its Woop test's crack: pixel-centre rays through a quad's diagonal miss in JAX
# and hit in the port, moving albedo's mean by 1.06e-3, mat_id's by 6.2e-4, the rest <= 5.4e-4
# (the card equals the CPU port to 7.3e-8)
AOV_TOL = 0.0011
GUIDE_RES, GUIDE_BATCHES, GUIDE_PHOTONS = 8, 4, 1 << 17   # phase 25 (d): bench config 5's photons
FAST_SIZE = 1024           # phase 25 (e): render_fast's 2^20 rays, one BVH launch
FAST_OFF_MAX = 16          # pixels whose hit may differ from the plain route's (coincident ties)
UTIL_LANES = 1 << 20       # phase 27 (a): lanes of each math utility
UTIL_SLICE = 4096          # phase 27: lanes held to the CPU port
UTIL_PAYLOAD_BYTES = 4 << 30   # phase 27 (b): query_reduce payload per chunk
UTIL_AOV_SIZE = 256        # phase 27 (c)
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
FLOPS_BOX_TEST = 25        # one ray / chunk-box slab test (6 sub, 6 mul, 10 min/max, 3 compare)
FLOPS_BVH_INNER = 50       # two slab tests
FLOPS_WOOP_T = 17          # per row tested: t from the Woop rows and its range test
FLOPS_EDGE = 39            # per row whose t is in range: the watertight edge test, what it needs
#                            (3 vertices translated, 3 sub, and sheared, a[kx] - Sx a[kz] and
#                            a[ky] - Sy a[kz], 2 mul 2 sub: 3 x 7; 3 edge functions, 3 x 3; 3 zero
#                            tests for the float64 fallback and 6 sign tests)
FLOPS_UV = 26              # per row taken: u, v from the Woop rows
ROW_BYTES = 48 + 36        # a Woop row and the 9 floats of its vertex row that the test reads
FLOPS_PHOTON_PAIR = 32     # per (valid query, photon) pair weighed (an FMA counts two)
LEAF_SIZE = 4
PORT_KERNELS = ("dense_kernel", "bvh_kernel", "gather_kernel", "gather_bwd_tile_kernel",
                "gather_bwd_warp_tile_kernel", "gather_bwd_range_kernel",
                "gather_bwd_word_kernel", "gather_bwd_final_kernel", "photon_kernel",
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
    """Gates of a kernel vs plain comparison (a batch in which no ray hits fails)."""
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


def _woop_t(woop, o, d):
    """(rays, rows) t of every ray against every Woop row from the rows'
    third line (the count's t; the kernels round it in their own order)."""
    import torch

    r = woop[:, 8:12]
    oz = o @ r[:, :3].T + r[:, 3]
    dz = d @ r[:, :3].T
    return -oz / torch.where(dz.abs() < 1e-20, 1e-20, dz)


def _dense_work(woop, boxes, o, d, t_min, t_max, verts):
    """Operations the dense query needs on these inputs: every ray's box
    tests, FLOPS_WOOP_T for each row of the chunks its box test passes at
    its final t (the plain cull emulation's count), FLOPS_EDGE for each of
    those rows whose t lies in (t_min, final t] (each such row is edge-tested
    whatever order the sweep takes) and FLOPS_UV for each hit; also the
    all-rows figure of the old sweep and how far the emulation's hits differ
    from the plain version's (0 expected)."""
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops

    import torch
    from cudatracerlib_tpu_torch.accel.traversal import _slab_test

    hit, n_chunks, n_rows = ops.cull_sweep(woop, boxes, o, d, t_min, t_max, verts=verts)
    plain = ops.intersect_dense_plain(woop, o, d, t_min, t_max, verts=verts)
    off = int((hit.prim != plain.prim).sum()) + int((hit.t != plain.t).sum())
    B, C, T = o.shape[0], boxes.shape[0], woop.shape[0]
    rows = int(n_rows.sum())
    # what a warp sweeps: the union of its 32 lanes' chunks (at the final t,
    # so a floor of what the running t enters); and the rows edge-tested
    t_lo = torch.as_tensor(t_min, dtype=torch.float32, device=o.device).expand(B)
    inv_d = 1.0 / torch.where(d.abs() < 1e-20, torch.where(d < 0, -1e-20, 1e-20), d)
    chunk_of = torch.arange(T, device=o.device) // 32
    union, edge_rows = 0, 0
    step = max(32, ((1 << 25) // max(T, C)) // 32 * 32)
    for s in range(0, B, step):
        sl = slice(s, min(s + step, B))
        enter, _ = _slab_test(boxes[None, :, 0:3], boxes[None, :, 4:7], o[sl, None],
                              inv_d[sl, None], t_lo[sl, None], hit.t[sl, None])
        enter = enter & (t_lo[sl, None] < hit.t[sl, None])
        n32 = (enter.shape[0] // 32) * 32
        union += int(enter[:n32].reshape(-1, 32, C).any(1).sum())
        t = _woop_t(woop, o[sl], d[sl])
        in_range = (t > t_lo[sl, None]) & (t <= hit.t[sl, None]) & torch.isfinite(t)
        edge_rows += int((in_range & enter[:, chunk_of]).sum())
    flops = (FLOPS_BOX_TEST * B * C + FLOPS_WOOP_T * rows + FLOPS_EDGE * edge_rows
             + FLOPS_UV * int(hit.valid.sum()))
    return dict(flops=flops, all_rows_flops=FLOPS_WOOP_T * B * T + FLOPS_EDGE * edge_rows
                + FLOPS_UV * int(hit.valid.sum()), rows=rows, edge_rows=edge_rows,
                mean_chunks=float(n_chunks.double().mean()), emulation_off=off,
                warp_chunks=union / max(1, B // 32),
                nbytes=B * (24 + 8 + 16) + ROW_BYTES * T + boxes.numel() * 4)


def _bvh_flops(inner, leaf, tpass, hits):
    """Operations of a BVH query from the oracle's counts: inner-node visits,
    leaf visits (LEAF_SIZE rows each), rows whose t passed the range test
    (each edge-tested) and hits (u, v)."""
    return (FLOPS_BVH_INNER * inner + FLOPS_WOOP_T * LEAF_SIZE * leaf + FLOPS_EDGE * tpass
            + FLOPS_UV * hits)


def _compare(label, woop, o, d, t_min, t_max, reps, boxes, verts):
    """intersect_dense vs its plain version on the same CUDA tensors, closest
    and any-hit; times the wrapper, the kernel alone and the plain version,
    and counts the work for the bound. `boxes` are the rows' chunk boxes
    (derived from the Woop rows when None), `verts` their vertex rows.
    Returns a dict."""
    import torch
    from cudatracerlib_tpu_torch.accel.bvh import chunk_boxes_from_woop
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops

    if boxes is None:
        boxes = chunk_boxes_from_woop(woop)
    plain = ops.intersect_dense_plain(woop, o, d, t_min, t_max, verts=verts)
    t_scale = float(torch.clamp(plain.t[plain.valid].abs().amax(), min=1.0)) \
        if bool(plain.valid.any()) else 1.0
    changed = _crack_changed(label, woop, o, d, t_min, t_max, plain)
    worst = 0.0
    for any_hit in (False, True):
        kern = ops.intersect_dense(woop, o, d, t_min, t_max, any_hit=any_hit, boxes=boxes,
                                   verts=verts)
        torch.cuda.synchronize()
        r = ops.compare_hits(kern, plain, woop, t_min, t_max, any_hit=any_hit)
        worst = max(worst, _check_hits(label, "any_hit" if any_hit else "closest", r, t_scale))
    wrap_ms = _time_ms(lambda: ops.intersect_dense(woop, o, d, t_min, t_max, boxes=boxes,
                                                   verts=verts), reps)
    prepared, _ = ops.launch_args(woop, o, d, t_min, t_max, boxes=boxes, verts=verts)
    ms = _time_kernel_ms([prepared] * (reps + 1), ops.launch)
    plain_ms = _time_ms(lambda: ops.intersect_dense_plain(woop, o, d, t_min, t_max, verts=verts),
                        max(1, reps // 10))
    work = _dense_work(woop, boxes, o, d, t_min, t_max, verts)
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
                old_bound=old_bound, changed=changed)


def _crack_changed(label, woop, o, d, t_min, t_max, plain):
    """The rays of one dense comparison that the watertight test decides
    otherwise than the Woop test's own u, v did (`woop_decision` of
    tools/crack_cases.py, the decision the JAX package and the port before
    the repair take): hit by one and missed by the other, or hit on another
    row."""
    import torch
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops

    t_hi = torch.clamp(torch.as_tensor(t_max, dtype=torch.float32, device=o.device),
                       max=ops.T_MAX_CLAMP)
    valid, prim = _crack_cases().woop_decision(woop, o, d, t_min, t_hi)
    gained, lost = int((plain.valid & ~valid).sum()), int((valid & ~plain.valid).sum())
    moved = int((valid & plain.valid & (prim != plain.prim)).sum())
    out = dict(gained=gained, lost=lost, moved=moved, woop_hits=int(valid.sum()))
    print(f"[crack] {label}: the watertight test against the Woop decision: {gained} rays "
          f"gained, {lost} lost, {moved} on another row, of {o.shape[0]} "
          f"({out['woop_hits']} Woop hits)")
    return out


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
            flops = _bvh_flops(int(n_inner.sum()), int(n_leaf.sum()), int(n_tpass.sum()),
                               int(plain.valid.sum()))
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
    nbytes = o.shape[0] * (24 + 8 + 16) + 4 * bvh.nodes.numel() + ROW_BYTES * bvh.woop.shape[0]
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

    def capture_dense(woop, o, d, t_min=1e-4, t_max=ops.T_MAX_CLAMP, any_hit=False, boxes=None,
                      *, verts):
        keep = lambda x: x.clone() if isinstance(x, torch.Tensor) else x  # noqa: E731
        dense_calls.append((woop, keep(o), keep(d), keep(t_min), keep(t_max), any_hit, boxes,
                                verts))
        return real_dense(woop, o, d, t_min, t_max, any_hit=any_hit, boxes=boxes, verts=verts)

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


def _bwd_layout(label, idx, n_rows, cols):
    """The gather backward's work at one shape, counted from its indices:
    the (tile, row) pairs (the tile partials the tile kernel writes), the
    range stage the rule takes (`bwd_word_masks`: the word kernel on
    per-32-row-word masks, else the band kernel on row lists) with its
    bands and ranges, the tiles' records and the whole scratch in bytes;
    printed and returned."""
    import torch
    from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops

    n, T = idx.shape[0], sg_ops.BWD_TILE
    rows = torch.clamp(idx, 0, n_rows - 1).long()
    pairs = int(torch.unique(torch.arange(n, device=idx.device) // T * n_rows + rows).numel())
    n_tiles = -(-n // T)
    masks = sg_ops.bwd_word_masks(n_rows, cols)
    bands, band_rows = (0, 0) if masks else sg_ops.bwd_bands(n_tiles, n_rows, cols)
    out = dict(pairs=pairs, bands=bands, band_rows=band_rows,
               ranges=-(-n_tiles // sg_ops.bwd_range_tiles(n_tiles)),
               row_lists=0 if masks else n_tiles * min(T, n_rows) * 4,
               word_masks=2 * n_tiles * -(-n_rows // 32) * 4 if masks else 0,
               scratch=sg_ops.bwd_scratch_floats(cols, n, n_rows) * 4)
    stage = (f"the word kernel on {-(-n_rows // 32)} words of masks ({out['word_masks']} bytes)"
             if masks else f"the band kernel, {bands} bands of {band_rows} rows, row lists of "
             f"{out['row_lists']} bytes")
    print(f"[layout] packed_gather_bwd {label}: {n} lanes x {cols} onto {n_rows} rows: "
          f"{pairs} (tile, row) pairs ({pairs * cols * 4} bytes of tile partials), {n_tiles} "
          f"tiles in {out['ranges']} ranges; {stage}; scratch {out['scratch']} bytes")
    return out


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
    print(f"[kernel vs plain] packed_gather_bwd {label}: {n} lanes x {cols} onto {n_rows} rows "
          f"({int((counts > 0).sum())} hit, the most hit {int(counts.max())} lanes), "
          f"max rel err {rel:.3g}, max abs err {err:.3g}, two launches bit-equal, bit-equal to "
          f"the emulation on 4,096 lanes")
    layout = _bwd_layout(label, idx, n_rows, cols)
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
                bound=bound, **layout)


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

    def capture_dense(woop, o, d, t_min=1e-4, t_max=ops.T_MAX_CLAMP, any_hit=False, boxes=None,
                      *, verts):
        keep = lambda x: x.clone() if isinstance(x, torch.Tensor) else x  # noqa: E731
        dense_calls.append((woop, keep(o), keep(d), keep(t_min), keep(t_max), any_hit, boxes,
                                verts))
        return real_dense(woop, o, d, t_min, t_max, any_hit=any_hit, boxes=boxes, verts=verts)

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
    layout = _bwd_layout(f"splat sum {label}", idx, n_px, C)
    print(f"[kernel vs plain] splat sum {label}: {n} splats onto {n_px} pixels "
          f"({int(pos.any(-1).sum())} lit, {int((val > 0).any(-1).sum())} nonzero splats), max rel "
          f"err {rel:.3g}, max abs err {err:.3g}, two launches bit-equal; scratch "
          f"{layout['scratch']} bytes")
    print(f"[time] splat sum {label}: kernels {ms:.4f} ms, whole call {wrap_ms:.4f} ms, plain "
          f"(float64 index_add_) {plain_ms:.4f} ms, index_add_ (float32, atomics) {lib_ms:.4f} ms, "
          f"bound {bound[0]:.5f} ms ({bound[1]}: {nbytes} bytes)")
    return dict(err=err, rel=rel, ms=ms, wrap_ms=wrap_ms, plain_ms=plain_ms, lib_ms=lib_ms,
                bound=bound, **layout)


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

    def capture(woop, o, d, t_min=1e-4, t_max=ops.T_MAX_CLAMP, any_hit=False, boxes=None,
                      *, verts):
        keep = lambda x: x.clone() if isinstance(x, torch.Tensor) else x  # noqa: E731
        calls = shadow if any_hit else closest
        if len(calls) < 2:
            calls.append((woop, keep(o), keep(d), keep(t_min), keep(t_max), any_hit, boxes,
                                verts))
        return real(woop, o, d, t_min, t_max, any_hit=any_hit, boxes=boxes, verts=verts)

    ops.intersect_dense = capture
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        ops.intersect_dense = real
    _require(len(closest) == 2 and shadow, "the volume pass made too few intersect_dense launches")
    return {"volume camera rays": closest[0], "volume bounce-1 rays": closest[1],
            "volume shadow rays": shadow[0]}


def _capture_transmittance(fn):
    """ops/transmittance.transmittance's arguments (detached clones), one
    entry a call, over one call of `fn`: [(vol, grid, st, o, d, t_min,
    t_max)], the sampled segment's and the shadow rays' in turn a bounce."""
    import torch
    from cudatracerlib_tpu_torch.ops import transmittance as tr_op

    calls, real = [], tr_op.transmittance
    keep = lambda x: x.detach().clone() if isinstance(x, torch.Tensor) else x  # noqa: E731

    def record(vol, grid, st, o, d, t_min, t_max):
        calls.append((vol, *(keep(x) for x in (grid, st, o, d, t_min, t_max))))
        return real(vol, grid, st, o, d, t_min, t_max)

    tr_op.transmittance = record
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        tr_op.transmittance = real
    _require(len(calls) >= 2, f"the pass made {len(calls)} transmittance kernel calls, not >= 2")
    return calls


def _check_transmittance(label, calls, backward=False):
    """The transmittance kernel against its plain version (the eager path's
    arithmetic) on every captured call: the factor and acc bit-equal. The
    first bounce's two calls (the sampled segment, the shadow rays) timed
    with CUDA events: the wrapper's launch and the plain version, against
    the bound (TR_FLOPS, TR_BYTES); the kernel's sum over the calls. With
    `backward`, on a seeded cotangent: two backward calls bit-equal, the
    grid's and st's gradients within BWD_RTOL of the plain closed form's
    largest entry; the backward kernel alone (`bwd_corners`) and the whole
    backward (it, the gather backward at the grid shape, st's sum) timed."""
    import torch
    from cudatracerlib_tpu_torch.ops import transmittance as tr_op

    out_r, total = {}, 0.0
    for k, (vol, grid, st, o, d, t_min, t_max) in enumerate(calls):
        n = o.shape[0]
        out, acc = tr_op._forward(vol, grid, st, o, d, t_min, t_max, keep_acc=True)
        ref, ref_acc = tr_op.transmittance_plain(vol, grid, st, o, d, t_min, t_max)
        torch.cuda.synchronize()
        _require(torch.equal(out, ref) and torch.equal(acc, ref_acc),
                 f"transmittance {label} call {k}: the kernel differs from its plain version")
        del ref, ref_acc
        ms = _time_ms(lambda: tr_op._forward(vol, grid, st, o, d, t_min, t_max, False), 10)
        total += ms
        if k >= 2:
            continue
        name = ("segment", "shadow")[k]
        plain_ms = _time_ms(lambda: tr_op.transmittance_plain(vol, grid, st, o, d, t_min, t_max),
                            3)
        bound = _bound(n * TR_FLOPS, n * TR_BYTES)
        r = dict(lanes=n, err=0.0, ms=ms, plain_ms=plain_ms, bound=bound,
                 attenuated=int((out < 1).any(-1).sum()))
        line = (f"[kernel vs plain] transmittance {label} {name} rays: {n} lanes "
                f"({r['attenuated']} attenuated), the factor and acc bit-equal; kernel {ms:.4f} "
                f"ms, plain {plain_ms:.3f} ms, bound {bound[0]:.5f} ms ({bound[1]}; "
                f"{100 * bound[0] / ms:.1f}% of it)")
        if backward:
            gen = torch.Generator(device=o.device).manual_seed(k)
            g = torch.randn(out.shape, generator=gen, device=o.device)
            args = (vol, grid.shape[0], st, o, d, t_min, t_max, g, out, acc)
            k1, k2 = tr_op._backward(*args), tr_op._backward(*args)
            plain = tr_op.transmittance_bwd_plain(*args)
            torch.cuda.synchronize()
            _require(all(torch.equal(a, b) for a, b in zip(k1, k2)),
                     f"transmittance {label} {name}: two backward calls differ")
            rel = max(float((a - p).abs().max() / p.abs().max()) for a, p in zip(k1, plain))
            _require(rel <= BWD_RTOL, f"transmittance {label} {name}: the backward is {rel} of "
                                      f"the largest entry off its plain version")
            del k1, k2, plain
            kern_ms = _time_ms(lambda: tr_op.bwd_corners(vol, st, o, d, t_min, t_max, g, out, acc),
                               5)
            whole_ms = _time_ms(lambda: tr_op._backward(*args), 5)
            bwd_bound = _bound(n * TR_BWD_FLOPS, n * TR_BWD_BYTES)
            r.update(bwd_rel=rel, bwd_ms=kern_ms, bwd_whole_ms=whole_ms, bwd_bound=bwd_bound)
            line += (f"; backward within {rel:.3g} of the largest entry, two calls bit-equal, "
                     f"kernel {kern_ms:.4f} ms (bound {bwd_bound[0]:.5f}, {bwd_bound[1]}; "
                     f"{100 * bwd_bound[0] / kern_ms:.1f}% of it), whole {whole_ms:.4f} ms")
        print(line)
        out_r[name] = r
        torch.cuda.empty_cache()
    out_r["calls"], out_r["kernel_ms_sum"] = len(calls), total
    print(f"[kernel vs plain] transmittance {label}: {len(calls)} calls bit-equal to the plain "
          f"version; the kernel {total:.4f} ms over them")
    return out_r


def _capture_track(fn):
    """scene/media.delta_track's arguments (clones), one entry a call, over
    one call of `fn`."""
    import torch
    from cudatracerlib_tpu_torch.scene import media

    calls, real = [], media.delta_track
    keep = lambda x: x.detach().clone() if isinstance(x, torch.Tensor) else x  # noqa: E731

    def record(*args):
        calls.append(tuple(keep(x) for x in args))
        return real(*args)

    media.delta_track = record
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        media.delta_track = real
    return calls


def _lane_trips(args, T):
    """The trips the lanes of one tracking call began while tracking, summed
    over the lanes: the eager loop's T trips, counting the tracking lanes
    before each."""
    import torch
    from cudatracerlib_tpu_torch.scene import media

    media_, modes, o, d, u_near, u_far, maj, in_vol, state = args
    c = media._Track(t=u_near, tracking=in_vol, real=torch.zeros_like(in_vol), state=state)
    total = torch.zeros((), dtype=torch.int64, device=o.device)
    with torch.no_grad():
        for _ in range(T):
            total = total + c.tracking.sum()
            c = media._track(media_, modes, o, d, maj, u_far, c)
    return int(total)


def _check_track(label, calls):
    """The tracking kernel against the eager loop on every captured call: t
    bit-equal, real and T equal. The first call (bounce 0) timed with CUDA
    events, `delta_track` (the kernel on these inputs) and the eager loop,
    against the bound over the lane-trips it needs; the kernel's sum over
    the calls."""
    import torch
    from cudatracerlib_tpu_torch.scene import media

    total, r, trips = 0.0, {}, []
    for k, args in enumerate(calls):
        t, real, T = media.delta_track(*args)
        c, T_eager = media._track_eager(*args)
        torch.cuda.synchronize()
        _require(torch.equal(t, c.t) and torch.equal(real, c.real) and int(T) == int(T_eager),
                 f"tracking {label} call {k}: the kernel differs from the eager loop (T "
                 f"{int(T)} / {int(T_eager)}, t {int((t != c.t).sum())} lanes, real "
                 f"{int((real != c.real).sum())} lanes)")
        trips.append(int(T))
        del c
        ms = _time_ms(lambda: media.delta_track(*args), 10)
        total += ms
        if k:
            continue
        n = args[2].shape[0]
        eager_ms = _time_ms(lambda: media._track_eager(*args), 3)
        lane_trips = _lane_trips(args, int(T))
        bound = _bound(lane_trips * TRACK_TRIP_OPS + n * TRACK_LANE_OPS, n * TRACK_BYTES)
        r = dict(lanes=n, T=int(T), lane_trips=lane_trips, in_volume=int(args[7].sum()),
                 ms=ms, eager_ms=eager_ms, bound=bound)
        print(f"[kernel vs eager] tracking {label} bounce 0: {n} lanes ({r['in_volume']} in the "
              f"volume), T {int(T)}, {lane_trips} lane-trips ({lane_trips / max(n, 1):.3f} a "
              f"lane); t bit-equal, real and T equal; kernel {ms:.4f} ms, eager loop "
              f"{eager_ms:.3f} ms, bound {bound[0]:.5f} ms ({bound[1]}; "
              f"{100 * bound[0] / ms:.1f}% of it)")
        torch.cuda.empty_cache()
    r.update(calls=len(calls), kernel_ms_sum=total, trips=trips)
    print(f"[kernel vs eager] tracking {label}: {len(calls)} calls equal to the eager loop, T by "
          f"bounce {trips}; the kernel {total:.4f} ms over them")
    return r


def _track_phase(scene, plume, cfg):
    """The tracking kernel at the plume render cell's pass (TR_RENDER) and the
    grad cell's (TRACK_GRAD), seed 7: its launches and eager calls over the
    first pass, then `_check_track` on each pass's calls."""
    import torch
    from cudatracerlib_tpu_torch.ops import delta_track as dt_op
    from cudatracerlib_tpu_torch.render import volpath
    from cudatracerlib_tpu_torch.utils.timing import counters

    out = {}
    for name, (w, h, spp) in (("render", TR_RENDER), ("grad", TRACK_GRAD)):
        before = (dt_op.launches["fwd"], counters().get("media.track.eager", 0))

        def one_pass():
            with torch.no_grad():
                volpath.render_vol(scene, plume, w, h, spp, 7, cfg)

        calls = _capture_track(one_pass)
        launched = dict(fwd=dt_op.launches["fwd"] - before[0],
                        eager=counters().get("media.track.eager", 0) - before[1])
        print(f"[main path] tracking over one {w}x{h}, {spp}-spp, depth {cfg.max_depth} plume "
              f"pass: {json.dumps(launched)}")
        _require(launched == dict(fwd=cfg.max_depth, eager=0) and len(calls) == cfg.max_depth,
                 f"the plume pass did not run its tracking through the kernel: {launched}")
        out[name] = dict(_check_track(f"{w}x{h}x{spp}", calls), launches=launched)
        del calls
        torch.cuda.empty_cache()
    return out


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
    from cudatracerlib_tpu_torch.ops import transmittance as tr_op
    from cudatracerlib_tpu_torch.render import path_tracer as pt
    from cudatracerlib_tpu_torch.render import volpath
    from cudatracerlib_tpu_torch.scene import media as media_mod
    from cudatracerlib_tpu_torch.utils.timing import counters

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
    vol_r = {label: _compare(label, c[0], c[1], c[2], c[3], c[4], 20, c[6], c[7])
             for label, c in vol_args.items()}
    _, vol_rays = volpath.render_vol_stepwise(scene, plume, VOL_W, VOL_H, VOL_SPP, VOL_PASSES, 3,
                                              vcfg, with_stats=True)
    torch.cuda.synchronize()
    reset_counts()
    dt_v, img_v = _timed(lambda: volpath.render_vol_stepwise(scene, plume, VOL_W, VOL_H, VOL_SPP,
                                                              VOL_PASSES, 7, vcfg))
    launch_v = dict(ops.launches)
    launch_tr = dict(tr_op.launches)
    print(f"[main path] volume launches {json.dumps(launch_v)}, transmittance "
          f"{json.dumps(launch_tr)}")
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

    # the transmittance kernel on one pass of the plume render cell: its launches, then each
    # call's inputs against the plain version
    w, h, spp = TR_RENDER
    reset_counts()
    eager0 = counters().get("media.transmittance.eager", 0)

    def cell_pass():
        with torch.no_grad():
            volpath.render_vol(scene, plume, w, h, spp, 7, vcfg)

    tr_calls = _capture_transmittance(cell_pass)
    tr_pass = dict(tr_op.launches, eager=counters().get("media.transmittance.eager", 0) - eager0)
    print(f"[main path] transmittance launches over one {w}x{h}, {spp}-spp, depth {VOL_DEPTH} "
          f"plume pass: {json.dumps(tr_pass)}")
    _require(tr_pass == dict(fwd=2 * VOL_DEPTH, bwd=0, eager=0),
             f"the plume pass did not run its transmittance through the kernel: {tr_pass}")
    tr = _check_transmittance(f"{w}x{h}x{spp}", tr_calls)
    del tr_calls
    torch.cuda.empty_cache()
    track = _track_phase(scene, plume, vcfg)
    return dict(compare=vol_r, launches=launch_v, profile=prof_v, tr=tr, tr_launches=launch_tr,
                tr_pass=tr_pass, track=track)


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
    cotangent, within 1e-5 relative), the pairs, bands and scratch."""
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
    record = r["row_lists"] + r["word_masks"]
    print(f"[scratch] packed_gather_bwd {label}: {r['scratch']} bytes, of which the tiles' "
          f"{'row lists' if r['row_lists'] else 'word masks'} {record} "
          f"({100 * record / r['scratch']:.1f}%); g and idx {n * cols * 4 + n * 4} bytes")
    return dict(r, captured_rel=rel, lanes=n, rows=n_rows)


def _volume_grad_phase(scene, smi, reset_counts):
    """Phase 19 (module docstring) on the Cornell box `scene`: the gates,
    the bench-config-4 gradient pass and the gather backward at its shapes."""
    import numpy as np
    import torch
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops
    from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops
    from cudatracerlib_tpu_torch.ops import transmittance as tr_op
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
    launches = {"intersect_dense": dict(ops.launches), "shade_gather": dict(sg_ops.launches),
                "transmittance": dict(tr_op.launches)}
    print(f"[vol grad pass] launches over one forward+backward: {json.dumps(launches)}")
    lv = launches
    _require(lv["transmittance"] == dict(fwd=2 * VOL_DEPTH, bwd=2 * VOL_DEPTH),
             f"the volume gradient pass did not run its transmittance through the kernels: {lv}")
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
                                                            c[0], c[1], c[2], c[3], c[4], 20, c[6], c[7])
               for label, c in dense_args.items()}
    tr = _check_transmittance(f"{VOL_W}x{VOL_H}x{VOL_SPP}", _capture_transmittance(fwd),
                              backward=True)

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
                dense=dense_r, tr=tr,
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

    def capture_dense(woop, o, d, t_min=1e-4, t_max=ops.T_MAX_CLAMP, any_hit=False, boxes=None,
                      *, verts):
        keep = lambda x: x.clone() if isinstance(x, torch.Tensor) else x  # noqa: E731
        if len(dense) < 64:
            dense.append((woop, keep(o), keep(d), keep(t_min), keep(t_max), any_hit, boxes,
                                verts))
        return real_dense(woop, o, d, t_min, t_max, any_hit=any_hit, boxes=boxes, verts=verts)

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
                                                 c[4], 10, c[6], c[7])
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

    def capture_dense(woop, o, d, t_min=1e-4, t_max=ops.T_MAX_CLAMP, any_hit=False, boxes=None,
                      *, verts):
        keep = lambda x: x.clone() if isinstance(x, torch.Tensor) else x  # noqa: E731
        if len(dense) < 3:
            dense.append((woop, keep(o), keep(d), keep(t_min), keep(t_max), any_hit, boxes,
                                verts))
        return real_dense(woop, o, d, t_min, t_max, any_hit=any_hit, boxes=boxes, verts=verts)

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
            # not the first-bounce rays: a convex sphere's bounces have nothing to hit
            checks["dense"] = {f"furnace {k}": _compare(f"furnace {k}", c[0], c[1], c[2], c[3],
                                                        c[4], 10, c[6], c[7])
                               for k, c in dense.items() if k != "first-bounce rays"}
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
          f"bytes (the band kernel: {not sg_ops.bwd_word_masks(n_rows, val.shape[1])})")
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


def _texture_cases():
    """tools/texture_cases.py (numpy only), imported from the checkout."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import texture_cases

    return texture_cases


def _texture_scene(case):
    """A texture case of tools/texture_cases.py built on the card."""
    from cudatracerlib_tpu_torch.scene.scene import Materials, build_scene
    from cudatracerlib_tpu_torch.scene.sensors import Camera
    from cudatracerlib_tpu_torch.scene.textures import Textures

    return _texture_cases().build(case, build_scene, Materials, Textures, Camera)


def _texture_grad_gates(deluxe, sss):
    """Phase 23 (e)'s pinned gradients against tools/texture_grad_reference.npz."""
    import numpy as np
    from cudatracerlib_tpu_torch.render import path_tracer as pt

    ref = np.load(TGRAD_REF)
    out = {}
    for name, scene in (("deluxe", deluxe), ("sss", sss)):
        cfg, paths = TGRAD_CASES[name]
        loss, g = _loss_and_grads(scene, paths, 64, 64, 4, 0, pt.PTConfig(**cfg))
        ref_loss = float(ref[f"{name}/loss"])
        _require(abs(loss - ref_loss) <= REF_LOSS_RTOL * abs(ref_loss),
                 f"{name} gradient pass: loss {loss} is not within {REF_LOSS_RTOL} of JAX's "
                 f"{ref_loss}")
        worst = 0.0
        for path in paths:
            r, v = ref[f"{name}/{path}"], g[path]
            err = np.abs(v - r)
            _require(bool(np.isfinite(v).all()) and bool(
                (err <= REF_GRAD_RTOL * (np.abs(r) + np.abs(r).max()) + 1e-6).all()),
                f"{name} d/d{path}: off JAX's by up to {float(err.max())} (largest "
                f"{float(np.abs(r).max())})")
            worst = max(worst, float(err.max() / np.abs(r).max()))
        print(f"[tex grad] {name} 64x64 spp 4 seed 0 {cfg}: loss {loss:.9f} (JAX {ref_loss:.9f}), "
              f"d/d{paths} within {worst:.3g} of each field's largest of JAX's (tolerance "
              f"{REF_GRAD_RTOL} of the entry + {REF_GRAD_RTOL} of the largest)")
        out[name] = dict(loss=loss, worst=worst)
    return out


def _texture_phase(smi, reset_counts):
    """Phase 23 (module docstring): textures and material maps, the
    subsurface walk and cornell_box_deluxe on the card, their pins and
    gradients, and intersect_dense, packed_gather and the gather backward
    held to their plain versions at the new shapes."""
    import numpy as np
    import torch
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops
    from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops
    from cudatracerlib_tpu_torch.render import path_tracer as pt
    from cudatracerlib_tpu_torch.render import wavefront as wf
    from cudatracerlib_tpu_torch.scene import material_lib, shade_pack
    from cudatracerlib_tpu_torch.scene import textures as tex_mod
    from cudatracerlib_tpu_torch.scene.shapes import cornell_box_deluxe

    tc = _texture_cases()
    cfg = pt.PTConfig(max_depth=DEPTH)
    sss_cfg = pt.PTConfig(**SSS_CFG)
    marks = [time.perf_counter()]

    def part(tag):
        marks.append(time.perf_counter())
        print(f"[wall] phase 23 ({tag}): {marks[-1] - marks[-2]:.1f} s")
    pw, ph, pspp, pseed = (TEXTURE_PIN[k] for k in ("width", "height", "spp", "seed"))

    def counts():
        return {"intersect_dense": dict(ops.launches), "shade_gather": dict(sg_ops.launches)}

    def pin(name, img, rays):
        ref, ref_rays, tol = TEXTURE_PINS[name]
        m = float(img.mean())
        _require(bool(torch.isfinite(img).all()), f"the pinned {name} image is not finite")
        _require(abs(m - ref) <= tol * ref,
                 f"pinned {name} mean {m} is not within {tol:.1%} of JAX's {ref}")
        _require(abs(int(rays) - ref_rays) <= 1e-3 * ref_rays,
                 f"pinned {name} rays {int(rays)} are not within 1e-3 of JAX's {ref_rays}")
        print(f"[pin] {name} ({pw}x{ph}, {pspp} spp, seed {pseed}): mean {m:.9f} (JAX {ref}, "
              f"{100 * (m / ref - 1):+.5f}%), rays {int(rays)} (JAX {ref_rays})")
        return m / ref - 1

    deluxe = cornell_box_deluxe()
    _require(deluxe.bvh.woop.device.type == "cuda" and shade_pack.pack_enabled(deluxe),
             "cornell_box_deluxe() did not build on the card in the shade pack's band")
    maps = _texture_scene(tc.maps_case())
    sss = _texture_scene(tc.sss_case(material_lib.sss_record))
    pins, runs = {}, {}

    # (a) deluxe at bench config 1's size: the pin, a counted pass, 5 passes timed
    pins["deluxe"] = pin("deluxe", *pt.render_counted(deluxe, pw, ph, pspp, pseed, cfg))
    img1, rays = pt.render_counted(deluxe, W, H, SPP, 3, cfg)
    torch.cuda.synchronize()
    reset_counts()
    dt, img = _timed(lambda: pt.render_progressive(deluxe, W, H, SPP, N_PASS, 7, cfg))
    launch = counts()
    _require(launch["intersect_dense"]["closest"] > 0 and launch["intersect_dense"]["any_hit"] > 0
             and launch["shade_gather"]["gather"] > 0,
             f"the deluxe passes did not launch intersect_dense for both ray kinds and "
             f"packed_gather: {launch}")
    _require(bool(torch.isfinite(img).all()) and bool(torch.isfinite(img1).all())
             and tuple(img.shape) == (H, W, 3), "the deluxe images are not finite")
    prof = _profile("deluxe pass", lambda: pt.render(deluxe, W, H, SPP, 7, cfg), top_n=5)
    mrays = int(rays) * N_PASS / dt / 1e6
    print(f"[main path] deluxe {W}x{H} spp {SPP} depth {DEPTH}: rays/pass {int(rays)} (seed 3, "
          f"mean {float(img1.mean()):.6f}), {N_PASS} passes in {dt:.4f} s, {mrays:.3f} Mrays/s, "
          f"idle {prof['idle']:.3f}; launches {json.dumps(launch)}; {smi}")
    runs["deluxe"] = dict(dt=dt / N_PASS, mrays=mrays, idle=prof["idle"], launches=launch)

    part("a")

    # (b) deluxe through the wavefront engine
    pins["deluxe_wf"] = pin("deluxe_wf", *wf.render_wavefront_counted(deluxe, pw, ph, pspp,
                                                                      pseed, cfg))
    wf.render_wavefront_counted(deluxe, W, H, SPP, 0, cfg)
    torch.cuda.synchronize()
    reset_counts()
    dt, (img, rays) = _timed(lambda: wf.render_wavefront_counted(deluxe, W, H, SPP, 7, cfg))
    launch = counts()
    _require(launch["intersect_dense"]["closest"] > 0 and launch["shade_gather"]["gather"] > 0
             and bool(torch.isfinite(img).all()),
             f"the deluxe wavefront render failed: {launch}")
    print(f"[main path] deluxe wavefront {W}x{H} spp {SPP} depth {DEPTH} seed 7: rays "
          f"{int(rays)}, {dt:.4f} s, {int(rays) / dt / 1e6:.3f} Mrays/s; launches "
          f"{json.dumps(launch)}; {smi}")
    runs["deluxe_wf"] = dict(dt=dt, mrays=int(rays) / dt / 1e6, launches=launch)

    part("b")

    # (c) the maps case: IMAGE albedo through the cone, height map with parallax, alpha test
    spec = pt.specialize_config(maps, cfg)
    _require(spec.height_maps and spec.parallax and spec.alpha_test
             and tex_mod.IMAGE in spec.tex_types, f"the maps case lost a feature: {spec}")
    pins["maps"] = pin("maps", *pt.render_counted(maps, pw, ph, pspp, pseed, cfg))
    pt.render_counted(maps, W, H, SPP, 0, cfg)
    torch.cuda.synchronize()
    reset_counts()
    dt, (img, rays) = _timed(lambda: pt.render_counted(maps, W, H, SPP, 7, cfg))
    launch = counts()
    _require(launch["intersect_dense"]["closest"] > 0 and launch["intersect_dense"]["any_hit"] > 0
             and bool(torch.isfinite(img).all()), f"the maps case failed: {launch}")
    print(f"[main path] maps case {W}x{H} spp {SPP} depth {DEPTH} seed 7: rays {int(rays)}, "
          f"{dt:.4f} s, {int(rays) / dt / 1e6:.3f} Mrays/s, mean {float(img.mean()):.6f}; "
          f"launches {json.dumps(launch)}; {smi}")
    runs["maps"] = dict(dt=dt, mrays=int(rays) / dt / 1e6, launches=launch)

    part("c")

    # (d) the subsurface walk: tests/test_sss.py's scene
    img, rays = pt.render_counted(sss, pw, ph, pspp, pseed, sss_cfg)
    m = float(img.mean())
    _require(bool(torch.isfinite(img).all())
             and abs(m - REF_SSS_MEAN) <= 3 * REF_SSS_SPREAD * REF_SSS_MEAN,
             f"pinned sss mean {m} is not within three times JAX's seed spread "
             f"({REF_SSS_SPREAD:.4f}) of {REF_SSS_MEAN}")
    pins["sss"] = m / REF_SSS_MEAN - 1
    print(f"[pin] sss ({pw}x{ph}, {pspp} spp, seed {pseed}, {SSS_CFG}): mean {m:.9f} (JAX "
          f"{REF_SSS_MEAN}, {100 * pins['sss']:+.4f}%, gate {300 * REF_SSS_SPREAD:.2f}%), rays "
          f"{int(rays)}")
    pt.render_counted(sss, W, H, SPP, 0, sss_cfg)
    torch.cuda.synchronize()
    reset_counts()
    dt, (img, rays) = _timed(lambda: pt.render_counted(sss, W, H, SPP, 7, sss_cfg))
    launch = counts()
    walk = sss_cfg.max_depth * sss_cfg.sss_steps
    _require(launch["intersect_dense"]["closest"] == sss_cfg.max_depth + walk
             and bool(torch.isfinite(img).all()),
             f"the sss pass did not launch {sss_cfg.max_depth} + {walk} closest-hit traces: "
             f"{launch}")
    print(f"[main path] sss {W}x{H} spp {SPP} {SSS_CFG} seed 7: rays {int(rays)}, {dt:.4f} s, "
          f"{int(rays) / dt / 1e6:.3f} Mrays/s, mean {float(img.mean()):.6f}; the walk adds "
          f"{walk} closest-hit launches to the bounces' {sss_cfg.max_depth}; launches "
          f"{json.dumps(launch)}; {smi}")
    runs["sss"] = dict(dt=dt, mrays=int(rays) / dt / 1e6, launches=launch)

    part("d")

    # (e) gradients: the pins at 64x64, then the full-size passes in alternating pairs
    gates = _texture_grad_gates(deluxe, sss)
    part("e, pins")
    grad = {}
    for name, scene, gcfg, paths, size in (
            ("deluxe", deluxe, cfg, ["textures.atlas", "textures.color_a"], W),
            ("sss", sss, sss_cfg._replace(remat=True), ["materials.sss_sigma_s"], TGRAD_SSS_SIZE)):
        def fwd(scene=scene, gcfg=gcfg, size=size):
            with torch.no_grad():
                return pt.render(scene, size, size, SPP, 7, gcfg)

        def fwd_bwd(scene=scene, gcfg=gcfg, paths=paths, size=size):
            return _loss_and_grads(scene, paths, size, size, SPP, 7, gcfg)

        fwd_walls, fb_walls = _paired_walls_ms(fwd, fwd_bwd, TGRAD_PAIRS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        _, g = fwd_bwd()
        torch.cuda.synchronize()
        launch = counts()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        _require(launch["shade_gather"]["gather_bwd_tile"] > 0
                 and all(bool(np.isfinite(v).all()) and np.abs(v).max() > 0 for v in g.values()),
                 f"the {name} gradient pass failed: {launch}")
        fwd_ms, fb_ms = _median(fwd_walls), _median(fb_walls)
        print(f"[tex grad pass] {name} {size}x{size} spp {SPP} seed 7 d/d{paths}"
              f"{' (remat)' if gcfg.remat else ''}: forward {fwd_ms:.3f} ms (min "
              f"{min(fwd_walls):.3f}, max {max(fwd_walls):.3f}), forward+backward {fb_ms:.3f} ms "
              f"(min {min(fb_walls):.3f}, max {max(fb_walls):.3f}), medians of {TGRAD_PAIRS} "
              f"alternating pairs; peak device memory above the scene {peak:.3f} GB; launches "
              f"over one forward+backward {json.dumps(launch)}; {smi}")
        grad[name] = dict(fwd_ms=fwd_ms, fb_ms=fb_ms, peak_gb=peak, launches=launch)

    part("e")

    # (f) the kernels at the new shapes: intersect_dense and the pack gather on a warm deluxe
    # pass, the gather backward on an atlas lookup's cotangent from a deluxe gradient pass
    dense, gathers, _ = _capture_render(lambda: pt.render_counted(deluxe, W, H, SPP, 0, cfg))
    dense_r = {f"deluxe {k}": _compare(f"deluxe {k}", c[0], c[1], c[2], c[3], c[4], 10, c[6], c[7])
               for k, c in dense.items()}
    gather_r = _check_gather_at("deluxe pack", *gathers[0])
    n_atlas = deluxe.textures.atlas.shape[0] * tex_mod.ATLAS_TOTAL
    lanes = W * H * SPP
    (g_cap, idx_cap, rows_cap), _ = _capture_bwd(
        lambda: _loss_and_grads(deluxe, ["textures.atlas"], W, H, SPP, 7, cfg),
        lambda g_, i, r: r == n_atlas and g_.shape == (lanes, 3))
    atlas_r = _check_bwd_captured("atlas", g_cap, idx_cap, rows_cap, deluxe.bvh.woop.device)
    del g_cap, idx_cap
    torch.cuda.empty_cache()
    part("f")
    return dict(pins=pins, runs=runs, gates=gates, grad=grad, dense=dense_r, gather=gather_r,
                atlas=atlas_r)


def _dynamic_cases():
    """tools/dynamic_cases.py (numpy only), imported from the checkout."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import dynamic_cases

    return dynamic_cases


def _crack_cases():
    """tools/crack_cases.py, imported from the checkout."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import crack_cases

    return crack_cases


def _crack_part(smi):
    """Phase 26 (a): the watertight test on the card. Cornell's CRACK_SIZE^2
    pixel-centre rays (as render_aovs makes them) through intersect_dense
    and through intersect_bvh over the same rows, each bit-equal to its
    plain version, with no ray through a wall (a miss that a float64 test,
    tolerant by 1e-6 in the barycentrics, hits); the rays the Woop test's
    own decision loses there counted; and rays aimed at the shared
    diagonals of random quads at three scales through both kernels: each
    hits its own quad. Returns the counts and the worst error."""
    import numpy as np
    import torch
    from cudatracerlib_tpu_torch.accel.bvh import build_bvh, vertex_rows, woop_transform
    from cudatracerlib_tpu_torch.ops import intersect_bvh as bvh_ops
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops
    from cudatracerlib_tpu_torch.scene import sensors
    from cudatracerlib_tpu_torch.scene.shapes import cornell_box

    cc = _crack_cases()
    dev = torch.device("cuda:0")

    def same(a, b):
        """lanes where two Hits differ (prim, or t / bary on a hit)"""
        v = a.valid & b.valid
        return int(((a.prim != b.prim) | (v & ((a.t != b.t) | (a.bary != b.bary).any(-1)))).sum())

    scene = cornell_box()
    n = CRACK_SIZE * CRACK_SIZE
    pid = torch.arange(n, device=dev)
    uv = torch.stack([((pid % CRACK_SIZE).float() + 0.5) / CRACK_SIZE,
                      ((pid // CRACK_SIZE).float() + 0.5) / CRACK_SIZE], -1)
    o, d, _ = sensors.sample_ray(scene.camera, uv, torch.full_like(uv, 0.5))
    bvh = scene.bvh
    kd = ops.intersect_dense(bvh.woop, o, d, boxes=bvh.chunk_boxes, verts=bvh.tri_verts)
    pd = ops.intersect_dense_plain(bvh.woop, o, d, verts=bvh.tri_verts)
    kb = bvh_ops.intersect_bvh(bvh, o, d)
    pb = bvh_ops.intersect_bvh_plain(bvh, o, d)
    torch.cuda.synchronize()
    tris = scene.shading.verts.detach().cpu().numpy()
    on, dn = o.cpu().numpy(), d.cpu().numpy()
    covered = cc.through_wall(tris, on, dn)
    woop_hit = cc.woop_decision(bvh.woop, o, d)[0].cpu().numpy()
    out = dict(rays=n, dense_off=same(kd, pd), bvh_off=same(kb, pb),
               dense_through_wall=int((covered & ~kd.valid.cpu().numpy()).sum()),
               bvh_through_wall=int((covered & ~kb.valid.cpu().numpy()).sum()),
               woop_test_through_wall=int((covered & ~woop_hit).sum()),
               dense_vs_bvh_tri=int((kd.valid != kb.valid).sum() + (kd.valid & kb.valid & (
                   bvh.tri_index[kd.prim.clamp(min=0).long()]
                   != bvh.tri_index[kb.prim.clamp(min=0).long()])).sum()))
    diag = {}
    for k, scale in enumerate(cc.SCALES):
        tq, qo, qd, quad = cc.diagonal_quads(CRACK_QUADS, CRACK_QUAD_RAYS, scale, k)
        woop = torch.from_numpy(woop_transform(tq[:, 0], tq[:, 1], tq[:, 2])).to(dev)
        verts = vertex_rows(torch.from_numpy(tq)).to(dev)
        qo_t, qd_t = torch.from_numpy(qo).to(dev), torch.from_numpy(qd).to(dev)
        qb = build_bvh(tq)
        hd = ops.intersect_dense(woop, qo_t, qd_t, verts=verts)
        hp = ops.intersect_dense_plain(woop, qo_t, qd_t, verts=verts)
        hb = bvh_ops.intersect_bvh(qb, qo_t, qd_t)
        hbp = bvh_ops.intersect_bvh_plain(qb, qo_t, qd_t)
        torch.cuda.synchronize()
        own = torch.from_numpy(quad).to(dev)
        own_b = qb.tri_index[torch.clamp(hb.prim, min=0).long()] // 2
        diag[scale] = dict(
            rays=int(qo.shape[0]), dense_missed=int((~hd.valid | (hd.prim // 2 != own)).sum()),
            bvh_missed=int((~hb.valid | (own_b != own)).sum()), dense_off=same(hd, hp),
            bvh_off=same(hb, hbp),
            woop_test_missed=int((~cc.woop_decision(woop, qo_t, qd_t)[0]).sum()))
    out["diagonals"] = diag
    print(f"[crack] Cornell {CRACK_SIZE}x{CRACK_SIZE} pixel-centre rays and shared-diagonal "
          f"rays ({CRACK_QUADS} quads x {CRACK_QUAD_RAYS} rays a scale): {json.dumps(out)}; {smi}")
    _require(out["dense_off"] == 0 and out["bvh_off"] == 0,
             f"the kernels differ from the plain watertight test on Cornell's rays: {out}")
    _require(out["dense_through_wall"] == 0 and out["bvh_through_wall"] == 0,
             f"rays pass through Cornell's walls: {out}")
    for scale, r in diag.items():
        _require(r["dense_missed"] == 0 and r["bvh_missed"] == 0,
                 f"shared-diagonal rays at scale {scale} missed their quad: {r}")
        _require(r["dense_off"] == 0 and r["bvh_off"] == 0,
                 f"shared-diagonal rays at scale {scale}: kernel vs plain differ: {r}")
    return out


def _io_cases():
    """tools/io_cases.py (numpy and PIL only), imported from the checkout."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import io_cases

    return io_cases


def _run(cmd, timeout=600):
    """(exit code, wall s, stdout) of a subprocess of this checkout's
    Python, run from the checkout's root."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, *cmd], capture_output=True, text=True, timeout=timeout,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    if r.returncode != 0:
        print(f"[subprocess] {' '.join(cmd)} exited {r.returncode}:\n{r.stdout[-2000:]}\n"
              f"{r.stderr[-4000:]}")
    return r.returncode, time.perf_counter() - t0, r.stdout


def _io_phase(big, big_pass, smi, reset_counts):
    """Phase 26 (b)-(d): bench config 3's scene written as PLY and
    `.serialized` files, loaded back through a Mitsuba XML and rendered at
    config 3's settings; the OBJ loader at BIG_PIN's size; the media-and-maps
    XML pinned to JAX's CPU means; the CLI and the inverse example as
    subprocesses. `big_pass` is phase 15's config-3 pass (mean, rays,
    seconds, seed 7). Returns the readings."""
    import tempfile

    import numpy as np
    import torch
    from cudatracerlib_tpu_torch.io import mitsuba as tmi
    from cudatracerlib_tpu_torch.io import serialized as tser
    from cudatracerlib_tpu_torch.ops import intersect_bvh as bvh_ops
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops
    from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops
    from cudatracerlib_tpu_torch.render import path_tracer as pt
    from cudatracerlib_tpu_torch.render import volpath
    from cudatracerlib_tpu_torch.render import wavefront as wf
    from cudatracerlib_tpu_torch.scene import bigscene

    ic = _io_cases()
    out = {}
    marks = [time.perf_counter()]

    def part(tag):
        marks.append(time.perf_counter())
        print(f"[wall] phase 26 ({tag}): {marks[-1] - marks[-2]:.1f} s")

    def counts():
        return {"intersect_dense": dict(ops.launches), "intersect_bvh": dict(bvh_ops.launches),
                "packed_gather": dict(sg_ops.launches)}

    tmp = tempfile.TemporaryDirectory()
    d = tmp.name
    # (b) bench config 3's scene through files
    t0 = time.perf_counter()
    tris, mat_id = bigscene._big_geometry(1_000_000, 0)
    written = np.concatenate([tris[mat_id == m] for m in range(3)] + [ic.BIG_LIGHT])
    written_mat = np.concatenate([np.full(int((mat_id == m).sum()), m) for m in range(3)]
                                 + [np.full(2, 3)])
    t_gen = time.perf_counter() - t0
    loads, scenes = {}, {}
    for fmt in ("ply", "serialized"):
        t0 = time.perf_counter()
        path = ic.write_big_scene(d, tris, mat_id, tser.save_serialized, fmt)
        t_write = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scenes[fmt] = tmi.load_mitsuba(path)
        torch.cuda.synchronize()
        loads[fmt] = dict(write_s=t_write, load_s=time.perf_counter() - t0,
                          bytes=sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)
                                    if f.endswith(fmt)))
        print(f"[io] bench config 3 as {fmt}: written in {t_write:.2f} s "
              f"({loads[fmt]['bytes']} bytes), loaded through the XML on the card in "
              f"{loads[fmt]['load_s']:.2f} s")
    loaded = scenes["ply"]
    _require(loaded.bvh.woop.device.type == "cuda", "load_mitsuba did not build on the card")
    order = loaded.bvh.tri_index.long().cpu().numpy()
    for fmt, sc in scenes.items():
        _require(torch.equal(sc.shading.verts.cpu(), torch.from_numpy(written[order]))
                 and torch.equal(sc.bvh.tri_index.cpu(), loaded.bvh.tri_index.cpu()),
                 f"the {fmt} scene's triangles are not the written ones")
    # the loader's material ids: its default material 0, then one a shape in XML order
    mat_of = loaded.shading.mat_id.cpu().numpy()
    _require(np.array_equal(mat_of, written_mat[order] + 1),
             "the loaded scene's materials are not the written shapes'")
    # every difference from build_big_scene's arrays, by field
    def rows(v):   # triangles as sorted byte strings: equal sets of equal triangles
        return np.sort(np.ascontiguousarray(v, np.float32).reshape(v.shape[0], -1)
                       .view(np.dtype((np.void, 36))).ravel())

    bt = big.bvh.tri_index.long().cpu().numpy()
    same_tris = np.array_equal(rows(written[:-2]), rows(tris))

    def effective(scene, mids):
        m, tx = scene.materials, scene.textures.color_a.cpu().numpy()
        cols = {f: getattr(m, f).cpu().numpy()[mids] for f in
                ("bsdf_type", "dist_type", "alpha_u", "alpha_v", "cond_eta", "cond_k")}
        cols["albedo"] = tx[m.tex_albedo.cpu().numpy()[mids]]
        cols["specular"] = tx[m.tex_specular.cpu().numpy()[mids]]
        return cols

    first = {mm: int(np.nonzero(written_mat[order] == mm)[0][0]) for mm in range(3)}
    big_first = {mm: int(np.nonzero(mat_id[bt] == mm)[0][0]) for mm in range(3)}
    eff_l = effective(loaded, mat_of[[first[mm] for mm in range(3)]])
    eff_b = effective(big, big.shading.mat_id.cpu().numpy()[[big_first[mm] for mm in range(3)]])
    eff_diff = [f for f in eff_l if not np.array_equal(eff_l[f], eff_b[f])]
    diffs = dict(
        woop_rows=[int(loaded.bvh.woop.shape[0]), int(big.bvh.woop.shape[0])],
        triangles=[int(written.shape[0]), int(tris.shape[0])],
        same_triangles_but_the_light=bool(same_tris),
        triangle_order="by material (one shape each), then the light's 2",
        light_geometry="2 emitting triangles (black diffuse) in the BVH, so BSDF-sampled "
                       "paths reach the light (MIS); build_big_scene's light is its record only",
        materials=[int(loaded.materials.bsdf_type.shape[0]),
                   int(big.materials.bsdf_type.shape[0])],
        textures=[int(loaded.textures.ttype.shape[0]), int(big.textures.ttype.shape[0])],
        effective_material_fields_differing=eff_diff,
        lights_equal=bool(torch.equal(loaded.lights.ltype.cpu(), big.lights.ltype.cpu())
                          and torch.equal(loaded.lights.radiance.cpu(),
                                          big.lights.radiance.cpu())),
        camera_equal=bool(all(torch.equal(getattr(loaded.camera, f).cpu(),
                                          getattr(big.camera, f).cpu())
                              for f in ("to_world", "tan_half_fov", "aspect"))))
    print(f"[io] loaded bench config 3 vs build_big_scene: {json.dumps(diffs)}; geometry "
          f"generated in {t_gen:.2f} s")
    _require(same_tris and not eff_diff and diffs["camera_equal"],
             f"the loaded bench config 3 differs from build_big_scene beyond the listed: {diffs}")
    cfg3 = pt.specialize_config(loaded, pt.PTConfig(max_depth=DEPTH))
    wf.render_wavefront_counted(loaded, BIG_W, BIG_H, BIG_SPP, 0, cfg3)   # warm, as phase 15
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    img, rays = wf.render_wavefront_counted(loaded, BIG_W, BIG_H, BIG_SPP, 7, cfg3)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launch = counts()
    m = float(img.mean())
    rel = m / big_pass["mean"] - 1
    print(f"[main path] loaded bench config 3 {BIG_W}x{BIG_H} spp {BIG_SPP} depth {DEPTH} "
          f"seed 7: mean {m:.6f} (build_big_scene {big_pass['mean']:.6f}, {100 * rel:+.4f}%, "
          f"gate {BIG_TOL:.0%}), rays {int(rays)} ({big_pass['rays']}), {dt:.4f} s "
          f"({int(rays) / dt / 1e6:.3f} Mrays/s); launches {json.dumps(launch)}; {smi}")
    _require(bool(torch.isfinite(img).all()) and abs(rel) <= BIG_TOL,
             f"the loaded bench config 3 pass mean {m} is not within {BIG_TOL:.0%} of "
             f"build_big_scene's {big_pass['mean']}")
    _require(launch["intersect_bvh"]["closest"] > 0 and launch["intersect_bvh"]["any_hit"] > 0,
             f"the loaded scene's pass did not launch intersect_bvh for both ray kinds: {launch}")
    out.update(big=dict(loads=loads, diffs=diffs, mean=m, rel=rel, rays=int(rays), dt=dt,
                        launches=launch))
    del scenes
    # the OBJ loader at BIG_PIN's size (pure-Python parsing)
    ptris, pmat = bigscene._big_geometry(BIG_PIN["n_tris"], 0)
    obj_path = os.path.join(d, "pin.obj")
    t0 = time.perf_counter()
    with open(obj_path, "w") as f:
        base = 0
        for mm in range(3):
            verts, faces = ic.indexed(ptris[pmat == mm])
            f.write("".join(f"v {x!r} {y!r} {z!r}\n" for x, y, z in verts.tolist()))
            f.write(f"usemtl m{mm}\n")
            f.write("".join(f"f {a + 1 + base} {b + 1 + base} {c + 1 + base}\n"
                            for a, b, c in faces.tolist()))
            base += len(verts)
    t_obj_write = time.perf_counter() - t0
    with open(os.path.join(d, "pin.xml"), "w") as f:
        f.write('<scene version="0.5.0"><shape type="obj"><string name="filename" '
                'value="pin.obj"/></shape><emitter type="constant"/></scene>')
    t0 = time.perf_counter()
    pin_scene = tmi.load_mitsuba(os.path.join(d, "pin.xml"))
    torch.cuda.synchronize()
    t_obj = time.perf_counter() - t0
    pw = np.concatenate([ptris[pmat == mm] for mm in range(3)])
    _require(torch.equal(pin_scene.shading.verts.cpu(),
                         torch.from_numpy(pw[pin_scene.bvh.tri_index.long().cpu().numpy()])),
             "the OBJ scene's triangles are not the written ones")
    print(f"[io] OBJ at {BIG_PIN['n_tris']} tris target ({pw.shape[0]} triangles): written in "
          f"{t_obj_write:.2f} s, loaded through an XML on the card in {t_obj:.2f} s "
          f"(load_obj parses in Python)")
    out["obj"] = dict(tris=int(pw.shape[0]), load_s=t_obj, write_s=t_obj_write)
    del pin_scene
    part("b")

    # (c) the media-and-maps XML against JAX's CPU means
    path_c = ic.write_media_maps(d)
    t0 = time.perf_counter()
    scene_c, media_c = tmi.load_mitsuba_full(path_c)
    torch.cuda.synchronize()
    t_c = time.perf_counter() - t0
    p = ic.PIN
    reset_counts()
    img_c = pt.render(scene_c, p["size"], p["size"], p["spp"], p["seed"],
                      pt.PTConfig(max_depth=p["max_depth"]))
    vol_c = volpath.render_vol(scene_c, media_c, p["size"], p["size"], p["spp"], p["seed"],
                               pt.PTConfig(max_depth=p["vol_depth"]))
    torch.cuda.synchronize()
    launch_c = counts()
    pins_c = {}
    for name, im in (("render", img_c), ("render_vol", vol_c)):
        ref, tol = IO_PINS[name]
        mc = float(im.detach().mean())
        pins_c[name] = mc / ref - 1
        print(f"[pin] media-and-maps {name} ({p['size']}x{p['size']}, {p['spp']} spp, seed "
              f"{p['seed']}): mean {mc:.9f} (JAX {ref}, {100 * pins_c[name]:+.5f}%, gate "
              f"{tol:.2%})")
        _require(bool(torch.isfinite(im).all()) and abs(pins_c[name]) <= tol,
                 f"media-and-maps {name} mean {mc} is not within {tol:.2%} of JAX's {ref}")
    _require(launch_c["intersect_dense"]["closest"] > 0,
             f"the media-and-maps renders did not launch intersect_dense: {launch_c}")
    print(f"[io] media-and-maps XML loaded in {t_c:.2f} s ({int(scene_c.bvh.woop.shape[0])} "
          f"rows, {int(media_c.active.sum())} medium); launches {json.dumps(launch_c)}")
    out["media"] = dict(load_s=t_c, pins=pins_c, launches=launch_c)
    part("c")

    # (d) the entry points as subprocesses, in parallel
    big_xml = os.path.join(d, "big_ply.xml")
    ck, ck2 = os.path.join(d, "ck.npz"), os.path.join(d, "ck_straight.npz")
    cli = ["-m", "cudatracerlib_tpu_torch.cli"]
    small = ["--size", "64", "--spp", "4"]

    def resumed():
        a = _run(cli + ["cornell", "2", "PT", *small, "--checkpoint", ck, "--out",
                        os.path.join(d, "ck2.png")])
        b = _run(cli + ["cornell", "4", "PT", *small, "--checkpoint", ck, "--out",
                        os.path.join(d, "ck4.png")])
        return a[0] or b[0], a[1] + b[1], a[2] + b[2]

    jobs = {
        "cornell PT": lambda: _run(cli + ["cornell", "2", "PT", "--size", "256", "--spp", "16",
                                          "--out", os.path.join(d, "cli_pt.png")]),
        "bench config 3 XML fast": lambda: _run(cli + [big_xml, "2", "fast", "--size", "512",
                                                       "--out", os.path.join(d, "cli_fast.png")]),
        "checkpoint 2 + 2": resumed,
        "straight 4": lambda: _run(cli + ["cornell", "4", "PT", *small, "--checkpoint", ck2,
                                          "--out", os.path.join(d, "st4.png")]),
        "inverse example": lambda: _run(["examples/inverse_rendering_torch.py", "--steps", "5"]),
    }
    with ThreadPoolExecutor(len(jobs)) as pool:
        res = dict(zip(jobs, pool.map(lambda f: f(), jobs.values())))
    for k, (rc, wall, stdout) in res.items():
        passes = [ln for ln in stdout.splitlines() if ln.startswith(("pass ", "step "))]
        print(f"[cli] {k}: exit {rc}, {wall:.1f} s; {' | '.join(passes)}")
        _require(rc == 0, f"{k} exited {rc}")
    for png in ("cli_pt.png", "cli_fast.png", "ck4.png", "st4.png"):
        _require(os.path.getsize(os.path.join(d, png)) > 0, f"{png} was not written")
    _require(all(any(ln.startswith("pass ") for ln in res[k][2].splitlines())
                 for k in ("cornell PT", "bench config 3 XML fast")),
             "the CLI printed no pass times")
    za, zb = np.load(ck, allow_pickle=True), np.load(ck2, allow_pickle=True)
    ck_diff = float(np.abs(za["leaf_0"] - zb["leaf_0"]).max())
    print(f"[cli] --checkpoint: 2 passes resumed to {int(za['leaf_1'])} vs a straight "
          f"{int(zb['leaf_1'])}: max abs difference {ck_diff}")
    _require(ck_diff == 0.0 and int(za["leaf_1"]) == 4, "the resumed run differs from a straight run")
    losses = [float(x) for x in res["inverse example"][2].split("losses:")[1].split()]
    print(f"[cli] inverse example losses {losses}")
    _require(len(losses) == 5 and losses[-1] < losses[0], f"the inverse loss did not fall: {losses}")
    out["cli"] = dict(walls={k: v[1] for k, v in res.items()}, checkpoint_diff=ck_diff,
                      losses=losses)
    tmp.cleanup()
    part("d")
    return out


def _capture_intersects(fn, limit=64):
    """(fn's result, [(kind, args)]): the arguments of the first `limit`
    intersect_dense / intersect_bvh wrapper calls in one call of `fn`
    (rays and ranges cloned), kind "dense" or "bvh"; args as the wrappers
    take them, the dense kernel's boxes and vertex rows last."""
    import torch
    from cudatracerlib_tpu_torch.ops import intersect_bvh as bvh_ops
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops

    seen, real_dense, real_bvh = [], ops.intersect_dense, bvh_ops.intersect_bvh
    keep = lambda x: x.clone() if isinstance(x, torch.Tensor) else x  # noqa: E731

    def dense(woop, o, d, t_min=1e-4, t_max=ops.T_MAX_CLAMP, any_hit=False, boxes=None,
                      *, verts):
        if len(seen) < limit:
            seen.append(("dense", (woop, keep(o), keep(d), keep(t_min), keep(t_max), any_hit,
                                   boxes, verts)))
        return real_dense(woop, o, d, t_min, t_max, any_hit=any_hit, boxes=boxes, verts=verts)

    def bvh(b, o, d, t_min=1e-4, t_max=torch.inf, any_hit=False):
        if len(seen) < limit:
            seen.append(("bvh", (b, keep(o), keep(d), keep(t_min), keep(t_max), any_hit)))
        return real_bvh(b, o, d, t_min, t_max, any_hit=any_hit)

    ops.intersect_dense, bvh_ops.intersect_bvh = dense, bvh
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        ops.intersect_dense, bvh_ops.intersect_bvh = real_dense, real_bvh
    return out, seen


def _empty_share(t_min, t_max):
    """The share of lanes whose range (t_min, t_max) is empty."""
    import torch

    if not isinstance(t_max, torch.Tensor) or t_max.dim() == 0:
        return 0.0
    return float((t_max <= torch.as_tensor(t_min, device=t_max.device)).float().mean())


def _instanced_vs_flat(label, inst, flat, o, d):
    """Camera-ray hits of an instanced scene against its flattened twin: on
    >= INSTANCE_AGREE of the rays valid equal and, where both hit, t within
    2e-4 (rtol and atol, tests/test_instances.py's gate). An instance's rays
    are its object-space rays, rounded otherwise than the flattened scene's,
    so a ray on an edge can be decided otherwise (the JAX package's test,
    not watertight, let such rays through): they count against the share.
    Also the intersect
    launches of one closest-hit and one any-hit query."""
    import torch
    from cudatracerlib_tpu_torch.ops import intersect_bvh as bvh_ops
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops
    from cudatracerlib_tpu_torch.scene import scene as scene_mod

    before = sum(ops.launches.values()) + sum(bvh_ops.launches.values())
    hi = scene_mod.scene_intersect(inst, o, d)
    scene_mod.scene_intersect(inst, o, d, t_max=1e30, any_hit=True)
    torch.cuda.synchronize()
    per_bounce = sum(ops.launches.values()) + sum(bvh_ops.launches.values()) - before
    hf = scene_mod.scene_intersect(flat, o, d)
    both = hi.valid & hf.valid
    rel = torch.where(both, (hi.t - hf.t).abs() / (1.0 + hf.t.abs()), 0.0)
    off_t = both & (rel > 2e-4)
    agree = float(((hi.valid == hf.valid) & ~off_t).float().mean())
    terr = float(rel[both & ~off_t].max())
    _require(agree >= INSTANCE_AGREE,
             f"{label}: instanced and flattened agree on {agree} of the rays (gate "
             f"{INSTANCE_AGREE}): valid differs on {int((hi.valid != hf.valid).sum())}, t on "
             f"{int(off_t.sum())}")
    print(f"[instanced vs flat] {label}: {o.shape[0]} camera rays, agree {agree:.7f} (valid "
          f"differs on {int((hi.valid != hf.valid).sum())}, t beyond 2e-4 on {int(off_t.sum())}, "
          f"the worst {float(rel.max()):.3g}), both hit {int(both.sum())}, max t error of the "
          f"rest {terr:.3g} (of 1 + t); one closest + one any-hit query launch {per_bounce} "
          f"intersect kernels (a bounce's)")
    return dict(agree=agree, t_err=terr, t_off=int(off_t.sum()), launches_per_bounce=per_bounce)


def _bwd_calls(fn):
    """(fn's result, {(cols, n_rows): [calls]}, {(cols, n_rows): first
    (g, idx, n_rows) cloned}) of packed_gather_bwd in one call of `fn`."""
    from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops

    calls, first, real = {}, {}, sg_ops.packed_gather_bwd

    def record(g, idx, n_rows):
        key = (int(g.shape[1]), int(n_rows))
        calls[key] = calls.get(key, 0) + 1
        if key not in first:
            first[key] = (g.clone(), idx.clone(), n_rows)
        return real(g, idx, n_rows)

    sg_ops.packed_gather_bwd = record
    try:
        out = fn()
    finally:
        sg_ops.packed_gather_bwd = real
    return out, calls, first


def _dynamic_phase(smi, reset_counts):
    """Phase 24 (module docstring): instanced scenes, BVH refit and skinning,
    adaptive sampling and the engines' counters at full size, their pins,
    and the kernels held to their plain versions at the new shapes."""
    import numpy as np
    import torch
    from cudatracerlib_tpu_torch.accel import bvh as bvh_mod
    from cudatracerlib_tpu_torch.accel import refit as refit_mod
    from cudatracerlib_tpu_torch.accel.bvh import build_bvh
    from cudatracerlib_tpu_torch.ops import intersect_bvh as bvh_ops
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops
    from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops
    from cudatracerlib_tpu_torch.render import adaptive
    from cudatracerlib_tpu_torch.render import path_tracer as pt
    from cudatracerlib_tpu_torch.render import wavefront as wf
    from cudatracerlib_tpu_torch.scene import animation, shade_pack, shapes
    from cudatracerlib_tpu_torch.scene.dynamic import DynamicScene
    from cudatracerlib_tpu_torch.scene.scene import Materials, build_scene
    from cudatracerlib_tpu_torch.scene.sensors import Camera
    from cudatracerlib_tpu_torch.scene.textures import Textures

    dc = _dynamic_cases()
    cfg = pt.PTConfig(max_depth=DEPTH)
    ps, pseed = DYNAMIC_PIN["size"], DYNAMIC_PIN["seed"]
    marks = [time.perf_counter()]

    def part(tag):
        marks.append(time.perf_counter())
        print(f"[wall] phase 24 ({tag}): {marks[-1] - marks[-2]:.1f} s")

    def counts():
        return {"intersect_dense": dict(ops.launches), "intersect_bvh": dict(bvh_ops.launches),
                "shade_gather": dict(sg_ops.launches)}

    def n_intersect(launch):
        return sum(launch["intersect_dense"].values()) + sum(launch["intersect_bvh"].values())

    def pin(name, img, rays):
        ref, ref_rays, tol = DYNAMIC_PINS[name]
        m = float(img.mean())
        _require(bool(torch.isfinite(img).all()), f"the pinned {name} image is not finite")
        _require(abs(m - ref) <= tol * ref,
                 f"pinned {name} mean {m} is not within {tol:.1%} of JAX's {ref}")
        _require(abs(int(rays) - ref_rays) <= 1e-3 * ref_rays,
                 f"pinned {name} rays {int(rays)} are not within 1e-3 of JAX's {ref_rays}")
        print(f"[pin] {name} ({ps}x{ps}, seed {pseed}): mean {m:.9f} (JAX {ref}, "
              f"{100 * (m / ref - 1):+.5f}%), rays {int(rays)} (JAX {ref_rays})")
        return m / ref - 1

    def dense_at(label, captured, reps=10):
        """intersect_dense held to its plain version on captured arguments."""
        woop, o, d, t_min, t_max, _, boxes, verts = captured
        print(f"[ranges] {label}: {_empty_share(t_min, t_max):.4f} of the lanes have an empty "
              f"range (missed the instance's box)")
        return _compare(label, woop, o, d, t_min, t_max, reps, boxes, verts)

    pins, runs, dense_r, bvh_r = {}, {}, {}, {}

    # (a) the instanced _build(8) scene: pin, then config 1's size instanced and flattened
    ds8 = dc.instanced(DynamicScene(), shapes, Camera, 8)
    inst8, flat8 = ds8.update(instancing=True), ds8.update(instancing=False)
    _require(len(inst8.instances) == 3 and not flat8.instances and inst8.bvh.woop.is_cuda,
             "the instanced scene did not build on the card")
    pins["instanced"] = pin("instanced", *pt.render_counted(inst8, ps, ps, 8, pseed, cfg))
    o, d, _, _ = pt.camera_rays(inst8, W, H, SPP, 3)
    cmp8 = _instanced_vs_flat("instanced _build(8)", inst8, flat8, o, d)
    _, cap = _capture_intersects(lambda: pt.render_counted(inst8, W, H, SPP, 0, cfg), limit=11)
    dense_r["instanced camera"] = dense_at("instanced camera rays, cube instance 2", cap[2][1])
    del cap
    for name, scene in (("instanced", inst8), ("flattened", flat8)):
        _, rays = pt.render_counted(scene, W, H, SPP, 7, cfg)
        torch.cuda.synchronize()
        reset_counts()
        dt, img = _timed(lambda scene=scene: pt.render_progressive(scene, W, H, SPP, N_PASS, 7,
                                                                   cfg))
        launch = counts()
        _require(bool(torch.isfinite(img).all()) and launch["intersect_dense"]["closest"] > 0
                 and launch["intersect_dense"]["any_hit"] > 0,
                 f"the {name} passes failed: {launch}")
        prof = _profile(f"{name} _build(8) pass", lambda scene=scene: pt.render(
            scene, W, H, SPP, 7, cfg), top_n=4)
        runs[name] = dict(dt=dt / N_PASS, mrays=int(rays) * N_PASS / dt / 1e6, mean=float(
            img.mean()), idle=prof["idle"], launches=launch, all_launches=prof["launches"])
        print(f"[main path] {name} _build(8) {W}x{H} spp {SPP} depth {DEPTH}, {N_PASS} passes: "
              f"{dt:.4f} s, {runs[name]['mrays']:.3f} Mrays/s ({int(rays)} rays a pass at seed 7), "
              f"mean {runs[name]['mean']:.6f}, idle {prof['idle']:.3f}, {prof['launches']} kernel "
              f"launches a pass; port launches over the passes {json.dumps(launch)}; {smi}")
    m_i, m_f = runs["instanced"]["mean"], runs["flattened"]["mean"]
    _require(abs(m_i - m_f) <= 0.01 * m_f,
             f"instanced mean {m_i} is not within 1% of the flattened {m_f}")
    part("a")

    # (b) the 300-instance forest: camera rays instanced vs flattened, one pass
    ds_f, _ = dc.forest(DynamicScene(), shapes, Camera)
    inst_f, flat_f = ds_f.update(instancing=True), ds_f.update(instancing=False)
    o, d, _, _ = pt.camera_rays(flat_f, W, H, SPP, 3)
    cmp_f = _instanced_vs_flat("forest (301 instances)", inst_f, flat_f, o, d)
    del o, d
    for name, scene in (("forest instanced", inst_f), ("forest flattened", flat_f)):
        reset_counts()
        dt, (img, rays) = _timed(lambda scene=scene: pt.render_counted(scene, W, H, SPP, 7, cfg))
        launch = counts()
        _require(bool(torch.isfinite(img).all()) and n_intersect(launch) > 0,
                 f"the {name} pass failed: {launch}")
        runs[name] = dict(dt=dt, mrays=int(rays) / dt / 1e6, mean=float(img.mean()),
                          launches=launch)
        print(f"[main path] {name} {W}x{H} spp {SPP} depth {DEPTH} seed 7: {dt:.4f} s, "
              f"{int(rays) / dt / 1e6:.3f} Mrays/s, mean {float(img.mean()):.6f}; intersect "
              f"launches {n_intersect(launch)} ({n_intersect(launch) / DEPTH:.1f} a bounce); "
              f"{json.dumps(launch)}; {smi}")
    _require(abs(runs["forest instanced"]["mean"] - runs["forest flattened"]["mean"])
             <= 0.01 * runs["forest flattened"]["mean"], "the forest's means differ by over 1%")
    _require(shade_pack.pack_enabled(flat_f), "the flattened forest is not in the shade pack's band")
    _, gathers = _capture_gathers(lambda: pt.render_counted(flat_f, W, H, SPP, 0, cfg))
    gather_r = _check_gather_at("flattened forest pack", *gathers[0])
    del gathers
    part("b")

    # (c) a BLAS above the dense band: 16 instances of a 16,128-triangle sphere
    ds_s = dc.spheres(DynamicScene(), shapes, Camera)
    inst_s = ds_s.update(instancing=True)
    t0 = time.perf_counter()
    flat_s = ds_s.update(instancing=False)
    t_build = time.perf_counter() - t0
    _require(int(inst_s.blas[0].bvh.woop.shape[0]) > 4096, "the sphere BLAS is in the dense band")
    o, d, _, _ = pt.camera_rays(flat_s, W, H, SPP, 3)
    cmp_s = _instanced_vs_flat("16 spheres", inst_s, flat_s, o, d)
    _, cap = _capture_intersects(lambda: pt.render_counted(inst_s, W, H, SPP, 0, cfg), limit=18)
    kind, (b, co, cd, tmin, tmax, _) = cap[5]
    _require(kind == "bvh", "the sphere instance's call is not the BVH kernel's")
    empty = _empty_share(tmin, tmax)
    print(f"[ranges] sphere instance 5 camera rays: {empty:.4f} of the lanes have an empty range")
    bvh_r["sphere instance"] = _compare_bvh("sphere instance 5 camera rays (per-lane ranges)", b,
                                            co, cd, tmin, tmax, 10)
    bvh_r["sphere instance"]["empty"] = empty
    del cap, co, cd
    for name, scene in (("spheres instanced", inst_s), ("spheres flattened", flat_s)):
        reset_counts()
        dt, (img, rays) = _timed(lambda scene=scene: pt.render_counted(scene, W, H, SPP, 7, cfg))
        launch = counts()
        _require(bool(torch.isfinite(img).all()) and launch["intersect_bvh"]["closest"] > 0,
                 f"the {name} pass failed: {launch}")
        runs[name] = dict(dt=dt, mrays=int(rays) / dt / 1e6, mean=float(img.mean()),
                          launches=launch)
        print(f"[main path] {name} {W}x{H} spp {SPP} depth {DEPTH} seed 7: {dt:.4f} s, "
              f"{int(rays) / dt / 1e6:.3f} Mrays/s, mean {float(img.mean()):.6f}; "
              f"{json.dumps(launch)}; {smi}")
    _require(abs(runs["spheres instanced"]["mean"] - runs["spheres flattened"]["mean"])
             <= 0.01 * runs["spheres flattened"]["mean"], "the spheres' means differ by over 1%")
    print(f"[build] the flattened spheres ({int(flat_s.bvh.woop.shape[0])} Woop rows): "
          f"{t_build:.2f} s; the instanced scene holds {int(inst_s.shading.verts.shape[0])} rows")
    del flat_s
    part("c")

    # (d) skinned spheres: in the dense band and above it
    anim, rigs = {}, {}
    for name, (nt, nph) in (("dense", (24, 48)), ("bvh", (64, 128))):
        inputs = dc.skinned_inputs(shapes, nt, nph)
        scene = dc.build_skinned(inputs, build_scene, Materials, Textures, Camera)
        _, host = build_bvh(inputs["vertices"], with_host=True)
        mesh = animation.make_skinned(scene, host["nodes"], host["root"],
                                      *dc.rig(scene.shading.verts.cpu().numpy()))
        rigs[name] = scene, mesh
        spec = pt.specialize_config(scene, cfg)
        _require(not spec.flat_shading, f"the skinned {name} sphere is flat-shaded")
        pins[f"skinned_{name}"] = pin(f"skinned_{name}", *pt.render_counted(
            animation.animate_scene(scene, mesh, torch.from_numpy(dc.pose(DYNAMIC_PIN["pose"]))
                                    .cuda()), ps, ps, 4, pseed, cfg))
        refit_ms, pass_s, rays_sum = [], 0.0, 0
        reset_counts()
        for k in range(dc.POSES):
            pose = torch.from_numpy(dc.pose(k)).cuda()
            verts = animation.skin_vertices(mesh, pose)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bvh_k = refit_mod.refit_bvh(scene.bvh, mesh.plan, verts)
            torch.cuda.synchronize()
            refit_ms.append((time.perf_counter() - t0) * 1e3)
            posed = animation.animate_scene(scene, mesh, pose)
            dt, (img, rays) = _timed(lambda posed=posed: pt.render_counted(posed, W, H, SPP, 7,
                                                                           cfg))
            _require(bool(torch.isfinite(img).all()), f"pose {k} of the {name} sphere failed")
            pass_s += dt
            rays_sum += int(rays)
        launch = counts()
        print(f"[main path] skinned {name} sphere ({int(scene.bvh.woop.shape[0])} Woop rows), "
              f"{dc.POSES} poses, each skin -> refit -> a {W}x{H} spp {SPP} pass: refit alone "
              f"{_median(refit_ms):.3f} ms (min {min(refit_ms):.3f}, max {max(refit_ms):.3f}; "
              f"{len(mesh.plan.level_nodes)} levels), passes {pass_s / dc.POSES:.4f} s each, "
              f"{rays_sum / pass_s / 1e6:.3f} Mrays/s; launches {json.dumps(launch)}; {smi}")
        # refitted against rebuilt on the last pose's camera rays: the rebuilt
        # tree (a fresh SBVH over the posed triangles) carries the same
        # closed-form rows as the refitted one, so the two differ only in their
        # nodes and the comparison is phase 3's / 5's
        posed = animation.animate_scene(scene, mesh, pose)
        rebuilt = build_bvh(posed.shading.verts.detach().cpu().numpy())
        tri_re = posed.shading.verts.detach()[rebuilt.tri_index.long()]
        woop_re = refit_mod.woop_transform_device(tri_re)
        rebuilt = rebuilt._replace(woop=woop_re, chunk_boxes=bvh_mod.chunk_boxes(tri_re, woop_re),
                                   tri_verts=bvh_mod.vertex_rows(tri_re))
        o, d, _, _ = pt.camera_rays(posed, W, H, SPP, 3)
        from cudatracerlib_tpu_torch.accel import traversal
        h_refit = traversal.intersect_auto(posed.bvh, o, d)
        h_re = traversal.intersect_auto(rebuilt, o, d)
        h_re = h_re._replace(prim=torch.where(h_re.valid, rebuilt.tri_index[
            torch.clamp(h_re.prim, min=0).long()], -1).to(torch.int32))
        torch.cuda.synchronize()
        r = ops.compare_hits(h_refit, h_re, posed.bvh.woop, 1e-4, torch.inf)
        t_scale = float(torch.clamp(h_re.t[h_re.valid].abs().max(), min=1.0))
        err = _check_hits(f"skinned {name} refitted vs rebuilt", "closest", r, t_scale)
        rec = dict(refit_ms=_median(refit_ms), pass_s=pass_s / dc.POSES,
                   mrays=rays_sum / pass_s / 1e6, launches=launch, vs_rebuilt_err=err,
                   rows=int(scene.bvh.woop.shape[0]), levels=len(mesh.plan.level_nodes))
        if name == "dense":
            dense_r["refitted sphere"] = _compare("refitted sphere camera rays (refitted boxes)",
                                                  posed.bvh.woop, o, d, 1e-4, torch.inf, 10,
                                                  posed.bvh.chunk_boxes, posed.bvh.tri_verts)
        else:
            bvh_r["refitted sphere"] = _compare_bvh("refitted sphere camera rays", posed.bvh, o,
                                                    d, 1e-4, torch.inf, 10)
            _, n_in_re, _, _ = bvh_ops.intersect_bvh_plain(rebuilt, o, d, 1e-4, torch.inf,
                                                           with_counts=True)
            _, n_in_rf, _, _ = bvh_ops.intersect_bvh_plain(posed.bvh, o, d, 1e-4, torch.inf,
                                                           with_counts=True)
            ms_re = _bvh_kernel_ms(rebuilt, o, d, 1e-4, torch.inf, 10)
            rec.update(visits_refit=int(n_in_rf.sum()), visits_rebuilt=int(n_in_re.sum()),
                       ms_refit=bvh_r["refitted sphere"]["ms"], ms_rebuilt=ms_re)
            print(f"[refit] skinned bvh sphere, pose {k} camera rays: inner-node visits refitted "
                  f"{int(n_in_rf.sum())} (mean {float(n_in_rf.double().mean()):.2f}), rebuilt "
                  f"{int(n_in_re.sum())} (mean {float(n_in_re.double().mean()):.2f}), ratio "
                  f"{int(n_in_rf.sum()) / max(1, int(n_in_re.sum())):.3f}; the BVH kernel "
                  f"{bvh_r['refitted sphere']['ms']:.4f} ms refitted, {ms_re:.4f} ms rebuilt")
        anim[name] = rec
        del o, d, h_refit, h_re, rebuilt
    # the pose gradient: the pin on the small sphere, then a full-size pass on the sphere above
    # the dense band (outside the shade pack's band too, so the cotangent reaches the verts
    # through make_interaction's gathers and the Woop rows through refine_hit)
    gi = dc.skinned_inputs(shapes, POSE_GRAD["n_theta"], POSE_GRAD["n_phi"])
    gscene = dc.build_skinned(gi, build_scene, Materials, Textures, Camera)
    _, ghost = build_bvh(gi["vertices"], with_host=True)
    gmesh = animation.make_skinned(gscene, ghost["nodes"], ghost["root"],
                                   *dc.rig(gscene.shading.verts.cpu().numpy()))
    gcfg = pt.PTConfig(max_depth=POSE_GRAD["max_depth"], rr_start=POSE_GRAD["rr_start"])

    def pose_loss(scene_, mesh_, size, spp, seed):
        p = torch.from_numpy(dc.pose(DYNAMIC_PIN["pose"])).cuda().requires_grad_()
        loss = pt.render(animation.animate_scene(scene_, mesh_, p), size, size, spp, seed,
                         gcfg).mean()
        loss.backward()
        return float(loss.detach()), p.grad

    loss, g = pose_loss(gscene, gmesh, ps, POSE_GRAD["spp"], POSE_GRAD["seed"])
    ref = np.asarray(REF_POSE_GRAD, np.float64).reshape(2, 4, 4)
    g = g.double().cpu().numpy()
    gerr = np.abs(g - ref) - (1e-3 * np.abs(ref) + 1e-3 * np.abs(ref).max())
    _require(abs(loss - REF_POSE_LOSS) <= 1e-4 * REF_POSE_LOSS and bool((gerr <= 0).all()),
             f"the pose gradient misses JAX's: loss {loss} (JAX {REF_POSE_LOSS}), worst entry "
             f"{float(np.abs(g - ref).max())}")
    print(f"[pin] pose gradient ({ps}x{ps}, {POSE_GRAD}): loss {loss:.9f} (JAX {REF_POSE_LOSS}), "
          f"max |g - JAX| {float(np.abs(g - ref).max()):.3g} ({float(np.abs(g - ref).max()) / float(np.abs(ref).max()):.3g} "
          f"of the largest entry)")
    reset_counts()
    big_scene, big_mesh = rigs["bvh"]
    _require(not shade_pack.pack_enabled(big_scene),
             "the big skinned sphere is in the shade pack's band")
    n_rows = int(big_scene.bvh.woop.shape[0])
    t0 = time.perf_counter()
    (gl, gg), bwd_calls, bwd_first = _bwd_calls(lambda: pose_loss(big_scene, big_mesh, W, SPP, 7))
    torch.cuda.synchronize()
    gdt = time.perf_counter() - t0
    glaunch = counts()
    _require(bool(torch.isfinite(gg).all()) and float(gg.abs().max()) > 0
             and (12, n_rows) in bwd_calls and (9, n_rows) in bwd_calls,
             f"the full-size pose gradient pass failed: calls {bwd_calls}, launches {glaunch}")
    print(f"[grad pass] skinned sphere ({n_rows} rows) {W}x{H} spp {SPP} d mean / d pose: loss "
          f"{gl:.6f}, "
          f"forward+backward {gdt:.3f} s; packed_gather_bwd calls by (columns, rows) "
          f"{ {str(k): v for k, v in bwd_calls.items()} }; launches {json.dumps(glaunch)}; {smi}")
    woop_r = _check_bwd_captured("Woop (pose gradient)", *bwd_first[(12, n_rows)],
                                 big_scene.bvh.woop.device)
    verts_r = _check_bwd_captured("verts (pose gradient)", *bwd_first[(9, n_rows)],
                                  big_scene.bvh.woop.device)
    del bwd_first
    torch.cuda.empty_cache()
    part("d")

    # (e) adaptive sampling: the pins, then config 1's Cornell and config 2's glossy sizes
    from cudatracerlib_tpu_torch.scene.shapes import cornell_box, glossy_scene

    cornell, glossy = cornell_box(), glossy_scene()
    for name, fn, ref, tol in (
            ("adaptive", lambda: adaptive.render_adaptive_host(cornell, ps, ps, 4, 3, pseed, cfg),
             REF_ADAPTIVE_MEAN, 0.005),
            ("adaptive_wf", lambda: adaptive.render_wavefront_adaptive(
                glossy, ADAPTIVE_WF_PIN, ADAPTIVE_WF_PIN, 4, 3, pseed, cfg),
             REF_ADAPTIVE_WF_MEAN, 0.01)):
        m = float(fn().mean())
        _require(abs(m - ref) <= tol * ref, f"pinned {name} mean {m} not within {tol:.1%} of {ref}")
        pins[name] = m / ref - 1
        print(f"[pin] {name}: mean {m:.9f} (JAX {ref}, {100 * pins[name]:+.5f}%)")
    for name, fn in (
            ("adaptive cornell", lambda: adaptive.render_adaptive_host(cornell, W, H, SPP, N_PASS,
                                                                       7, cfg, warmup=1)),
            ("adaptive glossy wavefront", lambda: adaptive.render_wavefront_adaptive(
                glossy, W, H, SPP, N_PASS, 7, cfg))):
        fn()   # warm
        torch.cuda.synchronize()
        reset_counts()
        dt, img = _timed(fn)
        launch = counts()
        _require(bool(torch.isfinite(img).all()) and n_intersect(launch) > 0,
                 f"the {name} render failed: {launch}")
        runs[name] = dict(dt=dt / N_PASS, mean=float(img.mean()), launches=launch)
        print(f"[main path] {name} {W}x{H} spp {SPP}, {N_PASS} passes / waves, seed 7: {dt:.4f} s "
              f"({dt / N_PASS:.4f} s a pass), mean {float(img.mean()):.6f}; launches "
              f"{json.dumps(launch)}; {smi}")
    _require(runs["adaptive glossy wavefront"]["launches"]["shade_gather"]["gather"] > 0
             and runs["adaptive glossy wavefront"]["launches"]["intersect_bvh"]["closest"] > 0,
             "the adaptive glossy waves did not launch intersect_bvh and packed_gather")
    part("e")

    # (f) the counters, and the fixed-shape refill's host reads
    img_c, c = pt.render_with_counters(cornell, W, H, SPP, 3, cfg)
    _, rays_c = pt.render_counted(cornell, W, H, SPP, 3, cfg)
    img_w, cw = wf.render_wavefront_with_counters(glossy, W, H, SPP * N_PASS, 3, cfg)
    _, rays_w = wf.render_wavefront_counted(glossy, W, H, SPP * N_PASS, 3, cfg)
    _require(int(c["n_nonfinite"]) == 0 and int(cw["n_nonfinite"]) == 0
             and int(c["n_rays"]) == int(rays_c) and int(cw["n_rays"]) == int(rays_w),
             f"counters: {c} (render_counted {int(rays_c)}), {cw} (render_wavefront_counted "
             f"{int(rays_w)})")
    print(f"[counters] render_with_counters cornell {W}x{H} spp {SPP} seed 3: n_rays "
          f"{int(c['n_rays'])} (render_counted {int(rays_c)}), n_nonfinite {int(c['n_nonfinite'])}; "
          f"render_wavefront_with_counters glossy {W}x{H} spp {SPP * N_PASS} seed 3: n_rays "
          f"{int(cw['n_rays'])} (render_wavefront_counted {int(rays_w)}), n_nonfinite "
          f"{int(cw['n_nonfinite'])}, n_iters {cw['n_iters']} (one host read an iteration)")
    part("f")
    return dict(pins=pins, runs=runs, dense=dense_r, bvh=bvh_r, gather=gather_r, anim=anim,
                cmp=dict(instanced=cmp8, forest=cmp_f, spheres=cmp_s), woop=woop_r, verts=verts_r,
                bwd_calls=bwd_calls, grad_launches=glaunch,
                counters=dict(n_rays=int(c["n_rays"]), wf_rays=int(cw["n_rays"]),
                              n_iters=cw["n_iters"]))


def _engines_cases():
    """tools/engines_cases.py (numpy only), imported from the checkout."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import engines_cases

    return engines_cases


def _count_lanes(fn):
    """(fn's result, {"closest": lanes, "any_hit": lanes}): the rays given
    to the intersect wrappers (intersect_dense, intersect_bvh) in one call
    of `fn`, every lane of each call counted."""
    import torch
    from cudatracerlib_tpu_torch.ops import intersect_bvh as bvh_ops
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops

    lanes = {"closest": 0, "any_hit": 0}
    real_dense, real_bvh = ops.intersect_dense, bvh_ops.intersect_bvh

    def dense(woop, o, d, t_min=1e-4, t_max=ops.T_MAX_CLAMP, any_hit=False, boxes=None,
                      *, verts):
        lanes["any_hit" if any_hit else "closest"] += o.shape[0]
        return real_dense(woop, o, d, t_min, t_max, any_hit=any_hit, boxes=boxes, verts=verts)

    def bvh(b, o, d, t_min=1e-4, t_max=torch.inf, any_hit=False):
        lanes["any_hit" if any_hit else "closest"] += o.shape[0]
        return real_bvh(b, o, d, t_min, t_max, any_hit=any_hit)

    ops.intersect_dense, bvh_ops.intersect_bvh = dense, bvh
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        ops.intersect_dense, bvh_ops.intersect_bvh = real_dense, real_bvh
    return out, lanes


def _chroma(img):
    """tests/test_spectral.py's chroma: |R - B| over the brightest decile of
    a 3x3 box-blurred image (numpy), relative to its luminance."""
    import numpy as np

    k = np.ones((3, 3)) / 9.0
    sm = np.stack([np.real(np.fft.ifft2(np.fft.fft2(img[..., c]) * np.fft.fft2(k, img.shape[:2])))
                   for c in range(3)], -1)
    lum = sm.mean(-1)
    m = lum > np.percentile(lum, 90)
    return float((np.abs(sm[..., 0] - sm[..., 2]) * m).sum() / max((lum * m).sum(), 1e-9))


def _block_gap(a, b, k=4):
    """tests/test_guided.py's relative L1 gap of two images' k x k block means."""
    import numpy as np

    h, w, _ = a.shape
    bm = lambda x: x.reshape(h // k, k, w // k, k, 3).mean((1, 3))  # noqa: E731
    return float(np.abs(bm(a) - bm(b)).sum() / np.abs(bm(b)).sum())


def _engines_phase(big, smi, reset_counts):
    """Phase 25 (module docstring): the spectral, guided, realtime and AOV
    engines and generate_fits at full size, their pins from
    tools/engines_reference_mean.py, and the kernels held to their plain
    versions at the new shapes."""
    import numpy as np
    import torch
    from cudatracerlib_tpu_torch.accel import hashgrid
    from cudatracerlib_tpu_torch.math import rough_transmittance as rt
    from cudatracerlib_tpu_torch.ops import intersect_bvh as bvh_ops
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops
    from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops
    from cudatracerlib_tpu_torch.render import guided, prim_tracer, realtime
    from cudatracerlib_tpu_torch.render import path_tracer as pt
    from cudatracerlib_tpu_torch.render import spectral as sr
    from cudatracerlib_tpu_torch.scene import media as media_mod
    from cudatracerlib_tpu_torch.scene import shade_pack, shapes

    ec = _engines_cases()
    PTC = pt.PTConfig
    marks = [time.perf_counter()]

    def part(tag):
        marks.append(time.perf_counter())
        print(f"[wall] phase 25 ({tag}): {marks[-1] - marks[-2]:.1f} s")

    def counts():
        return {"intersect_dense": dict(ops.launches), "intersect_bvh": dict(bvh_ops.launches),
                "shade_gather": dict(sg_ops.launches)}

    def add(total, launch):
        for k, v in launch.items():
            for kk, n in v.items():
                total.setdefault(k, {}).setdefault(kk, 0)
                total[k][kk] += n

    def timed_counted(fn):
        """(wall s, result, launches) of one call, the counts reset just
        before and read just after."""
        torch.cuda.synchronize()
        reset_counts()
        dt, out = _timed(fn)
        return dt, out, counts()

    def pin(name, value, ref, tol):
        _require(np.isfinite(value) and abs(value - ref) <= tol * abs(ref),
                 f"pinned {name} {value} is not within {tol:.2%} of JAX's {ref}")
        print(f"[pin] {name}: {value:.9f} (JAX {ref}, {100 * (value / ref - 1):+.5f}%)")
        return value / ref - 1

    pins, runs, dense_r, launch_all = {}, {}, {}, {}
    cornell, caustic = shapes.cornell_box(), shapes.caustic_scene()
    disp = ec.with_cauchy(caustic, ec.DISP_C)

    # (a) spectral surfaces: pins, then bench config 1's size on both scenes
    p = ec.PIN["spectral"]
    cfg_p = PTC(max_depth=p["max_depth"])
    for name, scene in (("spectral_cornell", cornell), ("spectral_caustic", disp)):
        img = sr.render_spectral(scene, p["size"], p["size"], p["spp"], p["seed"], cfg_p)
        pins[name] = pin(f"{name} ({p['size']}^2, {p['spp']} spp, seed {p['seed']})",
                         float(img.mean()), ENGINE_PINS[name], ENGINE_TOL)
    cfg = PTC(max_depth=DEPTH)
    imgs = {}
    for name, scene in (("spectral cornell", cornell), ("spectral caustic", caustic),
                        ("spectral dispersive", disp)):
        sr.render_spectral(scene, W, H, SPP, 0, cfg)                       # warm
        (dt, img, launch), lanes = _count_lanes(lambda scene=scene: timed_counted(
            lambda: sr.render_spectral(scene, W, H, SPP, 7, cfg)))
        _require(bool(torch.isfinite(img).all()) and launch["intersect_dense"]["closest"] > 0
                 and launch["intersect_dense"]["any_hit"] > 0, f"{name} pass failed: {launch}")
        rays = lanes["closest"] + lanes["any_hit"]
        imgs[name] = img.cpu().numpy()
        runs[name] = dict(dt=dt, rays=rays, mrays=rays / dt / 1e6, mean=float(img.mean()),
                          launches=launch)
        add(launch_all, launch)
        print(f"[main path] {name} {W}x{H} spp {SPP} depth {DEPTH}, seed 7: {dt:.4f} s, "
              f"{rays} ray lanes traced ({lanes}), {rays / dt / 1e6:.3f} Mrays/s, mean "
              f"{runs[name]['mean']:.6f}; launches {json.dumps(launch)}; {smi}")
    ch_a, ch_d = _chroma(imgs["spectral caustic"]), _chroma(imgs["spectral dispersive"])
    _require(ch_d > 1.35 * ch_a, f"dispersion does not separate red and blue: chroma {ch_d} "
                                 f"dispersive vs {ch_a} achromatic (gate 1.35x)")
    print(f"[check] dispersion separates the channels: chroma {ch_d:.5f} dispersive vs "
          f"{ch_a:.5f} achromatic ({ch_d / ch_a:.3f}x, gate 1.35x)")
    with torch.no_grad():   # the dispersive pass's lanes, with the gate's count
        o, d, _, smp, lam, _ = sr._camera_lam(disp, W, H, SPP, 7)
        n_gate = sr.trace_radiance_spectral(disp, o, d, lam, smp, pt.specialize_config(disp, cfg),
                                            with_gate=True)[2]
        del o, d, smp, lam
    print(f"[check] guarded continue gate on the dispersive pass: {int(n_gate)} lanes stopped "
          f"where JAX's gate continues them")
    prof = _profile("spectral dispersive pass", lambda: sr.render_spectral(disp, W, H, SPP, 7,
                                                                           cfg), top_n=6)
    runs["spectral dispersive"]["idle"] = prof["idle"]
    _, cap = _capture_intersects(lambda: sr.render_spectral(disp, W, H, SPP, 0, cfg), limit=2)
    for (kind, args), label in zip(cap, ("spectral caustic camera rays",
                                         "spectral caustic shadow rays")):
        woop, o, d, t_min, t_max, _, boxes, verts = args
        dense_r[label] = _compare(label, woop, o, d, t_min, t_max, 10, boxes, verts)
    del cap
    part("a")

    # (b) spectral gradients: pins, the sigma_s central difference, full-size walls
    q = ec.PIN["grad_radiance"]
    cfg_g = PTC(max_depth=q["max_depth"], rr_start=q["rr_start"])
    rad = cornell.lights.radiance.clone().requires_grad_()
    sr.render_spectral(cornell._replace(lights=cornell.lights._replace(radiance=rad)), q["size"],
                       q["size"], q["spp"], q["seed"], cfg_g).mean().backward()
    g = rad.grad.reshape(-1).cpu().numpy()
    err_rad = float(np.abs(g - np.asarray(REF_SPECTRAL_GRAD_RADIANCE)).max()
                    / np.abs(REF_SPECTRAL_GRAD_RADIANCE).max())
    _require(err_rad <= SPECTRAL_GRAD_TOL,
             f"d mean / d radiance {g.tolist()} is not within {SPECTRAL_GRAD_TOL} of JAX's "
             f"{REF_SPECTRAL_GRAD_RADIANCE} ({err_rad:.3g})")
    q = ec.PIN["grad_cauchy"]
    cfg_c = PTC(max_depth=q["max_depth"], rr_start=q["rr_start"])

    def cauchy_loss(c, size, spp, seed):
        return (sr.render_spectral(ec.with_cauchy(caustic, c), size, size, spp, seed, cfg_c)
                * torch.from_numpy(ec.weight_ramp(size)).cuda()).mean()

    c = torch.tensor(q["c"], device="cuda", requires_grad=True)
    loss_c = cauchy_loss(c, q["size"], q["spp"], q["seed"])
    loss_c.backward()
    err_c = abs(float(c.grad) - REF_SPECTRAL_GRAD_CAUCHY) / abs(REF_SPECTRAL_GRAD_CAUCHY)
    _require(err_c <= SPECTRAL_GRAD_TOL,
             f"d loss / d cauchy_c {float(c.grad)} is not within {SPECTRAL_GRAD_TOL} of JAX's "
             f"{REF_SPECTRAL_GRAD_CAUCHY} ({err_c:.3g})")
    print(f"[grad] spectral pins: d mean / d radiance {g.tolist()} (JAX "
          f"{REF_SPECTRAL_GRAD_RADIANCE}, max error {err_rad:.3g} of the largest), cauchy loss "
          f"{float(loss_c.detach()):.9f} (JAX {REF_SPECTRAL_CAUCHY_LOSS}), d/dc {float(c.grad):.9g} (JAX "
          f"{REF_SPECTRAL_GRAD_CAUCHY}, {err_c:.3g} relative)")
    furnace = shapes.furnace_scene(albedo=0.5, env_radiance=1.0)
    fmed = media_mod.Media.build(ec.furnace_medium(furnace))
    cfg_v = PTC(max_depth=3, rr_start=99)

    def vol_loss(s):
        return sr.render_spectral_vol(furnace, fmed._replace(sigma_s=fmed.sigma_s * s), 16, 16, 12,
                                      2, cfg_v).mean()

    s = torch.tensor(1.0, device="cuda", requires_grad=True)
    vol_loss(s).backward()
    with torch.no_grad():
        fd = (float(vol_loss(1.05)) - float(vol_loss(0.95))) / 0.1
    g_s = float(s.grad)
    _require(np.isfinite(g_s) and abs(fd) > 1e-5 and abs(g_s - fd) <= 0.35 * abs(fd),
             f"d / d sigma_s scale {g_s} against its central difference {fd} (rtol 0.35)")
    print(f"[grad] spectral volume d mean / d sigma_s scale {g_s:.6g}, central difference "
          f"{fd:.6g} ({abs(g_s / fd - 1):.3f} apart, JAX's gate 0.35)")
    gsize, gspp = W, 4
    reset_counts()
    cg = torch.tensor(q["c"], device="cuda", requires_grad=True)
    torch.cuda.reset_peak_memory_stats()
    cauchy_loss(cg, gsize, gspp, 7).backward()
    torch.cuda.synchronize()
    glaunch = counts()
    peak = torch.cuda.max_memory_allocated()
    _require(glaunch["shade_gather"]["gather_bwd_tile"] > 0 and bool(torch.isfinite(cg.grad)),
             f"the spectral gradient pass launched no gather backward: {glaunch}")
    fwd, fb = _paired_walls_ms(
        lambda: cauchy_loss(torch.tensor(q["c"], device="cuda"), gsize, gspp, 7),
        lambda: cauchy_loss(torch.tensor(q["c"], device="cuda", requires_grad=True), gsize, gspp,
                            7).backward(), 3)
    runs["spectral grad"] = dict(fwd_ms=_median(fwd), fb_ms=_median(fb), peak=peak,
                                 launches=glaunch, grad=float(cg.grad))
    add(launch_all, glaunch)
    print(f"[grad pass] spectral dispersive d (ramp-weighted mean) / d cauchy_c at {gsize}x{gsize}, "
          f"{gspp} spp, depth {q['max_depth']}: forward {_median(fwd):.1f} ms, forward+backward "
          f"{_median(fb):.1f} ms (medians of 3 pairs, ratio {_median(fb) / _median(fwd):.2f}), "
          f"peak {peak / 1e9:.2f} GB, d/dc {float(cg.grad):.6g}; launches over one "
          f"forward+backward {json.dumps(glaunch)}; {smi}")
    part("b")

    # (c) the spectral volume: pin within three seed spreads, then bench config 4's size
    v = ec.PIN["spectral_vol"]
    med = media_mod.Media.build(ec.cornell_medium(cornell))
    cfg_vol = PTC(max_depth=v["max_depth"])
    img = sr.render_spectral_vol(cornell, med, v["size"], v["size"], v["spp"], v["seeds"][0],
                                 cfg_vol)
    pins["spectral_vol"] = pin(f"spectral_vol ({v['size']}^2, {v['spp']} spp, seed "
                               f"{v['seeds'][0]}, three seed spreads)", float(img.mean()),
                               ENGINE_PINS["spectral_vol"], 3 * REF_SPECTRAL_VOL_SPREAD)
    sr.render_spectral_vol(cornell, med, VOL_W, VOL_H, VOL_SPP, 0, cfg_vol)
    (dt, img, launch), lanes = _count_lanes(lambda: timed_counted(
        lambda: sr.render_spectral_vol(cornell, med, VOL_W, VOL_H, VOL_SPP, 7, cfg_vol)))
    _require(bool(torch.isfinite(img).all()) and launch["intersect_dense"]["any_hit"] > 0,
             f"the spectral volume pass failed: {launch}")
    rays = lanes["closest"] + lanes["any_hit"]
    runs["spectral volume"] = dict(dt=dt, rays=rays, mrays=rays / dt / 1e6,
                                   mean=float(img.mean()), launches=launch,
                                   idle=_profile("spectral volume pass", lambda: sr.render_spectral_vol(
                                       cornell, med, VOL_W, VOL_H, VOL_SPP, 7, cfg_vol),
                                       top_n=4)["idle"])
    add(launch_all, launch)
    print(f"[main path] spectral volume {VOL_W}x{VOL_H} spp {VOL_SPP} depth {v['max_depth']}, "
          f"seed 7: {dt:.4f} s, {rays} ray lanes, {rays / dt / 1e6:.3f} Mrays/s, mean "
          f"{float(img.mean()):.6f}; launches {json.dumps(launch)}; {smi}")
    part("c")

    # (d) guiding: pins, then 4 batches of 2^17 photons and a 256^2, 16-spp guided pass
    gp = ec.PIN["guided"]
    gd = guided.make_guiding(caustic, res=gp["res"])
    for i in range(gp["batches"]):
        gd = guided.train_guiding(caustic, gd, gp["n_photons"], i, PTC(**ec.TRAIN_CFG))
    hsum = float(gd.hist.double().sum())
    _require(abs(hsum - REF_GUIDED_HIST_SUM) <= 1e-5 * REF_GUIDED_HIST_SUM,
             f"the pinned histogram's sum {hsum} is not within 1e-5 of JAX's "
             f"{REF_GUIDED_HIST_SUM}")
    img = guided.render_guided(caustic, gd, gp["size"], gp["size"], gp["spp"], gp["seed"],
                               PTC(**ec.GUIDED_CFG))
    pins["guided"] = pin(f"guided ({gp['size']}^2, {gp['spp']} spp, seed {gp['seed']}; "
                         f"histogram sum {hsum:.7f}, JAX {REF_GUIDED_HIST_SUM})",
                         float(img.mean()), ENGINE_PINS["guided"], ENGINE_TOL)
    gd = guided.make_guiding(caustic, res=GUIDE_RES)
    n_rows = GUIDE_RES ** 3 * guided.N_DIR_BINS ** 2
    train_s, deposit = [], None
    for i in range(GUIDE_BATCHES):
        if deposit is None:
            (deposit, (dt, gd, launch)) = _capture_bwd(
                lambda: timed_counted(lambda: guided.train_guiding(
                    caustic, gd, GUIDE_PHOTONS, i, PTC(**ec.TRAIN_CFG))),
                lambda g_, idx_, n_: g_.shape[1] == 1 and n_ == n_rows)
            tlaunch = launch
        else:
            dt, gd = _timed(lambda: guided.train_guiding(caustic, gd, GUIDE_PHOTONS, i,
                                                         PTC(**ec.TRAIN_CFG)))
        train_s.append(dt)
    _require(tlaunch["shade_gather"]["gather_bwd_tile"] == 1
             and tlaunch["intersect_dense"]["closest"] > 0,
             f"a training batch did not launch its kernels: {tlaunch}")
    add(launch_all, tlaunch)
    print(f"[main path] guiding: {GUIDE_BATCHES} batches of {GUIDE_PHOTONS} photons (res "
          f"{GUIDE_RES}, {n_rows} histogram rows): {', '.join(f'{t:.4f}' for t in train_s)} s; "
          f"{int((gd.hist.sum(1) > 0).sum())} of {GUIDE_RES ** 3} cells hold data; the first "
          f"batch's launches {json.dumps(tlaunch)}")
    deposit_r = _check_bwd_captured("guided deposit", *deposit, caustic.bvh.woop.device)
    del deposit
    gcfg = PTC(**ec.GUIDED_CFG)
    guided.render_guided(caustic, gd, W, H, SPP, 0, gcfg)
    (dt, img_g, launch), lanes = _count_lanes(lambda: timed_counted(
        lambda: guided.render_guided(caustic, gd, W, H, SPP, 7, gcfg)))
    _require(bool(torch.isfinite(img_g).all()) and launch["shade_gather"]["gather"] > 0
             and launch["intersect_dense"]["any_hit"] > 0,
             f"the guided pass did not launch its kernels: {launch}")
    rays = lanes["closest"] + lanes["any_hit"]
    runs["guided"] = dict(dt=dt, rays=rays, mrays=rays / dt / 1e6, mean=float(img_g.mean()),
                          launches=launch, train_s=train_s, train_launches=tlaunch,
                          idle=_profile("guided caustic pass", lambda: guided.render_guided(
                              caustic, gd, W, H, SPP, 7, gcfg), top_n=4)["idle"])
    add(launch_all, launch)
    # tests/test_guided.py's protocol: 4 passes each, guided at seeds i, the path tracer at
    # i + 100; a second path-traced set (i + 200) gives the gap's noise floor
    with torch.no_grad():
        means = [sum(fn(i + k).cpu().numpy() for i in range(4)) / 4 for fn, k in (
            (lambda s: guided.render_guided(caustic, gd, W, H, SPP, s, gcfg), 0),
            (lambda s: pt.render(caustic, W, H, SPP, s, gcfg), 100),
            (lambda s: pt.render(caustic, W, H, SPP, s, gcfg), 200))]
    gap, floor = _block_gap(means[0], means[1]), _block_gap(means[2], means[1])
    _require(gap < 0.1, f"guided vs path-traced block means {gap} apart (JAX's gate 0.1; two "
                        f"path-traced sets {floor} apart)")
    print(f"[main path] guided caustic {W}x{H} spp {SPP} depth {gcfg.max_depth}, seed 7: "
          f"{dt:.4f} s, {rays} ray lanes, {rays / dt / 1e6:.3f} Mrays/s, mean "
          f"{float(img_g.mean()):.6f}; over 4 passes each, the path tracer's 4x4 block means "
          f"{gap:.4f} apart (gate 0.1; two path-traced sets {floor:.4f} apart); launches "
          f"{json.dumps(launch)}; {smi}")
    _require(shade_pack.pack_enabled(caustic), "the caustic scene is outside the pack's band")
    _, gath = _capture_gathers(lambda: guided.render_guided(caustic, gd, W, H, SPP, 0, gcfg))
    gather_r = _check_gather_at("guided caustic pack", *gath[0])
    del gath
    part("d")

    # (e) render_fast on the bigscene at 1024^2: one BVH launch of 2^20 rays
    fw = FAST_SIZE
    realtime.render_fast(big, fw, fw)
    reps = []
    for _ in range(5):
        dt, (img_k, depth_k), launch = timed_counted(lambda: realtime.render_fast(big, fw, fw))
        reps.append(dt)
    _require(launch["intersect_bvh"]["closest"] == 1 and sum(launch["intersect_dense"].values())
             == 0, f"render_fast did not make one BVH launch: {launch}")
    add(launch_all, launch)
    _, cap = _capture_intersects(lambda: realtime.render_fast(big, fw, fw), limit=1)
    _, (bb, bo, bd, btmin, btmax, _) = cap[0]
    del cap
    ms_fast = _bvh_kernel_ms(bb, bo, bd, btmin, btmax, 20)
    plain_out, real_bvh = {}, bvh_ops.intersect_bvh

    def plain_route(b, o, d, t_min=1e-4, t_max=torch.inf, any_hit=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hit, n_inner, n_leaf, n_tpass = bvh_ops.intersect_bvh_plain(b, o, d, t_min, t_max,
                                                                    any_hit=any_hit,
                                                                    with_counts=True)
        torch.cuda.synchronize()
        plain_out.update(ms=(time.perf_counter() - t0) * 1e3, inner=int(n_inner.sum()),
                         leaf=int(n_leaf.sum()), tpass=int(n_tpass.sum()),
                         hits=int(hit.valid.sum()))
        return hit

    bvh_ops.intersect_bvh = plain_route
    try:
        img_p, depth_p = realtime.render_fast(big, fw, fw)
    finally:
        bvh_ops.intersect_bvh = real_bvh
    dimg = (img_k - img_p).abs().amax(-1)
    ddep = (depth_k - depth_p).abs()
    off = (dimg > 1e-5) | (ddep > 1e-4 * torch.clamp(depth_p, min=1.0))
    n_off = int(off.sum())
    _require(n_off <= FAST_OFF_MAX, f"render_fast: {n_off} pixels differ from the plain route "
                                    f"(at most {FAST_OFF_MAX}, coincident ties)")
    err_fast = float(torch.where(off, 0.0, ddep).max())
    flops = _bvh_flops(plain_out["inner"], plain_out["leaf"], plain_out["tpass"],
                       plain_out["hits"])
    nbytes = fw * fw * (24 + 8 + 16) + 4 * bb.nodes.numel() + ROW_BYTES * bb.woop.shape[0]
    bound_fast = _bound(flops, nbytes)
    best = min(reps)
    prof_fast = _profile("render_fast bigscene 1024^2", lambda: realtime.render_fast(big, fw, fw),
                         top_n=6)
    runs["fast"] = dict(idle=prof_fast["idle"], dt=best, mrays=fw * fw / best / 1e6, ms=ms_fast, plain_ms=plain_out["ms"],
                        bound=bound_fast, off=n_off, err=err_fast, launches=launch)
    print(f"[main path] render_fast bigscene {fw}x{fw} ({fw * fw} rays, {int(bb.woop.shape[0])} "
          f"Woop rows): pass {best * 1e3:.3f} ms (best of 5; {', '.join(f'{r * 1e3:.2f}' for r in reps)}), "
          f"{fw * fw / best / 1e6:.2f} Mrays/s; kernel alone {ms_fast:.4f} ms "
          f"({fw * fw / ms_fast / 1e3:.1f} Mrays/s), plain route {plain_out['ms']:.1f} ms, bound "
          f"{bound_fast[0]:.5f} ms ({bound_fast[1]}); image and depth vs the plain route: "
          f"{n_off} pixels differ, max depth error elsewhere {err_fast:.3g}; launches "
          f"{json.dumps(launch)}; {smi}")
    del img_k, depth_k, img_p, depth_p, bo, bd
    part("e")

    # (f) render_game: the pin (64^2, 8 frames), then 8 frames at 256^2
    gm = ec.PIN["game"]
    psf = None
    for f in range(gm["frames"]):
        frame, psf = realtime.render_game(cornell, psf, gm["size"], gm["size"], f)
    pins["game"] = pin(f"game (Cornell {gm['size']}^2, frame {gm['frames'] - 1})",
                       float(frame.mean()), ENGINE_PINS["game"], ENGINE_TOL)
    psf, frame_s = None, []
    reset_counts()
    for f in range(gm["frames"]):
        dt, (frame, psf) = _timed(lambda f=f, psf=psf: realtime.render_game(cornell, psf, W, H, f))
        frame_s.append(dt)
    launch = counts()
    _require(bool(torch.isfinite(frame).all()) and float(frame.mean()) > 0.01
             and launch["intersect_dense"]["closest"] > 0, f"render_game failed: {launch}")
    add(launch_all, launch)
    gcfg_t = realtime.GTConfig()
    it_p = psf.p
    lo, hi = cornell.bvh.world_min - 1e-3, cornell.bvh.world_max + 1e-3
    build_ms = _time_ms(lambda: hashgrid.build_grid(psf.p, lo, hi, gcfg_t.grid_res,
                                                    valid=psf.valid), 20)
    grid = hashgrid.build_grid(psf.p, lo, hi, gcfg_t.grid_res, valid=psf.valid)
    query_ms = _time_ms(lambda: hashgrid.query_sphere(grid, it_p, gcfg_t.radius,
                                                      gcfg_t.max_gather), 20)
    runs["game"] = dict(frame_s=frame_s, build_ms=build_ms, query_ms=query_ms, launches=launch,
                        mean=float(frame.mean()),
                        idle=_profile("render_game frame", lambda: realtime.render_game(
                            cornell, psf, W, H, 8), top_n=4)["idle"])
    print(f"[main path] render_game Cornell {W}x{H}, {gm['frames']} frames: "
          f"{', '.join(f'{t * 1e3:.1f}' for t in frame_s)} ms a frame, the last's mean "
          f"{float(frame.mean()):.6f}; hash grid build {build_ms:.3f} ms and query "
          f"{query_ms:.3f} ms ({W * H} points, res {gcfg_t.grid_res}, max_gather "
          f"{gcfg_t.max_gather}); launches over the frames {json.dumps(launch)}; {smi}")
    part("f")

    # (g) render_aovs: every channel's mean against JAX's
    a = ec.PIN["aovs"]
    dt, aovs, launch = timed_counted(lambda: prim_tracer.render_aovs(cornell, a["size"],
                                                                     a["size"], a["seed"]))
    add(launch_all, launch)
    _require(set(aovs) == set(REF_AOV_MEANS), f"AOV channels {sorted(aovs)}")
    errs = {}
    for k, ref in REF_AOV_MEANS.items():
        m = float(aovs[k].double().mean())
        errs[k] = abs(m - ref) / max(abs(ref), 1e-6)
        _require(errs[k] <= AOV_TOL, f"AOV {k} mean {m} is not within {AOV_TOL} of JAX's {ref}")
    worst = max(errs.values())
    print("[check] render_aovs channel means, relative from JAX's: "
          + ", ".join(f"{k} {e:.3g}" for k, e in sorted(errs.items(), key=lambda x: -x[1])))
    runs["aovs"] = dict(dt=dt, worst=worst, launches=launch,
                        idle=_profile("render_aovs 256^2", lambda: prim_tracer.render_aovs(
                            cornell, a["size"], a["size"], a["seed"]), top_n=4)["idle"])
    print(f"[main path] render_aovs Cornell {a['size']}^2: {dt * 1e3:.1f} ms, 17 channels, the "
          f"worst mean {worst:.3g} relative from JAX's (gate {AOV_TOL}); launches "
          f"{json.dumps(launch)}")
    part("g")

    # (h) generate_fits over the full grid on the card
    dt, (ct, cf, (r1, r2)) = _timed(lambda: rt.generate_fits(device="cuda"))
    E, A, C = np.meshgrid(rt._ETAS, rt._ALPHAS, rt._COSINES, indexing="ij")
    X = rt._basis(E.reshape(-1), A.reshape(-1), C.reshape(-1))
    fit_t = float(np.abs(X @ rt.COEFS_T.astype(np.float64) - X @ ct).max())
    e, al = E[:, :, 0].reshape(-1) - 1.5, A[:, :, 0].reshape(-1)
    Xf = np.stack([al, al * e, al * e * e, al * al, al * al * e, al * al * e * e], -1)
    fit_f = float(np.abs(Xf @ rt.COEFS_FDR.astype(np.float64) - Xf @ cf).max())
    _require(fit_t <= 2e-3 and fit_f <= 2e-3 and max(r1, r2) <= rt.FIT_RESIDUAL + 2e-3,
             f"generate_fits: surfaces {fit_t:.3g} / {fit_f:.3g} from the baked ones (2e-3), "
             f"residuals {r1:.5f} / {r2:.5f} (baked {rt.FIT_RESIDUAL} + 2e-3)")
    runs["fits"] = dict(dt=dt, fit_t=fit_t, fit_f=fit_f, resid=(r1, r2))
    print(f"[main path] generate_fits on the card (7 x 9 x 18 grid at 72^2 strata, "
          f"{7 * 9 * 18 * 72 * 72} lanes at eta and at 1/eta): {dt:.2f} s; fitted surfaces "
          f"within {fit_t:.3g} (T) and {fit_f:.3g} (fdr) of the baked coefficients' (gate 2e-3); "
          f"residuals {r1:.6f} / {r2:.6f} against FIT_RESIDUAL {rt.FIT_RESIDUAL}")
    part("h")
    print(f"[main path] phase 25 launches over its runs {json.dumps(launch_all)}")
    return dict(pins=pins, runs=runs, dense=dense_r, gather=gather_r, deposit=deposit_r,
                launches=launch_all, grad_launches=glaunch)


def _capture_gathers(fn):
    """(fn's result, [(table, idx)]) of the first packed_gather in one call of `fn`."""
    from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops

    seen, real = [], sg_ops._gather

    def record(table, idx):
        if not seen:
            seen.append((table, idx.clone()))
        return real(table, idx)

    sg_ops._gather = record
    try:
        out = fn()
    finally:
        sg_ops._gather = real
    _require(bool(seen), "no packed_gather call was made")
    return out, seen


def _port_counters():
    """The port's launch counters by wrapper module (each kernel wrapper adds
    one where it launches its kernel)."""
    from cudatracerlib_tpu_torch.ops import intersect_bvh as bvh_ops
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops
    from cudatracerlib_tpu_torch.ops import photon_gather as pg_ops
    from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops
    from cudatracerlib_tpu_torch.ops import transmittance as tr_op

    return {"intersect_dense": ops.launches, "intersect_bvh": bvh_ops.launches,
            "shade_gather": sg_ops.launches, "photon_gather": pg_ops.launches,
            "transmittance": tr_op.launches}


def _counted(fn):
    """(wall s, result, launches) of one synchronised call of `fn`, the
    launch counts set to 0 just before and read just after."""
    counters = _port_counters()
    for c in counters.values():
        for k in c:
            c[k] = 0
    dt, out = _timed(fn)
    return dt, out, {name: dict(c) for name, c in counters.items()}


def _collective_ms(fn, reps=11):
    """Median host wall in ms of a synchronised collective call, after a
    warm call (a gloo collective on CUDA tensors goes through the host)."""
    import torch

    walls = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return _median(walls[1:])


def _film_buffer_ms(width, height, device):
    """The film all-reduce's own time: one float64 buffer of (rgb, weight,
    rays), as parallel/shard.py sums it."""
    import torch
    import torch.distributed as dist

    buf = torch.zeros(width * height * 4 + 1, dtype=torch.float64, device=device)
    return _collective_ms(lambda: dist.all_reduce(buf))


def _photon_gather_ms(n_slots, device):
    """The photon map all-gather's own time: each rank's (n_slots, 14)
    float32 slots, as parallel/shard.py gathers them."""
    import torch
    import torch.distributed as dist

    local = torch.zeros(n_slots, 14, device=device)
    slots = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    return _collective_ms(lambda: dist.all_gather(slots, local))


def _train_case(mesh, device):
    """Phase 22 (c)'s step: the Cornell target, the grey start and a
    sharded train step at SHARD_TRAIN's size."""
    import torch
    from cudatracerlib_tpu_torch import entry as entry_mod
    from cudatracerlib_tpu_torch.parallel import shard
    from cudatracerlib_tpu_torch.render import path_tracer as pt
    from cudatracerlib_tpu_torch.scene.shapes import cornell_box

    t = SHARD_TRAIN
    cfg = pt.PTConfig(max_depth=t["max_depth"], rr_start=t["rr_start"])
    with torch.no_grad():
        target = pt.render(cornell_box(device=device), t["width"], t["height"], t["spp"],
                           t["target_seed"], cfg)
    start = entry_mod.grey_start(device=device)
    step = shard.make_train_step(mesh, t["width"], t["height"], t["spp"], target, lr=t["lr"],
                                 config=cfg)
    return start, step


def _updates(start, new):
    """Each parameter's update (after - before), numpy."""
    return (new.textures.color_a.cpu().numpy() - start.textures.color_a.cpu().numpy(),
            new.lights.radiance.cpu().numpy() - start.lights.radiance.cpu().numpy())


def _shard_rank_program(rank, device):
    """Phase 22 (b)-(d) on one of SHARD_RANKS gloo ranks sharing the card:
    the sharded render at bench config 1's size, the train step and the
    sharded PPM pass at bench config 5's size, each on a (ranks, 1) mesh,
    warm first, then one call with its launches counted; and the
    collectives' own times."""
    import torch
    from cudatracerlib_tpu_torch.parallel import shard
    from cudatracerlib_tpu_torch.render import path_tracer as pt
    from cudatracerlib_tpu_torch.render import ppm
    from cudatracerlib_tpu_torch.scene.shapes import caustic_scene, cornell_box

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    mesh = shard.make_mesh(SHARD_RANKS, 1, device=device)
    cornell = shard.replicate_scene(cornell_box(device=device), mesh)
    fn = shard.make_sharded_render(mesh, W, H, SPP, pt.PTConfig(max_depth=DEPTH), with_stats=True)
    fn(cornell, 0)
    dt, (img, rays), launches = _counted(lambda: fn(cornell, SHARD_SEED))
    out["render"] = dict(dt=dt, img=img.cpu().numpy(), rays=int(rays), launches=launches,
                         film_ms=_film_buffer_ms(W, H, device))

    start, step = _train_case(mesh, device)
    step(start, 0)
    dt, (new, loss), launches = _counted(lambda: step(start, SHARD_TRAIN["seed"]))
    out["train"] = dict(dt=dt, loss=float(loss), updates=_updates(start, new), launches=launches)

    caustic = shard.replicate_scene(caustic_scene(device=device), mesh)
    pcfg = ppm.PPMConfig()
    pfn = shard.make_sharded_ppm(mesh, PPM_W, PPM_H, PPM_SPP, pcfg)
    radius = ppm.progressive_radius(pcfg.radius0, PPM_PASS)
    pfn(caustic, 0, radius)
    dt, img, launches = _counted(lambda: pfn(caustic, SHARD_PPM_SEEDS[0], radius))
    n_slots = pcfg.base.max_depth * pcfg.n_photons // SHARD_RANKS
    out["ppm"] = dict(dt=dt, mean=float(img.mean()), finite=bool(torch.isfinite(img).all()),
                      shape=tuple(img.shape), launches=launches,
                      gather_ms=_photon_gather_ms(n_slots, device))
    return out


def _multidevice_phase(cornell, caustic, smi):
    """Phase 22 (module docstring): the sharded render, train step and PPM
    pass on a one-rank NCCL group in this process, their kernels held to
    their plain versions, the pins; then the same on SHARD_RANKS spawned
    gloo ranks sharing the card."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from cudatracerlib_tpu_torch.parallel import distributed as pdist
    from cudatracerlib_tpu_torch.parallel import shard
    from cudatracerlib_tpu_torch.ops import photon_gather as pg_ops
    from cudatracerlib_tpu_torch.render import path_tracer as pt
    from cudatracerlib_tpu_torch.render import ppm

    dev = torch.device("cuda", torch.cuda.current_device())
    _require(pdist.init_distributed(0, 1, "127.0.0.1", pdist.free_port(), 0, device="cuda",
                                    backend="nccl", timeout=SHARD_RANK_TIMEOUT_S),
             "the one-rank NCCL group did not start")
    try:
        mesh = shard.make_mesh(1, 1)
        print(f"[shard] one rank: {json.dumps(pdist.process_topology())}, mesh {mesh}")
        # (a) the sharded render at bench config 1's size
        cfg = pt.specialize_config(cornell, pt.PTConfig(max_depth=DEPTH))
        fn = shard.make_sharded_render(mesh, W, H, SPP, pt.PTConfig(max_depth=DEPTH),
                                       with_stats=True)
        dense_args, _, _ = _capture_render(lambda: fn(cornell, 0))
        dense = {f"sharded {k}": _compare(f"sharded cornell {k}", c[0], c[1], c[2], c[3], c[4],
                                          20, c[6], c[7])
                 for k, c in dense_args.items() if k != "first-bounce rays"}
        dt_a, (img_a, rays_a), launch_a = _counted(lambda: fn(cornell, SHARD_SEED))
        mean_a, rays_a = float(img_a.mean()), int(rays_a)
        _require(bool(torch.isfinite(img_a).all()) and tuple(img_a.shape) == (H, W, 3),
                 "the sharded render is not finite or has the wrong shape")
        _require(launch_a["intersect_dense"]["closest"] > 0
                 and launch_a["intersect_dense"]["any_hit"] > 0,
                 f"the sharded render did not launch intersect_dense for both ray kinds: "
                 f"{launch_a}")
        _require(abs(mean_a - REF_SHARD_MEAN) <= SHARD_TOL * REF_SHARD_MEAN,
                 f"sharded render mean {mean_a} is not within {SHARD_TOL:.1%} of JAX's "
                 f"{REF_SHARD_MEAN}")
        _require(abs(rays_a - REF_SHARD_RAYS) <= SHARD_RAYS_TOL * REF_SHARD_RAYS,
                 f"sharded render rays {rays_a} are not within {SHARD_RAYS_TOL} of JAX's "
                 f"{REF_SHARD_RAYS}")
        print(f"[main path] sharded render, one NCCL rank, {W}x{H} spp {SPP} depth {DEPTH} seed "
              f"{SHARD_SEED}: mean {mean_a:.9f} (JAX {REF_SHARD_MEAN}, "
              f"{100 * (mean_a / REF_SHARD_MEAN - 1):+.5f}%), rays {rays_a} (JAX "
              f"{REF_SHARD_RAYS}), {dt_a:.4f} s; launches {json.dumps(launch_a)}")
        walls = _paired_walls_ms(lambda: fn(cornell, 7),
                                 lambda: pt.render_progressive(cornell, W, H, SPP, 1, 7, cfg),
                                 SHARD_PAIRS)
        film_ms = _film_buffer_ms(W, H, dev)
        print(f"[time] sharded render pass, one NCCL rank: median {_median(walls[0]):.3f} ms "
              f"against render_progressive's one pass {_median(walls[1]):.3f} ms ({SHARD_PAIRS} "
              f"alternating pairs: {[round(x, 3) for x in walls[0]]} / "
              f"{[round(x, 3) for x in walls[1]]}); the film all-reduce alone ({W * H * 4 + 1} "
              f"float64) {film_ms:.4f} ms; {smi}")

        # (c) the train step at the example's size
        t = SHARD_TRAIN
        start, step = _train_case(mesh, dev)
        step(start, 0)
        n_tex = start.textures.color_a.shape[0]
        (g, idx, n_rows), _ = _capture_bwd(lambda: step(start, t["seed"]),
                                           lambda g, idx, n: n == n_tex)
        bwd = _check_bwd_captured("sharded train texture", g, idx, n_rows, dev)
        dt_c, (new_c, loss_c), launch_c = _counted(lambda: step(start, t["seed"]))
        loss_c = float(loss_c)
        upd_c = _updates(start, new_c)
        _require(np.isfinite(loss_c) and abs(loss_c - REF_SHARD_LOSS) <= SHARD_LOSS_RTOL
                 * REF_SHARD_LOSS, f"train step loss {loss_c} against JAX's {REF_SHARD_LOSS}")
        for name, got, ref in (("color_a", upd_c[0], REF_SHARD_UPDATE_COLOR_A),
                               ("radiance", upd_c[1], REF_SHARD_UPDATE_RADIANCE)):
            ref = np.asarray(ref, np.float32)
            err = np.abs(got - ref)
            _require(bool((err <= SHARD_UPDATE_RTOL * (np.abs(ref) + np.abs(ref).max())).all()),
                     f"train step's {name} update {got.tolist()} against JAX's {ref.tolist()}")
            print(f"[grad] sharded train step, one rank: {name} update max abs err "
                  f"{float(err.max()):.3g} (largest {float(np.abs(ref).max()):.4g})")
        _require(launch_c["intersect_dense"]["closest"] > 0
                 and launch_c["shade_gather"]["gather_bwd_tile"] > 0,
                 f"the train step did not launch intersect_dense and the gather backward: "
                 f"{launch_c}")
        print(f"[main path] sharded train step, one NCCL rank, {t['width']}x{t['height']} spp "
              f"{t['spp']} depth {t['max_depth']}: loss {loss_c:.9f} (JAX {REF_SHARD_LOSS}), "
              f"{dt_c:.4f} s; launches {json.dumps(launch_c)}")

        # (d) the sharded PPM pass: pinned, then at bench config 5's size
        p = PPM_PIN
        pin_cfg = ppm.PPMConfig(n_photons=p["n_photons"])
        pin_fn = shard.make_sharded_ppm(mesh, p["width"], p["height"], p["spp"], pin_cfg)
        img_pin = pin_fn(caustic, p["seed"], ppm.progressive_radius(pin_cfg.radius0,
                                                                    p["pass_idx"]))
        mean_pin = float(img_pin.mean())
        _require(bool(torch.isfinite(img_pin).all()) and abs(mean_pin - REF_SHARD_PPM_MEAN)
                 <= PPM_TOL * REF_SHARD_PPM_MEAN,
                 f"pinned sharded PPM mean {mean_pin} is not within {PPM_TOL:.1%} of JAX's "
                 f"exhaustive {REF_SHARD_PPM_MEAN}")
        print(f"[main path] sharded ppm pinned ({p['width']}x{p['height']}, {p['spp']} spp, "
              f"{p['n_photons']} photons, seed {p['seed']}, pass {p['pass_idx']}, grid_res "
              f"{pin_cfg.grid_res}): mean {mean_pin:.9f} (JAX exhaustive {REF_SHARD_PPM_MEAN}, "
              f"{100 * (mean_pin / REF_SHARD_PPM_MEAN - 1):+.5f}%)")
        pcfg = ppm.PPMConfig()
        pfn = shard.make_sharded_ppm(mesh, PPM_W, PPM_H, PPM_SPP, pcfg)
        radius = ppm.progressive_radius(pcfg.radius0, PPM_PASS)
        density_calls, real_density = [], pg_ops.photon_density

        def capture_density(*args):
            density_calls.append(args)
            return real_density(*args)

        pg_ops.photon_density = capture_density
        try:
            ppm_dense, ppm_gathers = _capture_sppm(lambda: pfn(caustic, 0, radius))
        finally:
            pg_ops.photon_density = real_density
        _require(len(density_calls) == 2 and bool(ppm_gathers),
                 f"the sharded PPM pass called photon_density {len(density_calls)} times and "
                 f"packed_gather {len(ppm_gathers)} times")
        dense.update({f"sharded ppm {k}": _compare(f"sharded ppm {k}", c[0], c[1], c[2], c[3],
                                                   c[4], 10, c[6], c[7])
                      for k, c in ppm_dense.items()})
        dens_err = max(_check_density(f"sharded ppm {m}", a)
                       for m, a in zip(("global map", "caustic map"), density_calls))
        gather = _check_gather_at("sharded ppm", *ppm_gathers[0])
        dt_d, img_d, launch_d = _counted(lambda: pfn(caustic, SHARD_PPM_SEEDS[0], radius))
        _require(bool(torch.isfinite(img_d).all()) and tuple(img_d.shape) == (PPM_H, PPM_W, 3),
                 "the sharded PPM image is not finite or has the wrong shape")
        _require(launch_d["photon_gather"]["density"] > 0
                 and launch_d["shade_gather"]["gather"] > 0
                 and launch_d["intersect_dense"]["closest"] > 0
                 and launch_d["intersect_dense"]["any_hit"] > 0,
                 f"the sharded PPM pass did not launch photon_density, packed_gather and both "
                 f"kinds of intersect_dense: {launch_d}")
        seed_means = [float(img_d.mean())] + [float(pfn(caustic, s, radius).mean())
                                              for s in SHARD_PPM_SEEDS[1:]]
        spread = max(seed_means) - min(seed_means)
        walls_d = _paired_walls_ms(
            lambda: pfn(caustic, 7, radius),
            lambda: ppm.render_ppm_pass(caustic, PPM_W, PPM_H, PPM_SPP, 7, PPM_PASS, pcfg),
            SHARD_PAIRS)
        n_slots = pcfg.base.max_depth * pcfg.n_photons
        gather_ms = _photon_gather_ms(n_slots, dev)
        print(f"[main path] sharded ppm, one NCCL rank, {PPM_W}x{PPM_H} spp {PPM_SPP} pass "
              f"{PPM_PASS} (PPMConfig(), grid_res {pcfg.grid_res}): seed {SHARD_PPM_SEEDS[0]} "
              f"mean {seed_means[0]:.6f}, {dt_d:.4f} s; means over seeds {SHARD_PPM_SEEDS}: "
              f"{[round(m, 6) for m in seed_means]} (spread {spread:.6f}); launches "
              f"{json.dumps(launch_d)}")
        print(f"[time] sharded ppm pass, one NCCL rank: median {_median(walls_d[0]):.3f} ms "
              f"against render_ppm_pass's {_median(walls_d[1]):.3f} ms ({SHARD_PAIRS} "
              f"alternating pairs: {[round(x, 3) for x in walls_d[0]]} / "
              f"{[round(x, 3) for x in walls_d[1]]}); the photon all-gather alone ({n_slots} x "
              f"14 float32) {gather_ms:.4f} ms; {smi}")
    finally:
        dist.destroy_process_group()

    # (b)-(d) on ranks sharing the card over gloo
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = pdist.run_ranks(_shard_rank_program, SHARD_RANKS, device="cuda", backend="gloo",
                            timeout=SHARD_RANK_TIMEOUT_S)
    job_s = time.perf_counter() - t0
    r0 = ranks[0]
    total = lambda part, name, kind: sum(r[part]["launches"][name][kind]  # noqa: E731
                                         for r in ranks)
    rays_b = ranks[0]["render"]["rays"]
    _require(all(r["render"]["rays"] == rays_b for r in ranks) and rays_b == rays_a,
             f"{SHARD_RANKS} ranks traced {[r['render']['rays'] for r in ranks]} rays, one rank "
             f"{rays_a}")
    img_b = r0["render"]["img"]
    img_a = img_a.cpu().numpy()
    diff = np.abs(img_b - img_a)
    _require(all(np.array_equal(r["render"]["img"], img_b) for r in ranks)
             and bool((diff <= SHARD_IMG_RTOL * np.abs(img_a) + SHARD_IMG_ATOL).all()),
             f"the {SHARD_RANKS}-rank image is not within {SHARD_IMG_RTOL} relative + "
             f"{SHARD_IMG_ATOL} of the one-rank image (max abs diff {float(diff.max())})")
    _require(total("render", "intersect_dense", "closest") > 0
             and total("render", "intersect_dense", "any_hit") > 0,
             f"the {SHARD_RANKS}-rank render did not launch intersect_dense for both ray kinds")
    loss_b = r0["train"]["loss"]
    _require(all(r["train"]["loss"] == loss_b for r in ranks)
             and abs(loss_b - loss_c) <= SHARD_CROSS_LOSS_RTOL * loss_c,
             f"train step losses {[r['train']['loss'] for r in ranks]} on {SHARD_RANKS} ranks, "
             f"{loss_c} on one")
    upd_err = 0.0
    for got, one in zip(r0["train"]["updates"], upd_c):
        err = np.abs(got - one)
        upd_err = max(upd_err, float(err.max()))
        _require(bool((err <= SHARD_CROSS_UPDATE_RTOL * (np.abs(one) + np.abs(one).max())).all()),
                 f"the {SHARD_RANKS}-rank update {got.tolist()} against one rank's {one.tolist()}")
    _require(total("train", "intersect_dense", "closest") > 0
             and total("train", "shade_gather", "gather_bwd_tile") > 0,
             f"the {SHARD_RANKS}-rank train step did not launch intersect_dense and the gather "
             f"backward")
    ppm_b = r0["ppm"]
    _require(all(r["ppm"]["finite"] and r["ppm"]["shape"] == (PPM_H, PPM_W, 3)
                 and r["ppm"]["mean"] == ppm_b["mean"] for r in ranks),
             f"the {SHARD_RANKS}-rank PPM images are not finite, equal and of shape "
             f"({PPM_H}, {PPM_W}, 3)")
    _require(abs(ppm_b["mean"] - seed_means[0]) <= 3 * spread,
             f"the {SHARD_RANKS}-rank PPM mean {ppm_b['mean']} is not within three times the "
             f"seed spread {spread} of the one-rank mean {seed_means[0]}")
    _require(all(total("ppm", n, k) > 0 for n, k in (
        ("photon_gather", "density"), ("shade_gather", "gather"),
        ("intersect_dense", "closest"), ("intersect_dense", "any_hit"))),
        f"the {SHARD_RANKS}-rank PPM pass did not launch every kernel of its path")
    rl = {part: {name: {k: total(part, name, k) for k in r0[part]["launches"][name]}
                 for name in r0[part]["launches"]} for part in ("render", "train", "ppm")}
    print(f"[main path] {SHARD_RANKS} gloo ranks on one card (job {job_s:.1f} s): render rays "
          f"{rays_b} (one rank {rays_a}, equal), image max abs diff {float(diff.max()):.3g}; "
          f"train loss {loss_b:.9f} (one rank {loss_c:.9f}), update max abs diff {upd_err:.3g}; "
          f"ppm mean {ppm_b['mean']:.6f} (one rank {seed_means[0]:.6f}, 3x seed spread "
          f"{3 * spread:.6f}); launches summed over the ranks {json.dumps(rl)}")
    print(f"[time] {SHARD_RANKS} gloo ranks on one card, rank 0: sharded render pass "
          f"{1e3 * r0['render']['dt']:.3f} ms (film all-reduce alone "
          f"{r0['render']['film_ms']:.4f} ms), train step {1e3 * r0['train']['dt']:.3f} ms (one "
          f"rank {1e3 * dt_c:.3f} ms), sharded ppm pass {1e3 * ppm_b['dt']:.3f} ms (photon "
          f"all-gather alone {ppm_b['gather_ms']:.4f} ms); {smi}")
    return dict(dense=dense, bwd=bwd, gather=gather, dens_err=dens_err,
                launches={"render": launch_a, "train": launch_c, "ppm": launch_d},
                rank_launches=rl)


def _util_slice_err(label, card, cpu, atol, rtol=0.0):
    """The largest |card - cpu| over the CPU port's UTIL_SLICE lanes, gated
    at atol + rtol |cpu|."""
    c, p = card[:UTIL_SLICE].detach().cpu().double(), cpu.detach().double()
    diff = (c - p).abs()
    bad = diff > atol + rtol * p.abs()
    _require(not bool(bad.any()), f"phase 27 {label}: {int(bad.sum())} of {c.numel()} values off "
                                  f"the CPU port's beyond {atol:g}, worst {float(diff.max())}")
    return float(diff.max())


def _spline_part(dev, lanes):
    """Phase 27 (a): the splines at `lanes` lanes on `dev` against the CPU
    port's first UTIL_SLICE lanes, and sample_1d's histogram."""
    import numpy as np
    import torch
    from cudatracerlib_tpu_torch.math import spline

    rng = np.random.default_rng(27)
    g = np.linspace(0.0, 1.0, 64)
    vals1 = (1.2 + 0.8 * np.sin(2 * np.pi * g) + 0.3 * np.cos(6 * np.pi * g)).astype(np.float32)
    gy, gx = np.meshgrid(np.linspace(0, 1, 16), np.linspace(0, 1, 16), indexing="ij")
    vals2 = (np.sin(3 * gx) * np.cos(2 * gy)).astype(np.float32)
    gz3, gy3, gx3 = np.meshgrid(*(np.linspace(0, 1, 8),) * 3, indexing="ij")
    vals3 = (np.sin(2 * gx3 + gy3) * np.cos(gz3)).astype(np.float32)
    x = rng.uniform(-0.05, 1.05, lanes).astype(np.float32)
    p2 = rng.uniform(-0.05, 1.05, (lanes, 2)).astype(np.float32)
    p3 = rng.uniform(0.0, 1.0, (lanes, 3)).astype(np.float32)
    u = rng.random(lanes, dtype=np.float32)

    def run(device, n):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a[:n] if a.ndim and a.shape[0] == lanes  # noqa: E731
                                                           else a)).to(device)
        v1 = t(vals1)
        xs, pdf = spline.sample_1d(t(u), v1)
        return {"eval_1d": spline.eval_1d(t(x), v1),
                "eval_1d extrapolated": spline.eval_1d(t(x), v1, extrapolate=True),
                "eval_2d": spline.eval_2d(t(p2), t(vals2)),
                "eval_3d": spline.eval_3d(t(p3), t(vals3)),
                "integrate_1d": spline.integrate_1d(v1), "sample_1d x": xs, "sample_1d pdf": pdf}

    wall, card = _timed(lambda: run(dev, lanes))
    cpu = run("cpu", UTIL_SLICE)
    errs = {k: _util_slice_err(f"spline {k}", card[k], cpu[k], 1e-5) for k in card}
    # the samples follow eval_1d / total: 128 bins, each expected count from
    # eval_1d at 32 midpoints of the bin
    total = float(card["integrate_1d"][-1])
    bins = 128
    counts = torch.histc(card["sample_1d x"], bins, 0.0, 1.0).double()
    mid = (torch.arange(bins * 32, device=dev, dtype=torch.float32) + 0.5) / (bins * 32)
    f = spline.eval_1d(mid, torch.from_numpy(vals1).to(dev)).double().reshape(bins, 32)
    expected = f.mean(1) / bins / total * lanes
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    pdf_ref = spline.eval_1d(card["sample_1d x"], torch.from_numpy(vals1).to(dev)) / total
    pdf_err = float(((card["sample_1d pdf"] - pdf_ref).abs() / pdf_ref).max())
    _require(chi2 < 2 * bins, f"phase 27 spline: sample_1d's histogram chi^2 {chi2:.1f} over "
                              f"{bins} bins")
    _require(pdf_err < 1e-4, f"phase 27 spline: sample_1d's pdf {pdf_err:.3g} from eval_1d / total")
    _require(all(bool(torch.isfinite(v).all()) for v in card.values()),
             "phase 27 spline: a non-finite value")
    print(f"[phase 27 (a)] PASS spline: {lanes} lanes (eval_1d on 64 nodes, eval_2d 16x16, "
          f"eval_3d 8x8x8, sample_1d) in {1e3 * wall:.3f} ms; CPU port on {UTIL_SLICE} lanes, "
          f"max abs err {', '.join(f'{k} {v:.3g}' for k, v in errs.items())}; sample_1d "
          f"histogram chi^2 {chi2:.1f} over {bins} bins, pdf within {pdf_err:.3g} of "
          f"eval_1d / total")
    return dict(wall=wall, err=max(errs.values()), chi2=chi2)


def _quadrature_part(dev, lanes):
    """Phase 27 (a): the composite Lobatto integral of exp(-a x) sin(b x)
    over [0, L] per lane against its closed form and the CPU port."""
    import numpy as np
    import torch
    from cudatracerlib_tpu_torch.math import quadrature

    rng = np.random.default_rng(28)
    abl = np.stack([rng.uniform(0.1, 3.0, lanes), rng.uniform(0.5, 8.0, lanes),
                    rng.uniform(0.5, 3.0, lanes)]).astype(np.float32)

    def run(device, n):
        a, b, length = torch.from_numpy(abl[:, :n]).to(device)
        return quadrature.integrate(lambda x: torch.exp(-a[:, None, None] * x)
                                    * torch.sin(b[:, None, None] * x),
                                    torch.zeros_like(length), length, 8)

    wall, card = _timed(lambda: run(dev, lanes))
    a, b, length = torch.from_numpy(abl).to(dev).double()
    exact = (b - torch.exp(-a * length) * (a * torch.sin(b * length) + b * torch.cos(b * length))) \
        / (a * a + b * b)
    err = float((card.double() - exact).abs().max())
    _require(err <= 1e-5, f"phase 27 quadrature: {err:.3g} from the closed form")
    cpu_err = _util_slice_err("quadrature", card, run("cpu", UTIL_SLICE), 1e-5)
    print(f"[phase 27 (a)] PASS quadrature: {lanes} lanes x 8 panels x 7 Lobatto nodes in "
          f"{1e3 * wall:.3f} ms, max abs err {err:.3g} from the closed form, {cpu_err:.3g} from "
          f"the CPU port on {UTIL_SLICE} lanes")
    return dict(wall=wall, err=err, cpu_err=cpu_err)


def _code_steps(card, cpu, fields):
    """(lanes whose code differs, largest step in any field) of two int64
    code tensors."""
    differ = card != cpu
    step = max(int(((card >> s) & m).sub((cpu >> s) & m).abs().max()) for s, m in fields)
    return int(differ.sum()), step


def _compression_part(dev, lanes):
    """Phase 27 (a): the spherical, octahedral and uv round trips on `lanes`
    directions, and the codes against the CPU port's."""
    import numpy as np
    import torch
    from cudatracerlib_tpu_torch.math import compression as comp
    from cudatracerlib_tpu_torch.math.vecmath import dot, normalize

    rng = np.random.default_rng(29)
    d_np = rng.normal(size=(lanes, 3)).astype(np.float32)
    uv_np = rng.uniform(-1.0, 2.0, (lanes, 2)).astype(np.float32)

    def run(device, n):
        d = normalize(torch.from_numpy(d_np[:n]).to(device))
        uv = torch.from_numpy(uv_np[:n]).to(device)
        codes = {"spherical_u16": comp.encode_spherical_u16(d),
                 "octahedral_u32": comp.encode_octahedral_u32(d), "uv_u32": comp.encode_uv_u32(uv)}
        return d, uv, codes, {k: getattr(comp, f"decode_{k}")(c) for k, c in codes.items()}

    wall, (d, uv, codes, dec) = _timed(lambda: run(dev, lanes))
    sph_dot = float(dot(dec["spherical_u16"], d).min())
    oct_err = float((dec["octahedral_u32"] - d).abs().max())
    uv_err = float((dec["uv_u32"] - torch.remainder(uv, 1.0)).abs().max())
    _require(sph_dot > 0.999 and oct_err < 2e-4 and uv_err < 1e-4,
             f"phase 27 compression round trips: spherical dot {sph_dot}, octahedral {oct_err}, "
             f"uv {uv_err}")
    _, _, codes_cpu, _ = run("cpu", UTIL_SLICE)
    diffs = {}
    for k, c in codes_cpu.items():
        fields = [(0, 0xFF), (8, 0xFF)] if k == "spherical_u16" else [(0, 0xFFFF), (16, 0xFFFF)]
        n_diff, step = _code_steps(codes[k][:UTIL_SLICE].cpu(), c, fields)
        _require(step <= 1, f"phase 27 compression {k}: a code {step} steps from the CPU port's")
        diffs[k] = n_diff
        # decoding the same codes: card against the CPU port
        _util_slice_err(f"decode {k}", dec[k], getattr(comp, f"decode_{k}")(codes[k][:UTIL_SLICE]
                                                                               .cpu()), 1e-6)
    print(f"[phase 27 (a)] PASS compression: {lanes} directions and uv pairs encoded and decoded "
          f"in {1e3 * wall:.3f} ms; spherical min dot {sph_dot:.6f}, octahedral max abs err "
          f"{oct_err:.3g}, uv {uv_err:.3g}; codes one quantization step from the CPU port's on "
          f"{diffs} of {UTIL_SLICE} lanes, decodes of the same codes within 1e-6")
    return dict(wall=wall, oct_err=oct_err, sph_dot=sph_dot, uv_err=uv_err, code_diffs=diffs)


def _merging_part(dev, lanes):
    """Phase 27 (a): one merging model a pixel (capacity 16, 64 inserts of
    a noisy sine), evaluated at a point per lane, against the CPU port."""
    import numpy as np
    import torch
    from cudatracerlib_tpu_torch.math import function_model as fm

    rng = np.random.default_rng(30)
    xs_np = rng.random((64, lanes), dtype=np.float32)
    ph = rng.uniform(0.0, 6.0, lanes)
    ys_np = (np.sin(6.0 * xs_np + ph) + 0.05 * np.cos(40.0 * xs_np)).astype(np.float32)
    q_np = rng.random(lanes, dtype=np.float32)

    def run(device, n):
        xs, ys = (torch.from_numpy(np.ascontiguousarray(a[:, :n])).to(device) for a in (xs_np, ys_np))
        m = fm.merging_init(16, (n,), device=device)
        for k in range(64):
            m = fm.merging_insert(m, xs[k], ys[k])
        return m, fm.merging_eval(m, torch.from_numpy(q_np[:n]).to(device))

    wall, (m, val) = _timed(lambda: run(dev, lanes))
    m_cpu, val_cpu = run("cpu", UTIL_SLICE)
    _require(bool((m.n == 16).all()) and bool((m.xs[:, 1:16] >= m.xs[:, :15]).all()),
             "phase 27 merging: a model is not full or not sorted")
    for f in ("xs", "ys", "n"):
        _require(torch.equal(getattr(m, f)[:UTIL_SLICE].cpu(), getattr(m_cpu, f)),
                 f"phase 27 merging: {f} differs from the CPU port's")
    err = _util_slice_err("merging_eval", val, val_cpu, 1e-6)
    print(f"[phase 27 (a)] PASS merging: {lanes} models (a 1024^2 image), capacity 16, 64 "
          f"inserts each in {1e3 * wall:.3f} ms; knots equal to the CPU port's on {UTIL_SLICE} "
          f"lanes, merging_eval within {err:.3g}")
    return dict(wall=wall, err=err)


def _capture_photon_map(caustic, pcfg):
    """One warm bench-config-5 PPM pass (seed 0) with the global map's
    `build_photon_tiles` and `photon_density` arguments captured."""
    import torch
    from cudatracerlib_tpu_torch.ops import photon_gather as pg_ops
    from cudatracerlib_tpu_torch.render import ppm

    tile_calls, density_calls = [], []
    real_tiles, real_density = pg_ops.build_photon_tiles, pg_ops.photon_density

    def capture_tiles(*args, **kw):
        tile_calls.append((args, kw))
        return real_tiles(*args, **kw)

    def capture_density(*args):
        density_calls.append(args)
        return real_density(*args)

    pg_ops.build_photon_tiles, pg_ops.photon_density = capture_tiles, capture_density
    try:
        ppm.render_ppm_pass(caustic, PPM_W, PPM_H, PPM_SPP, 0, PPM_PASS, pcfg)
        torch.cuda.synchronize()
    finally:
        pg_ops.build_photon_tiles, pg_ops.photon_density = real_tiles, real_density
    _require(len(tile_calls) == 2 and len(density_calls) == 2,
             f"a PPM pass built {len(tile_calls)} photon maps, not 2")
    return tile_calls[0], density_calls[0]


def _query_reduce_part(caustic):
    """Phase 27 (b): `query_reduce` with the Epanechnikov density weight
    over the global photon map against `photon_density` on the same
    queries."""
    import numpy as np
    import torch
    from cudatracerlib_tpu_torch.accel import hashgrid
    from cudatracerlib_tpu_torch.math import kernels
    from cudatracerlib_tpu_torch.math.vecmath import dot
    from cudatracerlib_tpu_torch.ops import photon_gather as pg_ops
    from cudatracerlib_tpu_torch.render import ppm

    norm = kernels.normalization(kernels.EPANECHNIKOV, 2)
    _require(abs(norm - 2.0 / np.pi) <= 1e-6,
             f"phase 27: normalization(EPANECHNIKOV, 2) {norm} is not within 1e-6 of 2/pi")
    (tile_args, kw), dens_args = _capture_photon_map(caustic, ppm.PPMConfig())
    pos, power, normal, valid, lo, hi, res = tile_args
    tiles, aabbs, q_pos, q_n, q_valid, r = dens_args
    grid = hashgrid.build_grid(pos, lo, hi, res, valid=valid)
    qi = q_valid.nonzero()[:, 0]
    qp, qn = q_pos[qi], q_n[qi]
    _, count = hashgrid._candidates(grid, qp)
    n_cand = count.sum(1)
    k_max = int(n_cand.max())
    chunk = max(1, UTIL_PAYLOAD_BYTES // (k_max * 4 * 3 * 4))
    payload = {"p": pos, "power": power, "n": normal, "wi": kw["wi"]}

    def reduce_over(q, n):
        def fn(acc, pl, ok):
            diff = pl["p"] - q[:, None, :]
            d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + diff[..., 2] * diff[..., 2]
            w = kernels.density_weight(kernels.EPANECHNIKOV, torch.sqrt(d2), r, 2, norm=norm)
            nq = n[:, None, :]
            use = ok & (dot(nq, pl["n"]) > pg_ops.NORMAL_MIN_DOT) & (dot(nq, pl["wi"]) >= 0.0)
            w = torch.where(use, w, 0.0)
            return acc + torch.cat([(w[..., None] * pl["power"]).sum(1), w.sum(1, keepdim=True)], -1)
        return fn

    def run_reduce():
        out = []
        for s in range(0, qp.shape[0], chunk):
            q, n = qp[s:s + chunk], qn[s:s + chunk]
            out.append(hashgrid.query_reduce(grid, payload, q, r, k_max, reduce_over(q, n),
                                             torch.zeros(q.shape[0], 4, device=q.device)))
        return torch.cat(out)

    t_reduce, red = _timed(run_reduce)
    t_kernel, (kf, kw_sum) = _timed(lambda: pg_ops.photon_density(tiles, aabbs, q_pos, q_n,
                                                                  q_valid, r))
    scale = norm / float(np.float32(r)) ** 2
    ref = torch.cat([kf[qi], kw_sum[qi, None]], -1).double() * scale
    diff = (red.double() - ref).abs()
    worst = {}
    for j, what in ((slice(0, 3), "flux"), (slice(3, 4), "sum_w")):
        p, dd = ref[:, j], diff[:, j]
        bad = dd > DENSITY_RTOL * p.abs() + DENSITY_ATOL * float(p.abs().max())
        _require(not bool(bad.any()), f"phase 27 query_reduce {what}: {int(bad.sum())} sums "
                                      f"outside tolerance, worst {float(dd.max())}")
        big = p.abs() > 1e-3 * float(p.abs().max())
        worst[what] = float((dd[big] / p.abs()[big]).max())
    pairs = int(n_cand.sum())
    chunk = min(chunk, qp.shape[0])
    print(f"[phase 27 (b)] PASS query_reduce: {qp.shape[0]} of {q_pos.shape[0]} eye queries "
          f"valid, {int(valid.sum())} photons in the global map, radius {float(r):.6f}, "
          f"max_neighbors {k_max} (the largest 27-cell candidate count: no query capped), "
          f"{pairs} candidate pairs in {-(-qp.shape[0] // chunk)} chunk(s) of {chunk} queries; "
          f"query_reduce {1e3 * t_reduce:.3f} ms, photon_density {1e3 * t_kernel:.3f} ms; max rel "
          f"err flux {worst['flux']:.3g}, sum_w {worst['sum_w']:.3g}; "
          f"normalization(EPANECHNIKOV, 2) {norm:.9f} (2/pi {2 / np.pi:.9f})")
    return dict(wall=t_reduce, kernel_wall=t_kernel, k_max=k_max, pairs=pairs, rel=worst,
                queries=qp.shape[0], chunks=-(-qp.shape[0] // chunk))


def _debug_viz_part(scene, size):
    """Phase 27 (c): Cornell's AOVs at size^2 on the card, visualized and
    overlaid, with a vector field drawn, against the CPU port on the same
    buffers."""
    import numpy as np
    import torch
    from cudatracerlib_tpu_torch.image import debug_viz as dv
    from cudatracerlib_tpu_torch.render.prim_tracer import render_aovs
    from cudatracerlib_tpu_torch.scene import sensors

    dev = scene.light_cdf.device

    def buffers():
        aov = render_aovs(scene, size, size)
        pid = torch.arange(size * size, device=dev)
        uv = torch.stack([(pid % size + 0.5) / size, (pid // size + 0.5) / size], -1).float()
        o, d, _ = sensors.sample_ray(scene.camera, uv, torch.zeros(size * size, 2, device=dev))
        depth = aov["depth"]
        points = (o + d * depth.reshape(-1, 1)).reshape(size, size, 3)
        return depth, aov["normal_sh"] * 2.0 - 1.0, aov["albedo"], points

    def draw(cam, depth, normal, albedo, points):
        scal = dv.visualize_scalar(depth)
        vec = dv.visualize_vec3(normal)
        over = dv.overlay(albedo, vec, 0.5, mask=depth > 0)
        field = dv.draw_vector_field(over, cam, points, normal, depth > 0, stride=8, scale=0.1)
        return scal, vec, over, field

    t_aov, bufs = _timed(buffers)
    t_draw, out = _timed(lambda: draw(scene.camera, *bufs))
    out_cpu = draw(scene.camera.to("cpu"), *(b.cpu() for b in bufs))
    for name, a in zip(("visualize_scalar", "visualize_vec3", "overlay", "draw_vector_field"), out):
        a = torch.as_tensor(a)
        _require(bool(torch.isfinite(a).all()) and float(a.min()) >= 0.0 and float(a.max()) <= 1.0,
                 f"phase 27 {name}: not finite or outside [0, 1]")
    errs = [float((a.cpu() - b).abs().max()) for a, b in zip(out[:3], out_cpu[:3])]
    _require(max(errs) <= 1e-6, f"phase 27 debug_viz: the card's images {errs} from the CPU port's")
    drawn = np.any(out[3] != out[2].cpu().numpy(), axis=-1)
    off = int(np.any(out[3] != out_cpu[3], axis=-1).sum())
    _require(off == 0, f"phase 27 draw_vector_field: {off} pixels differ from the CPU port's")
    _require(bool(drawn.any()), "phase 27 draw_vector_field drew nothing")
    print(f"[phase 27 (c)] PASS debug_viz: render_aovs Cornell {size}x{size} {1e3 * t_aov:.3f} ms; "
          f"visualize_scalar(depth), visualize_vec3(normal), overlay and draw_vector_field "
          f"(stride 8, {int(drawn.sum())} pixels drawn) {1e3 * t_draw:.3f} ms; finite, in [0, 1], "
          f"max abs err from the CPU port {max(errs):.3g}, drawn pixels equal")
    return dict(wall=t_aov + t_draw, aov_wall=t_aov, draw_wall=t_draw, drawn=int(drawn.sum()))


def _utils_phase(scene, caustic, smi, reset_counts):
    """Phase 27 (module docstring): the math utilities, `query_reduce` and
    the debug visualizers on the card, each against the CPU port."""
    import torch
    from cudatracerlib_tpu_torch.ops import photon_gather as pg_ops

    dev = scene.light_cdf.device
    t0 = time.perf_counter()
    out = {"spline": _spline_part(dev, UTIL_LANES), "quadrature": _quadrature_part(dev, UTIL_LANES),
           "compression": _compression_part(dev, UTIL_LANES),
           "merging": _merging_part(dev, UTIL_LANES)}
    t_a = time.perf_counter()
    reset_counts()
    out["query_reduce"] = _query_reduce_part(caustic)
    torch.cuda.synchronize()
    out["launches"] = dict(pg_ops.launches)
    t_b = time.perf_counter()
    out["debug_viz"] = _debug_viz_part(scene, UTIL_AOV_SIZE)
    t_c = time.perf_counter()
    print(f"[wall] phase 27 (a) {t_a - t0:.1f} s, (b) {t_b - t_a:.1f} s (photon_density launches "
          f"{out['launches']}), (c) {t_c - t_b:.1f} s; {smi}")
    return out


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
    from cudatracerlib_tpu_torch.accel.bvh import build_bvh, tree_depth, vertex_rows, woop_transform
    from cudatracerlib_tpu_torch.accel.traversal import STACK_DEPTH
    from cudatracerlib_tpu_torch.ops import delta_track as dt_op
    from cudatracerlib_tpu_torch.ops import intersect_bvh as bvh_ops
    from cudatracerlib_tpu_torch.ops import intersect_dense as ops
    from cudatracerlib_tpu_torch.ops import photon_gather as pg_ops
    from cudatracerlib_tpu_torch.ops import shade_gather as sg_ops
    from cudatracerlib_tpu_torch.ops import transmittance as tr_op
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

    counters = (ops.launches, bvh_ops.launches, sg_ops.launches, pg_ops.launches, tr_op.launches,
                dt_op.launches)

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
              "photon_gather.cu": pg_ops.get_lib, "transmittance.cu": tr_op.get_lib,
              "delta_track.cu": dt_op.get_lib, "bvh_builder.cpp (g++)": native.get_lib}
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
    woop, boxes, verts = scene.bvh.woop, scene.bvh.chunk_boxes, scene.bvh.tri_verts
    cam = _compare("cornell camera rays", woop, o, d, 1e-4, torch.inf, 50, boxes, verts)
    bounce = _compare("cornell first-bounce rays", woop,
                      *_first_bounce(scene, cfg, o, d, sampler), 1e-4, torch.inf, 50, boxes,
                      verts)

    tris, so, sd = _soup(0, 4096, 0.08, dev)
    soup = torch.from_numpy(woop_transform(tris[:, 0], tris[:, 1], tris[:, 2])).to(dev)
    soup_r = _compare("soup4096", soup, so, sd, 1e-4, 2.0, 10, None,
                      vertex_rows(torch.from_numpy(tris)).to(dev))

    # the PPM path: intersect_dense's and photon_density's arguments, captured
    # in bench config 5's warm pass (seed 0; 9 times the pass at seed 7)
    caustic = caustic_scene()
    _require(caustic.bvh.woop.device.type == "cuda", "caustic_scene() did not build on the card")
    pcfg = ppm.PPMConfig()
    ppm_args, captured = _capture_ppm(caustic, pcfg)
    ppm_r = {label: _compare(label, c[0], c[1], c[2], c[3], c[4], 20, c[6], c[7])
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
    bdpt_r = {label: _compare(label, c[0], c[1], c[2], c[3], c[4], 20, c[6], c[7])
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

    # ---- 22. multi-device: the sharded render, train step and PPM pass ----
    md = _multidevice_phase(scene, caustic, smi)
    lap(22)

    # ---- 23. textures, material maps, the subsurface walk and cornell_box_deluxe ----
    tx = _texture_phase(smi, reset_counts)
    lap(23)

    # ---- 24. dynamic and instanced scenes, refit and skinning, adaptive sampling, counters ----
    dy = _dynamic_phase(smi, reset_counts)
    lap(24)

    # ---- 25. the spectral, guided, realtime and AOV engines, generate_fits ----
    en = _engines_phase(big, smi, reset_counts)
    lap(25)

    # ---- 26. the watertight test; scene files loaded and rendered; the entry points ----
    crack = _crack_part(smi)
    print(f"[time] rows 1-2 at their main-path shapes (repaired test): intersect_dense Cornell "
          f"2^20 x 60 {cam['ms']:.4f} ms, PPM photon 2^17 x 3,160 "
          f"{ppm_r['ppm photon rays']['ms']:.4f} ms; intersect_bvh glossy camera "
          f"{ms_bvh:.4f} ms, bigscene camera {big_cam['ms']:.4f} ms; AOV means worst "
          f"{en['runs']['aovs']['worst']:.3g} from JAX's (gate {AOV_TOL}); {smi}")
    part26 = time.perf_counter()
    io = _io_phase(big, dict(mean=float(img3.mean()), rays=int(rays3), dt=dt3), smi,
                   reset_counts)
    print(f"[wall] phase 26 (a) and (b)-(d): {part26 - marks[-1]:.1f} s and "
          f"{time.perf_counter() - part26:.1f} s")
    lap(26)

    # ---- 27. the math utilities, query_reduce and the debug visualizers ----
    ut = _utils_phase(scene, caustic, smi, reset_counts)
    lap(27)
    print(f"[wall] chip_smoke.py phases 1-27: {time.perf_counter() - t_start:.1f} s after the "
          f"imports")
    enl, enr = en["launches"], en["runs"]
    dyr = dy["runs"]
    dy_dense = lambda *names: sum(sum(dyr[k]["launches"]["intersect_dense"].values())  # noqa: E731
                                  for k in names)
    dy_bvh = lambda *names: sum(sum(dyr[k]["launches"]["intersect_bvh"].values())  # noqa: E731
                                for k in names)
    dy_inst = ("instanced", "forest instanced", "spheres instanced")
    dy_adapt = ("adaptive cornell", "adaptive glossy wavefront")
    dy_refit = lambda kernel: sum(sum(a["launches"][kernel].values())  # noqa: E731
                                  for a in dy["anim"].values())
    tx_launch = {k: r["launches"] for k, r in tx["runs"].items()}
    tx_dense = sum(v["intersect_dense"]["closest"] + v["intersect_dense"]["any_hit"]
                   for v in tx_launch.values())
    mdl, mrl = md["launches"], md["rank_launches"]
    md_dense = lambda part: sum(part["intersect_dense"].values())  # noqa: E731
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
                *sp_c["dense"].values(), *sp_v["dense"].values(), *sh["dense"].values(),
                *md["dense"].values(), *tx["dense"].values(), *dy["dense"].values(),
                *en["dense"].values()))),
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
            "sharded_render_launches": md_dense(mdl["render"]),
            "sharded_train_launches": md_dense(mdl["train"]),
            "sharded_ppm_launches": md_dense(mdl["ppm"]),
            "sharded_ranks_launches": sum(md_dense(mrl[k]) for k in mrl),
            "sharded_max_abs_err": max(r["err"] for r in md["dense"].values()),
            "deluxe_launches": tx_launch["deluxe"]["intersect_dense"]["closest"]
            + tx_launch["deluxe"]["intersect_dense"]["any_hit"],
            "texture_phase_launches": tx_dense,
            "sss_walk_launches": tx_launch["sss"]["intersect_dense"]["closest"],
            "deluxe_max_abs_err": max(r["err"] for r in tx["dense"].values()),
            **{f"{k.replace(' rays', '').replace(' ', '_').replace('-', '_')}_{f}": (
                r[v][0] if v == "bound" else r[v])
               for k, r in tx["dense"].items()
               for f, v in (("ms", "ms"), ("plain_ms", "plain_ms"), ("bound_ms", "bound"))},
            **{f"{k.replace(' rays', '').replace(' ', '_')}_{f}": (r[v][0] if v == "bound"
                                                                   else r[v])
               for k, r in md["dense"].items()
               for f, v in (("ms", "ms"), ("plain_ms", "plain_ms"), ("bound_ms", "bound"))},
            "instanced_launches": dy_dense(*dy_inst),
            "refit_launches": dy_refit("intersect_dense"),
            "adaptive_launches": dy_dense(*dy_adapt),
            "dynamic_max_abs_err": max(r["err"] for r in dy["dense"].values()),
            **{f"{k.replace(' ', '_')}_{f}": (r[v][0] if v == "bound" else r[v])
               for k, r in dy["dense"].items()
               for f, v in (("ms", "ms"), ("plain_ms", "plain_ms"), ("bound_ms", "bound"))},
            "engines_launches": sum(enl["intersect_dense"].values()),
            "spectral_launches": sum(sum(enr[k]["launches"]["intersect_dense"].values())
                                     for k in ("spectral cornell", "spectral caustic",
                                               "spectral dispersive")),
            "guided_launches": sum(enr["guided"]["launches"]["intersect_dense"].values()),
            "engines_max_abs_err": max(r["err"] for r in en["dense"].values()),
            **{f"{k.replace(' rays', '').replace(' ', '_')}_{f}": (r[v][0] if v == "bound"
                                                                   else r[v])
               for k, r in en["dense"].items()
               for f, v in (("ms", "ms"), ("plain_ms", "plain_ms"), ("bound_ms", "bound"))},
            "crack_rays_through_wall": crack["dense_through_wall"],
            "crack_woop_test_through_wall": crack["woop_test_through_wall"],
            "crack_diagonal_rays_missed": sum(r["dense_missed"]
                                              for r in crack["diagonals"].values()),
            "crack_off_plain": crack["dense_off"],
            "media_maps_launches": sum(io["media"]["launches"]["intersect_dense"].values()),
        },
        {
            "name": "intersect_bvh",
            "route": "cuda",
            "source": "cudatracerlib_tpu_torch/csrc/intersect_bvh.cu",
            "replaces": "cudatracerlib_tpu/ops/cluster_trace.py:411",
            "launches": glaunch["intersect_bvh"]["closest"] + glaunch["intersect_bvh"]["any_hit"],
            "max_abs_err": max(err_g, err_g1, err_s65, big_cam["err"], big_b1["err"],
                               *(r["err"] for r in dy["bvh"].values()), enr["fast"]["err"]),
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
            "instanced_launches": dy_bvh(*dy_inst),
            "refit_launches": dy_refit("intersect_bvh"),
            "adaptive_launches": dy_bvh(*dy_adapt),
            "dynamic_max_abs_err": max(r["err"] for r in dy["bvh"].values()),
            "sphere_instance_empty_share": dy["bvh"]["sphere instance"]["empty"],
            **{f"{k.replace(' ', '_')}_{f}": (r[v][0] if v == "bound" else r[v])
               for k, r in dy["bvh"].items()
               for f, v in (("ms", "ms"), ("plain_ms", "plain_ms"), ("bound_ms", "bound"))},
            "refitted_visits": dy["anim"]["bvh"]["visits_refit"],
            "rebuilt_visits": dy["anim"]["bvh"]["visits_rebuilt"],
            "rebuilt_ms": dy["anim"]["bvh"]["ms_rebuilt"],
            "engines_launches": sum(enl["intersect_bvh"].values()),
            "render_fast_launches": enr["fast"]["launches"]["intersect_bvh"]["closest"],
            "render_fast_max_abs_err": enr["fast"]["err"],
            "render_fast_differing_pixels": enr["fast"]["off"],
            "render_fast_ms": enr["fast"]["ms"],
            "render_fast_plain_ms": enr["fast"]["plain_ms"],
            "render_fast_bound_ms": enr["fast"]["bound"][0],
            "render_fast_bound_by": enr["fast"]["bound"][1],
            "render_fast_pass_ms": enr["fast"]["dt"] * 1e3,
            "crack_rays_through_wall": crack["bvh_through_wall"],
            "crack_diagonal_rays_missed": sum(r["bvh_missed"] for r in crack["diagonals"].values()),
            "crack_off_plain": crack["bvh_off"],
            "loaded_bigscene_launches": sum(io["big"]["launches"]["intersect_bvh"].values()),
        },
        {
            "name": "packed_gather",
            "route": "cuda",
            "source": "cudatracerlib_tpu_torch/csrc/shade_gather.cu",
            "replaces": "cudatracerlib_tpu/ops/shade_gather.py:69",
            "launches": glaunch["packed_gather"]["gather"],
            "max_abs_err": max(gather_err, sp_c["gather"]["err"], sh["gather"]["err"],
                               md["gather"]["err"], tx["gather"]["err"], dy["gather"]["err"],
                               en["gather"]["err"]),
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
            "sharded_ppm_launches": mdl["ppm"]["shade_gather"]["gather"],
            "sharded_ranks_ppm_launches": mrl["ppm"]["shade_gather"]["gather"],
            "deluxe_launches": tx_launch["deluxe"]["shade_gather"]["gather"],
            **{f"deluxe_{f}": (tx["gather"][v][0] if v == "bound" else tx["gather"][v])
               for f, v in (("ms", "ms"), ("plain_ms", "plain_ms"), ("library_ms", "lib_ms"),
                            ("bound_ms", "bound"))},
            **{f"sharded_ppm_{f}": (md["gather"][v][0] if v == "bound" else md["gather"][v])
               for f, v in (("ms", "ms"), ("plain_ms", "plain_ms"), ("library_ms", "lib_ms"),
                            ("bound_ms", "bound"))},
            "flattened_launches": dyr["forest flattened"]["launches"]["shade_gather"]["gather"],
            "adaptive_launches": sum(dyr[k]["launches"]["shade_gather"]["gather"]
                                     for k in dy_adapt),
            "dynamic_max_abs_err": dy["gather"]["err"],
            **{f"forest_{f}": (dy["gather"][v][0] if v == "bound" else dy["gather"][v])
               for f, v in (("ms", "ms"), ("plain_ms", "plain_ms"), ("library_ms", "lib_ms"),
                            ("bound_ms", "bound"))},
            "engines_launches": enl["shade_gather"]["gather"],
            "guided_launches": enr["guided"]["launches"]["shade_gather"]["gather"],
            "guided_max_abs_err": en["gather"]["err"],
            **{f"guided_{f}": (en["gather"][v][0] if v == "bound" else en["gather"][v])
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
                               sh["splat"]["err"], md["bwd"]["err"], tx["atlas"]["err"],
                               dy["woop"]["err"], dy["verts"]["err"], en["deposit"]["err"]),
            "ms": bwd["pack"]["ms"],
            "plain_ms": bwd["pack"]["plain_ms"],
            "bound_ms": bwd["pack"]["bound"][0],
            "bound_by": bwd["pack"]["bound"][1],
            "library_ms": bwd["pack"]["lib_ms"],
            "wrapper_ms": bwd["pack"]["wrap_ms"],
            "pairs": bwd["pack"]["pairs"],
            "bands": bwd["pack"]["bands"],
            "scratch_bytes": bwd["pack"]["scratch"],
            "max_rel_err": max(*(b["rel"] for b in bwd.values()), vg["grid"]["rel"],
                               vg["table"]["rel"], tx["atlas"]["rel"]),
            "range_launches": gl["shade_gather"]["gather_bwd_range"],
            "final_launches": gl["shade_gather"]["gather_bwd_final"],
            "cornell_launches": cgrad["launches"]["shade_gather"]["gather_bwd_tile"],
            **{f"{k}_{f}": bwd[k][v] for k in ("texture", "woop")
               for f, v in (("ms", "ms"), ("wrapper_ms", "wrap_ms"), ("plain_ms", "plain_ms"),
                            ("library_ms", "lib_ms"), ("pairs", "pairs"), ("bands", "bands"),
                            ("scratch_bytes", "scratch"))},
            **{f"{k}_bound_ms": bwd[k]["bound"][0] for k in ("texture", "woop")},
            "splat_launches": launch5["packed_gather"]["gather_bwd_tile"],
            "splat_max_abs_err": max(splat_bdpt["err"], splat_lt["err"]),
            "splat_max_rel_err": max(splat_bdpt["rel"], splat_lt["rel"]),
            **{f"{k}_splat_{f}": (r[v][0] if v == "bound" else r[v])
               for k, r in (("bdpt", splat_bdpt), ("lt", splat_lt))
               for f, v in (("ms", "ms"), ("wrapper_ms", "wrap_ms"), ("plain_ms", "plain_ms"),
                            ("library_ms", "lib_ms"), ("bound_ms", "bound"), ("pairs", "pairs"),
                            ("bands", "bands"), ("scratch_bytes", "scratch"))},
            "lt_splat_launches": launch_lt["packed_gather"]["gather_bwd_tile"],
            "filter_splat_launches": sh_launch["cornell gaussian"]["shade_gather"]["gather_bwd_tile"],
            "shading_splat_launches": sum(v["shade_gather"]["gather_bwd_tile"]
                                          for v in sh_launch.values()),
            **{f"filter_splat_{f}": (sh["splat"][v][0] if v == "bound" else sh["splat"][v])
               for f, v in (("ms", "ms"), ("wrapper_ms", "wrap_ms"), ("plain_ms", "plain_ms"),
                            ("library_ms", "lib_ms"), ("bound_ms", "bound"),
                            ("max_abs_err", "err"), ("max_rel_err", "rel"),
                            ("scratch_bytes", "scratch"), ("per_tap_calls_ms", "per_tap_ms"),
                            ("pairs", "pairs"), ("bands", "bands"))},
            "grid_launches": vgl["shade_gather"]["gather_bwd_tile"],
            **{f"{k}_{f}": (vg[k][v][0] if v == "bound" else vg[k][v])
               for k in ("grid", "table")
               for f, v in (("lanes", "lanes"), ("rows", "rows"), ("ms", "ms"),
                            ("wrapper_ms", "wrap_ms"), ("plain_ms", "plain_ms"),
                            ("library_ms", "lib_ms"), ("bound_ms", "bound"),
                            ("max_abs_err", "err"), ("max_rel_err", "rel"),
                            ("captured_rel_err", "captured_rel"), ("scratch_bytes", "scratch"),
                            ("row_list_bytes", "row_lists"), ("pairs", "pairs"),
                            ("bands", "bands"))},
            "atlas_launches": tx["grad"]["deluxe"]["launches"]["shade_gather"]["gather_bwd_tile"],
            "sss_grad_launches": tx["grad"]["sss"]["launches"]["shade_gather"]["gather_bwd_tile"],
            **{f"atlas_{f}": (tx["atlas"][v][0] if v == "bound" else tx["atlas"][v])
               for f, v in (("lanes", "lanes"), ("rows", "rows"), ("ms", "ms"),
                            ("wrapper_ms", "wrap_ms"), ("plain_ms", "plain_ms"),
                            ("library_ms", "lib_ms"), ("bound_ms", "bound"),
                            ("max_abs_err", "err"), ("max_rel_err", "rel"),
                            ("captured_rel_err", "captured_rel"), ("scratch_bytes", "scratch"),
                            ("row_list_bytes", "row_lists"), ("pairs", "pairs"),
                            ("bands", "bands"))},
            "sharded_train_launches": mdl["train"]["shade_gather"]["gather_bwd_tile"],
            "sharded_ranks_train_launches": mrl["train"]["shade_gather"]["gather_bwd_tile"],
            **{f"sharded_train_{f}": (md["bwd"][v][0] if v == "bound" else md["bwd"][v])
               for f, v in (("lanes", "lanes"), ("rows", "rows"), ("ms", "ms"),
                            ("wrapper_ms", "wrap_ms"), ("plain_ms", "plain_ms"),
                            ("library_ms", "lib_ms"), ("bound_ms", "bound"),
                            ("max_abs_err", "err"), ("captured_rel_err", "captured_rel"))},
            "refit_launches": dy["grad_launches"]["shade_gather"]["gather_bwd_tile"],
            "woop_launches": dy["bwd_calls"].get((12, dy["woop"]["rows"]), 0),
            "verts_launches": dy["bwd_calls"].get((9, dy["verts"]["rows"]), 0),
            "dynamic_max_abs_err": max(dy["woop"]["err"], dy["verts"]["err"]),
            **{f"pose_{k}_{f}": (dy[k][v][0] if v == "bound" else dy[k][v])
               for k in ("woop", "verts")
               for f, v in (("lanes", "lanes"), ("rows", "rows"), ("ms", "ms"),
                            ("wrapper_ms", "wrap_ms"), ("plain_ms", "plain_ms"),
                            ("library_ms", "lib_ms"), ("bound_ms", "bound"),
                            ("max_abs_err", "err"), ("captured_rel_err", "captured_rel"))},
            "engines_launches": enl["shade_gather"]["gather_bwd_tile"],
            "spectral_grad_launches": en["grad_launches"]["shade_gather"]["gather_bwd_tile"],
            "guided_deposit_launches": enr["guided"]["train_launches"]["shade_gather"][
                "gather_bwd_tile"],
            "engines_max_abs_err": en["deposit"]["err"],
            **{f"guided_deposit_{f}": (en["deposit"][v][0] if v == "bound" else en["deposit"][v])
               for f, v in (("lanes", "lanes"), ("rows", "rows"), ("ms", "ms"),
                            ("wrapper_ms", "wrap_ms"), ("plain_ms", "plain_ms"),
                            ("library_ms", "lib_ms"), ("bound_ms", "bound"),
                            ("max_abs_err", "err"), ("captured_rel_err", "captured_rel"),
                            ("pairs", "pairs"), ("bands", "bands"), ("scratch_bytes", "scratch"),
                            ("row_list_bytes", "row_lists"))},
        },
        {
            "name": "photon_density",
            "route": "cuda",
            "source": "cudatracerlib_tpu_torch/csrc/photon_gather.cu",
            "replaces": "cudatracerlib_tpu/ops/photon_gather.py:164",
            "launches": plaunch["photon_density"]["density"],
            "max_abs_err": max(dens_err, md["dens_err"]),
            "ms": pd_ms["global map"]["ms"],
            "plain_ms": plain_ms_pd,
            "bound_ms": pd_bound[0],
            "bound_by": pd_bound[1],
            "library_ms": None,
            "wrapper_ms": pd_ms["global map"]["wrap_ms"],
            "reduce_launches": plaunch["photon_density"]["density_reduce"],
            "caustic_ms": pd_ms["caustic map"]["ms"],
            "caustic_bound_ms": work["caustic map"]["bound"][0],
            "sharded_ppm_launches": mdl["ppm"]["photon_gather"]["density"],
            "sharded_ranks_ppm_launches": mrl["ppm"]["photon_gather"]["density"],
            "utils_launches": ut["launches"]["density"],
            "utils_query_reduce_ms": 1e3 * ut["query_reduce"]["wall"],
            "utils_kernel_wall_ms": 1e3 * ut["query_reduce"]["kernel_wall"],
            "utils_max_rel_err": max(ut["query_reduce"]["rel"].values()),
        },
        {
            "name": "transmittance",
            "route": "cuda",
            "source": "cudatracerlib_tpu_torch/csrc/transmittance.cu",
            "replaces": None,
            "launches": vol["tr_pass"]["fwd"],
            "max_abs_err": 0.0,
            "ms": vol["tr"]["segment"]["ms"],
            "plain_ms": vol["tr"]["segment"]["plain_ms"],
            "bound_ms": vol["tr"]["segment"]["bound"][0],
            "bound_by": vol["tr"]["segment"]["bound"][1],
            "library_ms": None,
            "shadow_ms": vol["tr"]["shadow"]["ms"],
            "pass_kernel_ms": vol["tr"]["kernel_ms_sum"],
            "step_launches": vgl["transmittance"],
            "step_kernel_ms": vg["tr"]["kernel_ms_sum"],
            **{f"grad_{k}_{f}": (vg["tr"][k][v][0] if v.endswith("bound") else vg["tr"][k][v])
               for k in ("segment", "shadow")
               for f, v in (("ms", "ms"), ("plain_ms", "plain_ms"), ("bound_ms", "bound"),
                            ("bwd_ms", "bwd_ms"), ("bwd_whole_ms", "bwd_whole_ms"),
                            ("bwd_bound_ms", "bwd_bound"), ("bwd_max_rel_err", "bwd_rel"))},
        },
        {
            "name": "delta_track",
            "route": "cuda",
            "source": "cudatracerlib_tpu_torch/csrc/delta_track.cu",
            "replaces": None,
            "launches": vol["track"]["render"]["launches"]["fwd"],
            "max_abs_err": 0.0,
            "ms": vol["track"]["render"]["ms"],
            "plain_ms": vol["track"]["render"]["eager_ms"],
            "bound_ms": vol["track"]["render"]["bound"][0],
            "bound_by": vol["track"]["render"]["bound"][1],
            "library_ms": None,
            "pass_kernel_ms": vol["track"]["render"]["kernel_ms_sum"],
            "lane_trips": vol["track"]["render"]["lane_trips"],
            "grad_ms": vol["track"]["grad"]["ms"],
            "grad_eager_ms": vol["track"]["grad"]["eager_ms"],
            "grad_bound_ms": vol["track"]["grad"]["bound"][0],
            "grad_pass_kernel_ms": vol["track"]["grad"]["kernel_ms_sum"],
        },
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
