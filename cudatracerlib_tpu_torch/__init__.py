"""cudatracerlib_tpu_torch — the PyTorch/CUDA port of cudatracerlib_tpu.

The module layout and names follow the JAX package one for one, so each
counterpart is easy to find; `cudatracerlib_tpu/` stays the reference the
port is tested against. This package imports torch and numpy, never jax.

Layer map (the Cornell and glossy path-tracing slices):
  math/      — vectors, frames, warps, MIS, Fresnel, microfacets, rough
               transmittance
  sampling/  — counter-based RNG, sampling records
  native/    — the C++ SBVH builder, compiled from the JAX package's source
  accel/     — BVH arrays, Woop intersection, the BVH stack-walk oracle,
               intersector dispatch
  ops/       — hand-written CUDA kernels (sources in csrc/) + plain versions:
               dense and BVH intersection, the shade-pack gather
  scene/     — textures, BSDFs, lights, camera, Scene, shade pack, scenes
  render/    — the unidirectional path tracer and the wavefront engine
  convert    — builds a port Scene from the JAX Scene's arrays

Scene factories and `build_scene` put their tensors on the card unless the
caller passes device="cpu"; entry points run on the scene's device. Kernels
and native libraries are built at first use into `_build/`.
"""

__version__ = "0.1.0"
