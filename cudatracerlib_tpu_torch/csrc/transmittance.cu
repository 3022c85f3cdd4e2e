// A grid volume's transmittance along a ray segment, and its backward, for
// Hopper (sm_90a): the 'scalar' mode of scene/media.py `transmittance` (one
// shared scalar density grid scaled by the volume's base sigma_t per
// channel), one thread per lane.
//
// Replaces no TPU kernel: the JAX package scans the TAU_STEPS midpoint steps
// in XLA (cudatracerlib_tpu/scene/media.py `transmittance`). The port's eager
// version built (B, 32, 2, 2, 2) int64 corner indices and stacks, gathered
// 8 corners a step and summed the 32 columns one launch a column: about 110
// launches and several GB of intermediates a call at 2M lanes, some 600x the
// bound below. Here one thread keeps a lane's whole segment in registers.
//
// Forward, per lane, in the eager path's order: the ray-box clip of
// `_ray_box` (near, far, hit), seg and dt = seg / 32, the 32 midpoints of
// `_steps`, each step's trilinear lookup of `_grid_lookup1` (clamp, floor,
// corner rows, 8 loads, lerps in x, then y, then z: csrc/trilinear.cuh,
// shared with csrc/delta_track.cu), the left-to-right sum
// of `_scan_sum`, tau = st * (acc * dt) and where(act, exp(-tau), 1). Every
// operation is written with __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn in
// the eager path's order, so no FMA contraction moves a result, and expf is
// PyTorch's exp: the factor equals the eager path's bit for bit. The step
// sum `acc` is kept for the backward.
//
// Backward, a warp a lane: gtau_c = -g_c tr_c where the lane is active;
// the lane's share of st's cotangent, gtau_c acc dt (summed over lanes by the
// caller, a deterministic torch reduction); g_acc = dt sum_c gtau_c st_c,
// and each step's 8 corner cotangents ((g_acc wz) wy) wx with their grid
// rows, a thread a step, written in the eager layout (lane, step, corners
// x, y, z) for the deterministic gather backward (csrc/shade_gather_bwd.cu):
// no atomics. A thread a lane wrote each sector 4 bytes at a time, 1 KB
// apart across the warp; a warp a lane writes its 2 KB as float4 runs.
//
// What bounds it on the H100: per lane a clip, 32 x (a point, 3 divisions,
// 8 loads, 7 lerps), a sum and 3 exps, about 1,900 float operations against
// 28 bytes in and 12 out; 2^21 lanes are 4 GFLOP, 0.06 ms at 67 TFLOP/s.
// The divisions stay per point (a reciprocal would round otherwise). The
// loads are the cost: shadow and bounce rays scatter a warp's corners over
// the grid. Where the volume's grid fits a block's shared memory (the
// plume's 32^3 floats are 128 KB), each block stages it once and walks the
// lanes with a grid-stride loop, so a scattered warp meets bank conflicts
// rather than L1 misses: over a 1024^2, 2-spp plume pass's 12 calls, 7.32
// ms against 8.59 for the read-only path (A/B in one process, NVIDIA H100
// 80GB HBM3, 700 W). A larger grid reads through the read-only path. The
// backward writes 2 KB of cotangents and rows a lane for the gather
// backward: its bytes bound it.
//
// Plain C interface for ctypes; a scalar t_min / t_max comes as a value with
// a null pointer, a per-lane one as a pointer. Launches go on the caller's
// stream and each function returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cmath>

#include "trilinear.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int STAGED_BLOCK = 1024;  // the staged forward's block, one a SM
constexpr int TAU_STEPS = 32;  // scene/media.py TAU_STEPS

struct Volume {
  const float* box_min;  // (3,) of the volume
  const float* box_max;
  const int* active;     // the volume's flag
  const float* st;       // (3,) sigma_a + sigma_s
  const float* grid;     // the flat grid buffer
  int off;               // the grid's first row
  int r[3];              // its resolution
  float qmax[3];         // max(r - 1, 0) * (1 - 1e-6), rounded as the eager path
};

struct Lane {
  float o[3], d[3];
  float near, dt;
  bool act;
};

// `_ray_box` and the segment's step, then whether the volume attenuates
__device__ __forceinline__ Lane clip(const Volume& v, const float* o, const float* d,
                                     const float* t_min, float t_min_v, const float* t_max,
                                     float t_max_v, long long i) {
  Lane l;
  float lo = -INFINITY, hi = INFINITY;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    l.o[c] = o[3 * i + c];
    l.d[c] = d[3 * i + c];
    const float inv = __fdiv_rn(1.0f, fabsf(l.d[c]) < 1e-12f ? 1e-12f : l.d[c]);
    const float t0 = __fmul_rn(__fsub_rn(v.box_min[c], l.o[c]), inv);
    const float t1 = __fmul_rn(__fsub_rn(v.box_max[c], l.o[c]), inv);
    lo = fmaxf(lo, fminf(t0, t1));
    hi = fminf(hi, fmaxf(t0, t1));
  }
  l.near = fmaxf(lo, t_min ? t_min[i] : t_min_v);
  const float far = fminf(hi, t_max ? t_max[i] : t_max_v);
  l.dt = __fdiv_rn(fmaxf(__fsub_rn(far, l.near), 0.0f), static_cast<float>(TAU_STEPS));
  l.act = (l.near < far) && v.active[0] > 0;
  return l;
}

using trilinear::Cell;

// step s's midpoint and its trilinear cell (`_steps`, then csrc/trilinear.cuh)
__device__ __forceinline__ Cell cell(const Volume& v, const Lane& l, int s) {
  const float t = __fadd_rn(l.near, __fmul_rn(static_cast<float>(s) + 0.5f, l.dt));
  float p[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) p[c] = __fadd_rn(l.o[c], __fmul_rn(l.d[c], t));
  return trilinear::cell_at(v.box_min, v.box_max, v.off, v.r, v.qmax, p);
}

// STAGED: the block first copies the volume's grid into shared memory and
// walks the lanes with a grid-stride loop (one block of STAGED_BLOCK a SM);
// otherwise a thread a lane reads the corners through the read-only path
template <bool STAGED>
__global__ void __launch_bounds__(STAGED ? STAGED_BLOCK : BLOCK)
transmittance_kernel(Volume v, const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ t_min, float t_min_v,
                     const float* __restrict__ t_max, float t_max_v, long long n,
                     float* __restrict__ out, float* __restrict__ acc_out) {
  extern __shared__ float cells[];
  const int n_cells = v.r[0] * v.r[1] * v.r[2];
  if (STAGED) {
    for (int k = threadIdx.x; k < n_cells; k += blockDim.x) cells[k] = __ldg(v.grid + v.off + k);
    __syncthreads();
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const Lane l = clip(v, o, d, t_min, t_min_v, t_max, t_max_v, i);
    float acc = 0.0f;
    for (int s = 0; s < TAU_STEPS; ++s) {
      const Cell c = cell(v, l, s);
      float corner[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        corner[k] = STAGED ? cells[c.row[k] - v.off] : __ldg(v.grid + c.row[k]);
      acc = __fadd_rn(acc, trilinear::interpolate(corner, c.f));
    }
    if (acc_out) acc_out[i] = acc;
    const float ad = __fmul_rn(acc, l.dt);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[3 * i + c] = l.act ? expf(-__fmul_rn(v.st[c], ad)) : 1.0f;
  }
}

// one warp a lane and a thread a step (TAU_STEPS is the warp's width), so a
// warp writes its lane's 32 x 8 cotangents and rows as 1 KB runs of float4
__global__ void __launch_bounds__(BLOCK)
transmittance_bwd_kernel(Volume v, const float* __restrict__ o, const float* __restrict__ d,
                         const float* __restrict__ t_min, float t_min_v,
                         const float* __restrict__ t_max, float t_max_v, long long n,
                         const float* __restrict__ g, const float* __restrict__ tr,
                         const float* __restrict__ acc, float* __restrict__ g_corner,
                         int* __restrict__ rows, float* __restrict__ g_st) {
  static_assert(TAU_STEPS == 32, "a warp holds one lane's steps");
  const long long i = (static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x) / TAU_STEPS;
  const int s = threadIdx.x % TAU_STEPS;
  if (i >= n) return;
  const Lane l = clip(v, o, d, t_min, t_min_v, t_max, t_max_v, i);
  const float ad = __fmul_rn(acc[i], l.dt);
  float g_ad = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float gtau = l.act ? -__fmul_rn(g[3 * i + c], tr[3 * i + c]) : 0.0f;
    if (s == 0) g_st[3 * i + c] = __fmul_rn(gtau, ad);
    g_ad = __fadd_rn(g_ad, __fmul_rn(gtau, v.st[c]));
  }
  const float g_acc = __fmul_rn(g_ad, l.dt);
  const Cell c = cell(v, l, s);
  float gc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float wz = (k & 1) ? c.f[2] : __fsub_rn(1.0f, c.f[2]);
    const float wy = (k & 2) ? c.f[1] : __fsub_rn(1.0f, c.f[1]);
    const float wx = (k & 4) ? c.f[0] : __fsub_rn(1.0f, c.f[0]);
    gc[k] = __fmul_rn(__fmul_rn(__fmul_rn(g_acc, wz), wy), wx);
  }
  const long long base = (i * TAU_STEPS + s) * 2;  // in 16-byte units
  float4* gq = reinterpret_cast<float4*>(g_corner) + base;
  int4* rq = reinterpret_cast<int4*>(rows) + base;
  gq[0] = make_float4(gc[0], gc[1], gc[2], gc[3]);
  gq[1] = make_float4(gc[4], gc[5], gc[6], gc[7]);
  rq[0] = make_int4(c.row[0], c.row[1], c.row[2], c.row[3]);
  rq[1] = make_int4(c.row[4], c.row[5], c.row[6], c.row[7]);
}

Volume make_volume(const float* box_min, const float* box_max, const int* active,
                   const float* st, const float* grid, int off, int rx, int ry, int rz,
                   float qx, float qy, float qz) {
  Volume v;
  v.box_min = box_min;
  v.box_max = box_max;
  v.active = active;
  v.st = st;
  v.grid = grid;
  v.off = off;
  v.r[0] = rx;
  v.r[1] = ry;
  v.r[2] = rz;
  v.qmax[0] = qx;
  v.qmax[1] = qy;
  v.qmax[2] = qz;
  return v;
}

unsigned blocks(long long n) { return static_cast<unsigned>((n + BLOCK - 1) / BLOCK); }

}  // namespace

extern "C" int transmittance_launch(const float* o, const float* d, const float* t_min,
                                    float t_min_v, const float* t_max, float t_max_v,
                                    const float* box_min, const float* box_max,
                                    const int* active, const float* st, const float* grid,
                                    int off, int rx, int ry, int rz, float qx, float qy,
                                    float qz, long long n, float* out, float* acc,
                                    void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const Volume v = make_volume(box_min, box_max, active, st, grid, off, rx, ry, rz, qx, qy, qz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t smem = sizeof(float) * static_cast<size_t>(rx) * ry * rz;
  if (smem <= static_cast<size_t>(smem_max)) {
    cudaFuncSetAttribute(transmittance_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    int per_sm = 1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, transmittance_kernel<true>,
                                                  STAGED_BLOCK, smem);
    const long long need = (n + STAGED_BLOCK - 1) / STAGED_BLOCK;
    const long long fill = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    transmittance_kernel<true><<<static_cast<unsigned>(need < fill ? need : fill), STAGED_BLOCK,
                                 smem, s>>>(v, o, d, t_min, t_min_v, t_max, t_max_v, n, out, acc);
  } else {
    transmittance_kernel<false><<<blocks(n), BLOCK, 0, s>>>(v, o, d, t_min, t_min_v, t_max,
                                                            t_max_v, n, out, acc);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int transmittance_bwd(const float* o, const float* d, const float* t_min,
                                 float t_min_v, const float* t_max, float t_max_v,
                                 const float* box_min, const float* box_max,
                                 const int* active, const float* st, int off, int rx, int ry,
                                 int rz, float qx, float qy, float qz, long long n,
                                 const float* g, const float* tr, const float* acc,
                                 float* g_corner, int* rows, float* g_st, void* stream) {
  if (n > 0)
    transmittance_bwd_kernel<<<blocks(n * TAU_STEPS), BLOCK, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        make_volume(box_min, box_max, active, st, nullptr, off, rx, ry, rz, qx, qy, qz), o, d,
        t_min, t_min_v, t_max, t_max_v, n, g, tr, acc, g_corner, rows, g_st);
  return static_cast<int>(cudaGetLastError());
}
