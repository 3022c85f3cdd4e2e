// Dense ray / Woop-triangle intersection for Hopper (sm_90a): a warp-culled
// sweep over chunk boxes.
//
// Replaces the Pallas TPU kernel cudatracerlib_tpu/ops/intersect_pallas.py:89
// `intersect_dense` (body `_dense_kernel`, :33-85): for each ray, the closest
// hit over ALL T Woop triangles (T <= DENSE_MAX_TRIS = 4096) with t in
// (t_min, t_max). t, u, v as in `_dense_kernel`: the |dz| < 1e-20 guard,
// `t > tmin && t < best_t` starting from tmax (clamped to 1e30), ascending
// triangle order with a strict `<` so the lowest index wins a tie (leaf
// padding duplicates rows). Whether the ray crosses the triangle is the
// watertight edge test (watertight.cuh, accel/traversal.py `_watertight`)
// on the row's vertices, not the Woop u, v: two triangles that share an
// edge get its edge function with opposite signs, so no ray slips between
// them. Everything is written with __fmul_rn / __fadd_rn in the plain
// version's order ((x0 y0 + x1 y1) + x2 y2) + w, so no FMA contraction moves
// a result: t, u, v and every decision equal the plain version's bit for
// bit (with contraction, u, v of thin triangles drifted by up to 3e-4).
//
// What bounds it on the H100: FP32 work. An all-rows sweep costs about 17
// operations per (ray, row) pair for t, and about 70 more for each row whose
// t is in range (the edge test, then u, v), O(T) per ray: 4.1e8 pairs for
// 2^17 photon rays over 3,160 rows. The rays are 32 bytes in and 16 out, so
// memory is never the limit. The design cuts the pairs rather than their cost:
//   * the rows come in BVH leaf order, so CHUNK = 32 consecutive rows lie
//     close together; each chunk has a padded AABB (accel/bvh.py
//     `chunk_boxes`, built with the BVH), 8 floats read as two float4;
//   * one ray per lane. Each lane slab-tests the next chunk's box against
//     its own live range (t_min, best_t); the warp votes (`__any_sync`)
//     and sweeps the chunk's rows only if some lane enters the box. Lanes
//     that did not enter test the rows too (same instructions, and only ever
//     closer to the all-rows sweep). A skipped row cannot hit, because its
//     box contains it, so the winner, ties included, is the all-rows winner;
//   * no block barrier: each warp culls, sweeps and ends on its own. Any-hit
//     lanes drop out at their first hit, a lane with an empty range
//     (t_min >= t_max) never votes, and a warp ends when no lane is live;
//   * a warp stages an entered chunk's 32 Woop rows and 32 vertex rows
//     (3 KB) into its own slice of shared memory with coalesced loads, then
//     every lane reads each row as a broadcast; the edge test only once t
//     passes the range test, u, v only once the edge test passes. Staging
//     measured faster than warp-uniform __ldg loads of the same rows (3,160
//     rows are 152 KB, in L1 / L2) at every main-path shape on the H100.
// The per-pair test is not a matrix product at these sizes, so no wgmma/TMA.
//
// Plain C interface for ctypes; a scalar t_min / t_max comes as a value
// with a null pointer, a per-ray one as a pointer. The launch goes on the
// caller's stream and the function returns cudaGetLastError().

#include <cuda_runtime.h>

#include "watertight.cuh"

namespace {

constexpr int BLOCK = 128;
constexpr int CHUNK = 32;  // rows per chunk box: accel/bvh.py CHUNK_ROWS
constexpr unsigned FULL = 0xffffffffu;
constexpr float T_MAX_CLAMP = 1e30f;

__device__ __forceinline__ float inv_dir(float x) {
  return 1.0f / (fabsf(x) < 1e-20f ? (x < 0.f ? -1e-20f : 1e-20f) : x);
}

__global__ void __launch_bounds__(BLOCK)
dense_kernel(const float4* __restrict__ woop, const float4* __restrict__ verts, int n_tri,
             const float4* __restrict__ boxes,
             const float* __restrict__ o, const float* __restrict__ d, float tmin_val,
             const float* __restrict__ tmin_in, float tmax_val,
             const float* __restrict__ tmax_in, int n_ray, int any_hit,
             float* __restrict__ t_out, int* __restrict__ prim_out,
             float* __restrict__ bary_out) {
  __shared__ float4 stage_s[(BLOCK / 32) * CHUNK * 6];  // a warp's entered chunk
  float4* const rows = stage_s + (threadIdx.x / 32) * CHUNK * 6;  // Woop rows
  float4* const vrows = rows + CHUNK * 3;                          // vertex rows
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool live = i < n_ray;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tmin = 0.f, best_t = 0.f;
  if (live) {
    ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
    tmin = tmin_in ? tmin_in[i] : tmin_val;
    best_t = fminf(tmax_in ? tmax_in[i] : tmax_val, T_MAX_CLAMP);
  }
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  const Shear sh = make_shear(dx, dy, dz);
  int best = -1;
  float best_u = 0.f, best_v = 0.f;
  bool active = live && tmin < best_t;

  const int n_chunk = (n_tri + CHUNK - 1) / CHUNK;
  // every lane of the warp runs every iteration: the votes need all 32
  for (int c = 0; c < n_chunk; ++c) {
    if (!__any_sync(FULL, active)) break;
    bool enter = false;
    if (active) {
      const float4 lo = __ldg(boxes + 2 * c), hi = __ldg(boxes + 2 * c + 1);
      const float ax = (lo.x - ox) * ix, bx = (hi.x - ox) * ix;
      const float ay = (lo.y - oy) * iy, by = (hi.y - oy) * iy;
      const float az = (lo.z - oz) * iz, bz = (hi.z - oz) * iz;
      const float near = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fminf(az, bz));
      const float far = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz));
      enter = fmaxf(near, tmin) <= fminf(far, best_t);
    }
    if (!__any_sync(FULL, enter)) continue;
    const int base = c * CHUNK;
    const int n = min(CHUNK, n_tri - base);
    for (int k = threadIdx.x & 31; k < 3 * n; k += 32) {
      rows[k] = __ldg(woop + 3 * base + k);
      vrows[k] = __ldg(verts + 3 * base + k);
    }
    __syncwarp();
    if (active) {
      for (int j = 0; j < n; ++j) {
        const float4 r2 = rows[3 * j + 2];
        const float oz_p = __fadd_rn(dot3(r2.x, r2.y, r2.z, ox, oy, oz), r2.w);
        const float dz_p = dot3(r2.x, r2.y, r2.z, dx, dy, dz);
        const float inv_dz = 1.0f / (fabsf(dz_p) < 1e-20f ? 1e-20f : dz_p);
        const float t = __fmul_rn(-oz_p, inv_dz);
        if (t > tmin && t < best_t &&
            crosses(sh, vrows[3 * j], vrows[3 * j + 1], vrows[3 * j + 2], ox, oy, oz)) {
          const float4 r0 = rows[3 * j];
          const float4 r1 = rows[3 * j + 1];
          best_t = t;
          best = base + j;
          best_u = __fadd_rn(__fadd_rn(dot3(r0.x, r0.y, r0.z, ox, oy, oz), r0.w),
                             __fmul_rn(t, dot3(r0.x, r0.y, r0.z, dx, dy, dz)));
          best_v = __fadd_rn(__fadd_rn(dot3(r1.x, r1.y, r1.z, ox, oy, oz), r1.w),
                             __fmul_rn(t, dot3(r1.x, r1.y, r1.z, dx, dy, dz)));
          if (any_hit) {
            active = false;
            break;
          }
        }
      }
    }
    __syncwarp();  // the next entered chunk overwrites `rows`
  }
  if (live) {
    t_out[i] = best_t;
    prim_out[i] = best;
    bary_out[2 * i] = best_u;
    bary_out[2 * i + 1] = best_v;
  }
}

}  // namespace

extern "C" int intersect_dense_launch(const float* woop, const float* verts, int n_tri,
                                      const float* boxes,
                                      const float* o, const float* d, float tmin_val,
                                      const float* tmin, float tmax_val, const float* tmax,
                                      int n_ray, int any_hit, float* t_out, int* prim_out,
                                      float* bary_out, void* stream) {
  if (n_ray > 0) {
    const int grid = (n_ray + BLOCK - 1) / BLOCK;
    dense_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(woop), reinterpret_cast<const float4*>(verts), n_tri,
        reinterpret_cast<const float4*>(boxes),
        o, d, tmin_val, tmin, tmax_val, tmax, n_ray, any_hit, t_out, prim_out, bary_out);
  }
  return static_cast<int>(cudaGetLastError());
}
