// BVH ray / Woop-triangle intersection for Hopper (sm_90a): a persistent
// while-while traversal.
//
// Replaces the Pallas TPU kernel cudatracerlib_tpu/ops/cluster_trace.py:411
// `intersect_clusters` (pallas_call :467): the closest (or any) hit of each
// ray over a scene above the dense band (more than DENSE_MAX_TRIS = 4096
// Woop rows). The TPU kernel streams a cluster decomposition of the scene
// through the MXU; this kernel walks the port's own BVH instead, with the
// contract of the plain version accel/traversal.py `intersect` (the JAX
// lockstep oracle): the same Hit, exact float32 t.
//
// Data and arithmetic, per ray:
//   * 16-float nodes read as four float4 through __ldg: child 0 box in
//     floats 0-5, child 1 box in 6-11, child codes bitcast in 12/13
//     (>= 0 inner node, -(first + 1) leaf of LEAF_SIZE Woop rows), which is
//     already Aila and Laine's layout (both child boxes in the parent);
//   * the oracle's slab test with its inv_d rule and its ordering rule
//     (swap = hit1 && (!hit0 || near1 < near0)): descend to the nearer hit
//     child, push the farther one when both are hit; a push on a full
//     48-entry stack overwrites the top entry, as the oracle's clamped
//     scatter does;
//   * a leaf tests its LEAF_SIZE rows against the ray's current t, strict
//     `t < t_hit`, lowest row first on a tie; any-hit rays end at their
//     first leaf with a hit; no ray takes more than max_steps node visits;
//   * t, u, v come from the Woop rows; whether the ray crosses the triangle
//     is the watertight edge test (watertight.cuh) on the row's vertex row,
//     read only for rows whose t is in range: two triangles that share an
//     edge get its edge function with opposite signs, so no ray slips
//     between them. Both are written with __fmul_rn / __fadd_rn in the
//     oracle's order ((x0 y0 + x1 y1) + x2 y2) + w, so no FMA contraction
//     moves a value: on the row both pick, t, u, v equal the plain
//     version's bit for bit, and so does every decision.
//
// What bounds it on the H100: the data it must move is small (48 bytes a
// ray, plus the node, Woop and vertex tables once), so the floor is the
// arithmetic, about 50 operations per inner-node visit, 17 per leaf row and
// about 70 more per leaf row whose t is in range. What
// limits it is latency and divergence: each step is a dependent load, and
// neighbouring rays take different paths. The design follows the reference
// library's own traversal (Aila and Laine's persistent while-while loop,
// Kernel/TraceHelper.cu:326-734):
//   * while-while: an inner loop descends inner nodes until every lane of
//     the warp holds a leaf. A lane that reaches a leaf postpones it and
//     goes on descending (speculative traversal) until the warp votes that
//     all lanes hold one; then a leaf loop tests the postponed leaves. Inner
//     steps and leaf steps no longer share one divergent loop body;
//   * persistent warps: the grid holds as many blocks as the SMs keep
//     resident, and each warp fetches batches of 32 rays from a global
//     counter (atomicAdd), so no warp waits on the slowest ray of a block
//     and no block is launched after the card fills;
//   * the stack is a per-thread array in local memory, cached in L1: a
//     per-warp slice of shared memory (entry k of thread x at k * BLOCK + x,
//     a bank per lane) measured slower at every main-path shape on the H100.
// Speculation changes the visit order only where the old order would have
// culled: t stays the minimum, and the row picked differs only between rows
// of equal t (a shared edge, a coincident triangle, a grazing hit).
//
// Plain C interface for ctypes; a scalar t_min / t_max comes as a value
// with a null pointer, a per-ray one as a pointer; `next_ray` is one int
// the caller zeroes before the launch. The launch goes on the caller's
// stream and the function returns cudaGetLastError().

#include <cuda_runtime.h>

#include "watertight.cuh"

namespace {

constexpr int BLOCK = 128;
constexpr int STACK_DEPTH = 48;
constexpr int LEAF_SIZE = 4;
constexpr int SENTINEL = 0x7fffffff;  // no node: a pop from an empty stack
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float inv_dir(float x) {
  return 1.0f / (fabsf(x) < 1e-20f ? (x < 0.f ? -1e-20f : 1e-20f) : x);
}

// slab test of one box against the ray; returns the hit, sets the entry t
__device__ __forceinline__ bool slab(float lx, float ly, float lz, float hx, float hy,
                                     float hz, float ox, float oy, float oz, float ix,
                                     float iy, float iz, float tmin, float tmax,
                                     float* near_out) {
  const float ax = (lx - ox) * ix, bx = (hx - ox) * ix;
  const float ay = (ly - oy) * iy, by = (hy - oy) * iy;
  const float az = (lz - oz) * iz, bz = (hz - oz) * iz;
  const float near = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fminf(az, bz));
  const float far = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz));
  *near_out = near;
  return fmaxf(near, tmin) <= fminf(far, tmax);
}

__device__ __forceinline__ bool is_inner(int node) {
  return static_cast<unsigned>(node) < static_cast<unsigned>(SENTINEL);
}

__global__ void __launch_bounds__(BLOCK)
bvh_kernel(const float4* __restrict__ nodes, const float4* __restrict__ woop,
           const float4* __restrict__ verts, int n_rows,
           int root, const float* __restrict__ o, const float* __restrict__ d,
           float tmin_val, const float* __restrict__ tmin_in, float tmax_val,
           const float* __restrict__ tmax_in, int n_ray, int any_hit, int max_steps,
           int* __restrict__ next_ray, float* __restrict__ t_out, int* __restrict__ prim_out,
           float* __restrict__ bary_out) {
  int stack[STACK_DEPTH];
  const int lane = threadIdx.x & 31;

  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(next_ray, 32);
    base = __shfl_sync(FULL, base, 0);
    if (base >= n_ray) return;
    const int i = base + lane;
    if (i < n_ray) {
      const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
      const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
      const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
      const Shear sh = make_shear(dx, dy, dz);
      const float tmin = tmin_in ? tmin_in[i] : tmin_val;
      float t_hit = tmax_in ? tmax_in[i] : tmax_val;
      int prim = -1;
      float bu = 0.f, bv = 0.f;
      int sp = 0, steps = 0;
      int node = root;  // the node to visit next: inner, leaf (< 0) or SENTINEL
      int leaf = 0;     // a postponed leaf (< 0), or none (>= 0)
      if (root < 0) {   // a scene of one leaf
        leaf = root;
        node = SENTINEL;
      }
      do {
        // inner loop: descend until every lane of the warp holds a leaf
        while (is_inner(node)) {
          if (++steps > max_steps) {
            node = SENTINEL;
            leaf = 0;
            break;
          }
          const float4* nd = nodes + 4 * static_cast<long long>(node);
          const float4 a = __ldg(nd), b = __ldg(nd + 1), c = __ldg(nd + 2), e = __ldg(nd + 3);
          float near0, near1;
          const bool h0 = slab(a.x, a.y, a.z, a.w, b.x, b.y, ox, oy, oz, ix, iy, iz, tmin,
                               t_hit, &near0);
          const bool h1 = slab(b.z, b.w, c.x, c.y, c.z, c.w, ox, oy, oz, ix, iy, iz, tmin,
                               t_hit, &near1);
          const int c0 = __float_as_int(e.x), c1 = __float_as_int(e.y);
          const bool swap = h1 && (!h0 || near1 < near0);
          if (h0 && h1) {
            stack[(sp < STACK_DEPTH - 1 ? sp : STACK_DEPTH - 1)] = swap ? c0 : c1;
            sp = sp + 1 < STACK_DEPTH ? sp + 1 : STACK_DEPTH;
          }
          if (h0 || h1) {
            node = swap ? c1 : c0;
          } else {
            node = sp > 0 ? stack[--sp] : SENTINEL;
          }
          if (node < 0 && leaf >= 0) {  // postpone the leaf, go on descending
            leaf = node;
            node = sp > 0 ? stack[--sp] : SENTINEL;
          }
          if (!__any_sync(__activemask(), leaf >= 0)) break;
        }
        // leaf loop: the postponed leaf, then any leaf the descent stopped at
        while (leaf < 0) {
          if (++steps > max_steps) {
            node = SENTINEL;
            leaf = 0;
            break;
          }
          const int first = -(leaf + 1);
          float best_t = __int_as_float(0x7f800000);  // +inf
          int best = -1;
          float best_u = 0.f, best_v = 0.f;
          for (int k = 0; k < LEAF_SIZE; ++k) {
            const int row = min(max(first + k, 0), n_rows - 1);
            const float4* w = woop + 3 * static_cast<long long>(row);
            const float4 r2 = __ldg(w + 2);
            const float oz_w = __fadd_rn(dot3(r2.x, r2.y, r2.z, ox, oy, oz), r2.w);
            const float dz_w = dot3(r2.x, r2.y, r2.z, dx, dy, dz);
            const float inv_dz = 1.0f / (fabsf(dz_w) < 1e-20f ? 1e-20f : dz_w);
            const float t = __fmul_rn(-oz_w, inv_dz);
            if (!(t > tmin && t < t_hit && isfinite(t) && t < best_t)) continue;
            const float4* p = verts + 3 * static_cast<long long>(row);
            if (!crosses(sh, __ldg(p), __ldg(p + 1), __ldg(p + 2), ox, oy, oz)) continue;
            const float4 r0 = __ldg(w), r1 = __ldg(w + 1);
            best_t = t;
            best = row;
            best_u = __fadd_rn(__fadd_rn(dot3(r0.x, r0.y, r0.z, ox, oy, oz), r0.w),
                               __fmul_rn(t, dot3(r0.x, r0.y, r0.z, dx, dy, dz)));
            best_v = __fadd_rn(__fadd_rn(dot3(r1.x, r1.y, r1.z, ox, oy, oz), r1.w),
                               __fmul_rn(t, dot3(r1.x, r1.y, r1.z, dx, dy, dz)));
          }
          if (best >= 0) {
            t_hit = best_t;
            prim = best;
            bu = best_u;
            bv = best_v;
            if (any_hit) {
              node = SENTINEL;
              leaf = 0;
              break;
            }
          }
          leaf = node;
          if (node < 0) node = sp > 0 ? stack[--sp] : SENTINEL;
        }
      } while (node != SENTINEL);
      t_out[i] = t_hit;
      prim_out[i] = prim;
      bary_out[2 * i] = bu;
      bary_out[2 * i + 1] = bv;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int intersect_bvh_launch(const float* nodes, const float* woop, const float* verts,
                                    int n_rows,
                                    int root, const float* o, const float* d, float tmin_val,
                                    const float* tmin, float tmax_val, const float* tmax,
                                    int n_ray, int any_hit, int max_steps, int* next_ray,
                                    float* t_out, int* prim_out, float* bary_out,
                                    void* stream) {
  if (n_ray > 0) {
    // resident blocks of the current device, computed once per device
    static int grid_of[64] = {0};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (grid_of[dev] == 0) {
      int sms = 0, per_sm = 0;
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bvh_kernel, BLOCK, 0);
      grid_of[dev] = sms * (per_sm > 0 ? per_sm : 1);
    }
    const int needed = (n_ray + BLOCK - 1) / BLOCK;
    const int grid = needed < grid_of[dev] ? needed : grid_of[dev];
    bvh_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(woop),
        reinterpret_cast<const float4*>(verts), n_rows,
        root, o, d, tmin_val, tmin, tmax_val, tmax, n_ray, any_hit, max_steps, next_ray, t_out,
        prim_out, bary_out);
  }
  return static_cast<int>(cudaGetLastError());
}
