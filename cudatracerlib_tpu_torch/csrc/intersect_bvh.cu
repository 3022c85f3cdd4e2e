// BVH stack-walk ray / Woop-triangle intersection for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cudatracerlib_tpu/ops/cluster_trace.py:411
// `intersect_clusters` (pallas_call :467): the closest (or any) hit of each
// ray over a scene above the dense band (more than DENSE_MAX_TRIS = 4096
// Woop rows). The TPU kernel streams a cluster decomposition of the scene
// through the MXU; this kernel walks the port's own BVH instead, with the
// contract of the plain version accel/traversal.py `intersect` (the JAX
// lockstep oracle): the same Hit, exact float32 t.
//
// Per ray, in one thread:
//   * 16-float fat nodes read as four float4 through __ldg: child 0 box in
//     floats 0-5, child 1 box in 6-11, child codes bitcast in 12/13
//     (>= 0 inner node, -(first + 1) leaf of LEAF_SIZE Woop rows);
//   * the oracle's slab test with its inv_d rule, descent to the child with
//     the smaller entry distance (the ordering rule swap = hit1 && (!hit0 ||
//     near1 < near0)), the far child pushed on a 48-entry stack when both
//     are hit; a push on a full stack overwrites the top entry, as the
//     oracle's clamped scatter does;
//   * a leaf tests its LEAF_SIZE rows (each three float4) against the t of
//     the ray at leaf entry, strict `t < t_hit`, lowest row first on a tie;
//     any-hit rays end at their first leaf with a hit.
// Visiting nodes in the oracle's order matters beyond t: leaf padding
// duplicates Woop rows, which tie, and the first one visited wins.
//
// The Woop test is written with __fmul_rn / __fadd_rn in the oracle's
// order ((x0 y0 + x1 y1) + x2 y2) + w, so no FMA contraction moves t: the
// kernel's t, u, v equal the plain version's bit for bit on the same rays.
//
// What bounds it on the H100: the data it must move is small (the rays, 48
// bytes each in and out, plus the node and Woop tables once), so the floor
// is the arithmetic, about 50 flops per inner-node visit and 180 per leaf.
// What actually limits it is latency: each step is a dependent load whose
// address comes from the previous one, and neighbouring rays take different
// paths (divergence). The design keeps it simple: one ray per thread, its
// state in registers, its stack in local memory (cached in L1), the node
// and Woop tables through the read-only cache. No ray sorting, no
// persistent threads, no wide BVH yet.
//
// Plain C interface for ctypes; the launch goes on the caller's stream and
// the function returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 128;
constexpr int STACK_DEPTH = 48;
constexpr int LEAF_SIZE = 4;
constexpr int DONE = -(1 << 30);

__device__ __forceinline__ float inv_dir(float x) {
  return 1.0f / (fabsf(x) < 1e-20f ? (x < 0.f ? -1e-20f : 1e-20f) : x);
}

// ((a0 b0 + a1 b1) + a2 b2), each operation rounded on its own
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1,
                                      float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
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

__global__ void __launch_bounds__(BLOCK)
bvh_kernel(const float4* __restrict__ nodes, const float4* __restrict__ woop, int n_rows,
           int root, const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ tmin_in, const float* __restrict__ tmax_in, int n_ray,
           int any_hit, int max_steps, float* __restrict__ t_out, int* __restrict__ prim_out,
           float* __restrict__ bary_out) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n_ray) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  const float tmin = tmin_in[i];
  float t_hit = tmax_in[i];
  int prim = -1;
  float bu = 0.f, bv = 0.f;

  int stack[STACK_DEPTH];
  int sp = 0;
  int node = root;
  for (int step = 0; step < max_steps && node != DONE; ++step) {
    if (node >= 0) {
      const float4* nd = nodes + 4 * static_cast<long long>(node);
      const float4 a = __ldg(nd), b = __ldg(nd + 1), c = __ldg(nd + 2), e = __ldg(nd + 3);
      float near0, near1;
      const bool h0 = slab(a.x, a.y, a.z, a.w, b.x, b.y, ox, oy, oz, ix, iy, iz, tmin, t_hit,
                           &near0);
      const bool h1 = slab(b.z, b.w, c.x, c.y, c.z, c.w, ox, oy, oz, ix, iy, iz, tmin, t_hit,
                           &near1);
      const int c0 = __float_as_int(e.x), c1 = __float_as_int(e.y);
      const bool swap = h1 && (!h0 || near1 < near0);
      if (h0 && h1) {
        stack[sp < STACK_DEPTH - 1 ? sp : STACK_DEPTH - 1] = swap ? c0 : c1;
        sp = sp + 1 < STACK_DEPTH ? sp + 1 : STACK_DEPTH;
      }
      if (h0 || h1) {
        node = swap ? c1 : c0;
        continue;
      }
    } else {
      const int first = -(node + 1);
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
        if (!(t > tmin && t < t_hit && isfinite(t))) continue;
        const float4 r0 = __ldg(w), r1 = __ldg(w + 1);
        const float u = __fadd_rn(__fadd_rn(dot3(r0.x, r0.y, r0.z, ox, oy, oz), r0.w),
                                  __fmul_rn(t, dot3(r0.x, r0.y, r0.z, dx, dy, dz)));
        const float v = __fadd_rn(__fadd_rn(dot3(r1.x, r1.y, r1.z, ox, oy, oz), r1.w),
                                  __fmul_rn(t, dot3(r1.x, r1.y, r1.z, dx, dy, dz)));
        if (u >= 0.f && v >= 0.f && __fadd_rn(u, v) <= 1.f && t < best_t) {
          best_t = t;
          best = row;
          best_u = u;
          best_v = v;
        }
      }
      if (best >= 0) {
        t_hit = best_t;
        prim = best;
        bu = best_u;
        bv = best_v;
        if (any_hit) break;
      }
    }
    node = sp > 0 ? stack[--sp] : DONE;
  }
  t_out[i] = t_hit;
  prim_out[i] = prim;
  bary_out[2 * i] = bu;
  bary_out[2 * i + 1] = bv;
}

}  // namespace

extern "C" int intersect_bvh_launch(const float* nodes, const float* woop, int n_rows,
                                    int root, const float* o, const float* d,
                                    const float* tmin, const float* tmax, int n_ray,
                                    int any_hit, int max_steps, float* t_out, int* prim_out,
                                    float* bary_out, void* stream) {
  if (n_ray > 0) {
    const int grid = (n_ray + BLOCK - 1) / BLOCK;
    bvh_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(woop), n_rows,
        root, o, d, tmin, tmax, n_ray, any_hit, max_steps, t_out, prim_out, bary_out);
  }
  return static_cast<int>(cudaGetLastError());
}
