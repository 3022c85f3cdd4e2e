// Photon-major density estimate for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cudatracerlib_tpu/ops/photon_gather.py:164
// `photon_density_tpu` (pallas_call :184). For every gather query q it
// returns [sum w * flux_rgb, sum w] over all photons p, with
//   w = max(1 - |p - q|^2 / r^2, 0) * [n_q . n_p > 0.7] * [n_q . wi_p >= 0],
// the photons coming cell-sorted in tiles of 512 (ops/photon_gather.py
// `build_photon_tiles`: (n_tiles, 16, 512) attribute rows, FAR padding, and a
// per-tile AABB), the queries cell-sorted by the caller.
//
// Design. One CTA per 256 queries, one query per thread:
//   1. the block reduces its queries' AABB (invalid queries at +-FAR);
//   2. it culls the tile AABBs against that box, 256 tiles at a time, with
//      the squared-gap test (<= r^2);
//   3. it compacts the survivors in ascending tile order with a warp ballot
//      and a prefix over the 8 warps (no atomic append, so every query sums
//      its tiles in the same order on every run);
//   4. for each surviving tile it stages the 12 used rows (position, flux,
//      normal, wi: 24 KB) in shared memory, transposed to 3 float4 per
//      photon, so the sweep reads a photon with 3 broadcast 16-byte loads;
//   5. each thread folds its query over the 512 photons into 4 fp32 sums.
// Every tile of a chunk of 256 is swept before the next chunk is culled, so
// any n_tiles works without a cap on the surviving list.
//
// The TPU kernel's devices are gone: no RING-deep DMA (the tile loads go
// through L1 / L2; cp.async double buffering is left for later), no K=1 MXU
// broadcasts of the query columns, and no bf16 hi/lo matmul split (the sums
// are plain fp32). d^2 is |p - q|^2 from the differences, not the TPU's
// |p|^2 + |q|^2 - 2 p.q, which cancels at gather radii of a few cm. The
// weight and the cull are written with __fmul_rn / __fadd_rn / __fsub_rn in
// the plain version's order (ops/photon_gather.py), so every pair gets the
// plain version's weight bit for bit and only the order of the sums differs.
// Invalid queries get 0.
//
// What bounds it on the H100: operations. Per (query, photon) pair of a
// surviving tile the sweep does 32 (3 differences, d^2, the Epanechnikov
// weight, two 3-term dots and their tests, 4 sums); the bytes are the tiles
// (32 KB each) once per block that keeps them, mostly from L2. With 256
// queries a block, bench config 5 (65,536 queries) runs 256 blocks, about two
// per SM: few warps hide the shared-memory latency, a known limit of this
// first form. Built for sm_90a (nvcc 12.8, -Xptxas -v): 48 registers, an
// 8-byte stack frame with 8 bytes of spill stores and loads, 25,824 bytes of
// static shared memory.
//
// Plain C interface for ctypes; the launch goes on the caller's stream and
// the function returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 256;      // queries per block
constexpr int PT = 512;      // photons per tile
constexpr int ROWS = 16;     // attribute rows per tile
constexpr int USED = 12;     // rows staged: x y z | r g b | nx ny nz | wx wy wz
constexpr int WARPS = BQ / 32;
constexpr float FAR = 1.0e15f;
constexpr float NORMAL_MIN_DOT = 0.7f;

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// a.b as (a0 b0 + a1 b1) + a2 b2, unfused, the plain version's order
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

__global__ void __launch_bounds__(BQ)
photon_kernel(const float* __restrict__ tiles, int n_tiles, const float* __restrict__ aabbs,
              const float* __restrict__ q_pos, const float* __restrict__ q_n,
              const unsigned char* __restrict__ q_valid, int n_q, float r2, float inv_r2,
              float* __restrict__ out) {
  __shared__ float4 s_ph[3 * PT];     // photon p: (x y z r) (g b nx ny) (nz wx wy wz)
  __shared__ float s_red[6][WARPS];
  __shared__ int s_cnt[WARPS];
  __shared__ int s_ids[BQ];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long qi = static_cast<long long>(blockIdx.x) * BQ + tid;
  const bool valid = qi < n_q && q_valid[qi] != 0;
  float q[3] = {0.f, 0.f, 0.f};
  float qn[3] = {0.f, 0.f, 0.f};
  if (qi < n_q) {
    for (int c = 0; c < 3; ++c) {
      q[c] = q_pos[3 * qi + c];
      qn[c] = q_n[3 * qi + c];
    }
  }

  // ---- 1. the block's query AABB ----
  for (int c = 0; c < 3; ++c) {
    const float lo = warp_min(valid ? q[c] : FAR);
    const float hi = warp_max(valid ? q[c] : -FAR);
    if (lane == 0) {
      s_red[c][warp] = lo;
      s_red[3 + c][warp] = hi;
    }
  }
  __syncthreads();
  float blo[3], bhi[3];
  for (int c = 0; c < 3; ++c) {
    blo[c] = FAR;
    bhi[c] = -FAR;
    for (int w = 0; w < WARPS; ++w) {
      blo[c] = fminf(blo[c], s_red[c][w]);
      bhi[c] = fmaxf(bhi[c], s_red[3 + c][w]);
    }
  }

  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_w = 0.f;
  float* s_flat = reinterpret_cast<float*>(s_ph);

  for (int base = 0; base < n_tiles; base += BQ) {
    // ---- 2. cull this chunk of tiles against the block box ----
    const int j = base + tid;
    bool keep = false;
    if (j < n_tiles) {
      const float* a = aabbs + 8LL * j;
      float g[3];
      for (int c = 0; c < 3; ++c) g[c] = fmaxf(fmaxf(a[c] - bhi[c], blo[c] - a[3 + c]), 0.f);
      keep = dot3(g[0], g[1], g[2], g[0], g[1], g[2]) <= r2;
    }
    // ---- 3. compact the survivors in ascending order ----
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_cnt[warp] = __popc(m);
    __syncthreads();
    int off = 0, total = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int c = s_cnt[w];
      off += w < warp ? c : 0;
      total += c;
    }
    if (keep) s_ids[off + __popc(m & ((1u << lane) - 1u))] = j;
    __syncthreads();

    for (int s = 0; s < total; ++s) {
      // ---- 4. stage the tile's used rows, one photon = 3 float4 ----
      const float* src = tiles + static_cast<long long>(s_ids[s]) * ROWS * PT;
      for (int k = tid; k < USED * PT; k += BQ) {
        const int a = k / PT;               // staged slot 0..11
        const int p = k - a * PT;
        const int row = a < 3 ? a : a + 1;  // row 3 (|p|^2) is not needed
        s_flat[p * USED + a] = __ldg(src + row * PT + p);
      }
      __syncthreads();
      // ---- 5. fold this query over the tile's photons ----
      if (valid) {
#pragma unroll 4
        for (int p = 0; p < PT; ++p) {
          const float4 A = s_ph[3 * p];
          const float4 B = s_ph[3 * p + 1];
          const float4 C = s_ph[3 * p + 2];
          const float dx = __fsub_rn(A.x, q[0]);
          const float dy = __fsub_rn(A.y, q[1]);
          const float dz = __fsub_rn(A.z, q[2]);
          const float d2 = dot3(dx, dy, dz, dx, dy, dz);
          float w = fmaxf(__fsub_rn(1.f, __fmul_rn(d2, inv_r2)), 0.f);
          const float ndot = dot3(qn[0], qn[1], qn[2], B.z, B.w, C.x);
          const float wdot = dot3(qn[0], qn[1], qn[2], C.y, C.z, C.w);
          w = (ndot > NORMAL_MIN_DOT && wdot >= 0.f) ? w : 0.f;
          acc_r = fmaf(w, A.w, acc_r);
          acc_g = fmaf(w, B.x, acc_g);
          acc_b = fmaf(w, B.y, acc_b);
          acc_w += w;
        }
      }
      __syncthreads();
    }
  }

  if (qi < n_q) {
    float4 r = valid ? make_float4(acc_r, acc_g, acc_b, acc_w) : make_float4(0.f, 0.f, 0.f, 0.f);
    reinterpret_cast<float4*>(out)[qi] = r;
  }
}

}  // namespace

extern "C" int photon_gather_launch(const float* tiles, int n_tiles, const float* aabbs,
                                    const float* q_pos, const float* q_n,
                                    const unsigned char* q_valid, int n_q, float r2,
                                    float inv_r2, float* out, void* stream) {
  if (n_q > 0) {
    const unsigned grid = static_cast<unsigned>((n_q + BQ - 1) / BQ);
    photon_kernel<<<grid, BQ, 0, static_cast<cudaStream_t>(stream)>>>(
        tiles, n_tiles, aabbs, q_pos, q_n, q_valid, n_q, r2, inv_r2, out);
  }
  return static_cast<int>(cudaGetLastError());
}
