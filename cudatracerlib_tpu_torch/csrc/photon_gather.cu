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
// Design. A grid of (query blocks of BQC, SPLITS) CTAs; one query a thread:
//   1. the block reduces its valid queries' AABB, and each warp its own;
//   2. the block culls the tile AABBs against its box with the squared-gap
//      test (<= r^2), CULL tiles a round, and compacts the survivors in
//      ascending order with a warp ballot and a prefix over the warps (no
//      atomic append, so the list is the same on every run);
//   3. split s of the block takes entries s, s + SPLITS, ... of that list;
//      one thread stages each tile's 12 used rows (x y z | r g b | n | wi)
//      in their own row layout with two 1-D TMA copies (cp.async.bulk,
//      6 KB + 18 KB) into a ring of NSTAGE stages in dynamic shared memory,
//      completion on an mbarrier, so the next tile is in flight while this
//      one is swept; after each tile the block syncs and the stage is
//      refilled;
//   4. each warp tests every photon of each 32-photon chunk against its own
//      queries' box (the same squared-gap form) and sweeps only the chunks a
//      photon of which lies within r of the box: warp-uniform, no
//      divergence; a warp without a valid query sweeps nothing. The sweep
//      reads one float4 of 4 photons per row, the same address on every
//      lane (a broadcast, no bank conflict);
//   5. each split writes its partial sums to a scratch the wrapper makes;
//      a second kernel adds the SPLITS partials per query in ascending
//      split order.
//
// Exactness. A photon whose computed gap^2 to the warp box exceeds r^2 has,
// for every query of the box, a computed d^2 >= that gap^2 > r^2 (rounding,
// squares and the dot are monotone), so d^2 * (1/r^2) rounds to >= 1 and
// w is exactly +0, which leaves each sum bit for bit as it was. The weight
// and the culls are written with __fmul_rn / __fadd_rn / __fsub_rn in the
// plain version's order (ops/photon_gather.py), so every pair gets the plain
// version's weight bit for bit. Each split sums its tiles and photons in
// ascending order, so its partial is bit for bit a sweep of every photon of
// those tiles; the partials are added in a fixed order, so the result is the
// same on every run and differs from one sweep only in the order of the
// sums. Invalid queries get 0. The TPU kernel's K=1 MXU broadcasts and bf16 hi/lo
// matmul split are gone (plain fp32 sums), and d^2 is |p - q|^2 from the
// differences, not |p|^2 + |q|^2 - 2 p.q, which cancels at radii of a few cm.
//
// What bounds it on the H100, on bench config 5's global map (65,536
// queries, 1,536 tiles, 178 of them holding photons): bytes, 7.1 MB (the
// 12 used rows of each non-empty tile, the tile boxes, the queries and the
// output, each once) at 3.35 TB/s, 0.0021 ms. The operations the inputs
// need come to less: 32 per (valid query, photon) pair within r (3
// differences, d^2, the Epanechnikov weight, two 3-term dots and their
// tests, 4 sums; an FMA counts two), 1.17 M pairs, 0.0006 ms at 67 TFLOP/s.
// The exact weight is about 28 unfused FP32 instructions a pair. The chunk
// cull sweeps 26.5 M pairs (23x those within r) where a block x tile cull
// sweeps 274.8 M; the ring hides the tile loads; the splits spread the hot
// query blocks (up to 39 surviving tiles against a median of 7) over 8 CTAs
// each. Measured there (NVIDIA H100 80GB HBM3, 700 W): 0.159 ms alone, 1.3%
// of the bound; what is left is per-CTA work the bound does not charge
// (each of the 2,048 CTAs culls all tiles and syncs after each one) and the
// swept pairs beyond r (the lanes of a kept chunk whose own query is far).
// Built for sm_90a (nvcc -Xptxas -v):
// 54 registers, no spills, 4,352 bytes of static and 49,152 of dynamic
// shared memory; 4 CTAs (32 warps) resident per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
//
// Plain C interface for ctypes; the launches go on the caller's stream and
// the function returns the first CUDA error.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// chosen on the card (PERF.md lists the variants timed against it: 1, 2,
// 4 and 16 splits, 3 stages, half- and quarter-tile stages, 128-query CTAs,
// warps handing stages back on their own); this was fastest or tied on
// bench config 5's global and caustic maps and the hotspot
constexpr int BQC = 256;     // queries per CTA
constexpr int SPLITS = 8;    // CTAs per query block
constexpr int NSTAGE = 2;    // ring stages
constexpr int PT = 512;      // photons per tile
constexpr int ROWS = 16;     // attribute rows per tile
constexpr int USED = 12;     // rows staged: x y z | r g b | nx ny nz | wx wy wz
constexpr int CHUNK = 32;    // photons per culled chunk (a warp's width)
constexpr int CULL = 1024;   // tiles culled per round (the list lives in shared memory)
constexpr int WARPS = BQC / 32;
constexpr int STAGE_BYTES = USED * PT * 4;
constexpr float FAR = 1.0e15f;
constexpr float NORMAL_MIN_DOT = 0.7f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// a.b as (a0 b0 + a1 b1) + a2 b2, unfused, the plain version's order
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

// squared gap between a box (or a point, lo = hi) and a box, as the plain cull sums it
__device__ __forceinline__ float gap2(const float lo[3], const float hi[3], const float blo[3],
                                      const float bhi[3]) {
  float g[3];
  for (int c = 0; c < 3; ++c) g[c] = fmaxf(fmaxf(lo[c] - bhi[c], blo[c] - hi[c]), 0.f);
  return dot3(g[0], g[1], g[2], g[0], g[1], g[2]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one thread: the used rows of `tile` into a stage, rows 0-2 and 4-12 as two
// contiguous TMA copies (row 3, |p|^2, is not needed), completing on `bar`
__device__ __forceinline__ void stage_async(uint32_t dst, const float* tile, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(STAGE_BYTES) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n"
               :: "r"(dst), "l"(tile), "r"(3 * PT * 4), "r"(bar) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n"
               :: "r"(dst + 3 * PT * 4), "l"(tile + 4 * PT), "r"(9 * PT * 4), "r"(bar)
               : "memory");
}

struct Acc {
  float r, g, b, w;
};

// one (query, photon) pair, in the plain version's arithmetic and order
__device__ __forceinline__ void fold(Acc& a, const float q[3], const float qn[3], float px,
                                     float py, float pz, float fr, float fg, float fb, float nx,
                                     float ny, float nz, float wx, float wy, float wz,
                                     float inv_r2) {
  const float dx = __fsub_rn(px, q[0]);
  const float dy = __fsub_rn(py, q[1]);
  const float dz = __fsub_rn(pz, q[2]);
  const float d2 = dot3(dx, dy, dz, dx, dy, dz);
  float w = fmaxf(__fsub_rn(1.f, __fmul_rn(d2, inv_r2)), 0.f);
  const float ndot = dot3(qn[0], qn[1], qn[2], nx, ny, nz);
  const float wdot = dot3(qn[0], qn[1], qn[2], wx, wy, wz);
  w = (ndot > NORMAL_MIN_DOT && wdot >= 0.f) ? w : 0.f;
  a.r = fmaf(w, fr, a.r);
  a.g = fmaf(w, fg, a.g);
  a.b = fmaf(w, fb, a.b);
  a.w += w;
}

// the 32 photons of chunk c of a staged tile (12 rows of PT floats), 4 a step
__device__ __forceinline__ void sweep_chunk(Acc& a, const float4* s, int c, const float q[3],
                                            const float qn[3], float inv_r2) {
  constexpr int R = PT / 4;  // float4 per row
#pragma unroll 2
  for (int f = c * (CHUNK / 4); f < (c + 1) * (CHUNK / 4); ++f) {
    const float4 X = s[f], Y = s[R + f], Z = s[2 * R + f];
    const float4 FR = s[3 * R + f], FG = s[4 * R + f], FB = s[5 * R + f];
    const float4 NX = s[6 * R + f], NY = s[7 * R + f], NZ = s[8 * R + f];
    const float4 WX = s[9 * R + f], WY = s[10 * R + f], WZ = s[11 * R + f];
    fold(a, q, qn, X.x, Y.x, Z.x, FR.x, FG.x, FB.x, NX.x, NY.x, NZ.x, WX.x, WY.x, WZ.x, inv_r2);
    fold(a, q, qn, X.y, Y.y, Z.y, FR.y, FG.y, FB.y, NX.y, NY.y, NZ.y, WX.y, WY.y, WZ.y, inv_r2);
    fold(a, q, qn, X.z, Y.z, Z.z, FR.z, FG.z, FB.z, NX.z, NY.z, NZ.z, WX.z, WY.z, WZ.z, inv_r2);
    fold(a, q, qn, X.w, Y.w, Z.w, FR.w, FG.w, FB.w, NX.w, NY.w, NZ.w, WX.w, WY.w, WZ.w, inv_r2);
  }
}

__global__ void __launch_bounds__(BQC)
photon_kernel(const float* __restrict__ tiles, int n_tiles, const float* __restrict__ aabbs,
              const float* __restrict__ q_pos, const float* __restrict__ q_n,
              const unsigned char* __restrict__ q_valid, int n_q, float r2, float inv_r2,
              float* __restrict__ part) {
  extern __shared__ __align__(128) unsigned char s_dyn[];   // NSTAGE stages of STAGE_BYTES
  __shared__ __align__(8) unsigned long long s_full[NSTAGE];
  __shared__ float s_red[6][WARPS];
  __shared__ int s_cnt[WARPS];
  __shared__ int s_ids[CULL];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int split = blockIdx.y;
  const long long qi = static_cast<long long>(blockIdx.x) * BQC + tid;
  const bool valid = qi < n_q && q_valid[qi] != 0;
  float q[3] = {0.f, 0.f, 0.f};
  float qn[3] = {0.f, 0.f, 0.f};
  if (qi < n_q) {
    for (int c = 0; c < 3; ++c) {
      q[c] = q_pos[3 * qi + c];
      qn[c] = q_n[3 * qi + c];
    }
  }

  // ---- 1. the warp's and the block's query AABBs ----
  float wlo[3], whi[3];
  for (int c = 0; c < 3; ++c) {
    wlo[c] = warp_min(valid ? q[c] : FAR);
    whi[c] = warp_max(valid ? q[c] : -FAR);
    if (lane == 0) {
      s_red[c][warp] = wlo[c];
      s_red[3 + c][warp] = whi[c];
    }
  }
  const bool warp_live = __any_sync(FULL, valid);
  if (tid == 0) {
    for (int s = 0; s < NSTAGE; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(&s_full[s]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

  Acc acc = {0.f, 0.f, 0.f, 0.f};
  int seen = 0;  // survivors of earlier rounds
  int it = 0;    // tiles this CTA has taken from the ring
  for (int base = 0; base < n_tiles; base += CULL) {
    // ---- 2. cull this round's tiles against the block box, compact in order ----
    int total = 0;
    for (int sub = 0; sub < CULL && base + sub < n_tiles; sub += BQC) {
      const int j = base + sub + tid;
      bool keep = false;
      if (j < n_tiles) {
        const float* a = aabbs + 8LL * j;
        keep = gap2(a, a + 3, blo, bhi) <= r2;
      }
      const unsigned m = __ballot_sync(FULL, keep);
      if (lane == 0) s_cnt[warp] = __popc(m);
      __syncthreads();
      int off = 0, n = 0;
      for (int w = 0; w < WARPS; ++w) {
        const int c = s_cnt[w];
        off += w < warp ? c : 0;
        n += c;
      }
      if (keep) s_ids[total + off + __popc(m & ((1u << lane) - 1u))] = j;
      total += n;
      __syncthreads();
    }

    // ---- 3. this split's share of the list, through the ring ----
    const int k0 = ((split - seen) % SPLITS + SPLITS) % SPLITS;
    const int n_mine = total > k0 ? (total - k0 + SPLITS - 1) / SPLITS : 0;
    auto tile_of = [&](int i) {
      return tiles + static_cast<long long>(s_ids[k0 + i * SPLITS]) * ROWS * PT;
    };
    if (tid == 0) {
      for (int i = 0; i < NSTAGE && i < n_mine; ++i) {
        const int st = (it + i) % NSTAGE;
        stage_async(smem_addr(s_dyn + st * STAGE_BYTES), tile_of(i), smem_addr(&s_full[st]));
      }
    }
    for (int i = 0; i < n_mine; ++i, ++it) {
      const int st = it % NSTAGE;
      const float4* s = reinterpret_cast<const float4*>(s_dyn + st * STAGE_BYTES);
      mbar_wait(smem_addr(&s_full[st]), (it / NSTAGE) & 1);
      // ---- 4. the warp's chunk cull, then the sweep of the kept chunks ----
      if (warp_live) {
        const float* xs = reinterpret_cast<const float*>(s);
        unsigned mask = 0;
#pragma unroll
        for (int c = 0; c < PT / CHUNK; ++c) {
          const int p = c * CHUNK + lane;
          const float pp[3] = {xs[p], xs[PT + p], xs[2 * PT + p]};
          if (__ballot_sync(FULL, gap2(pp, pp, wlo, whi) <= r2)) mask |= 1u << c;
        }
        while (mask) {
          const int c = __ffs(static_cast<int>(mask)) - 1;
          mask &= mask - 1;
          sweep_chunk(acc, s, c, q, qn, inv_r2);
        }
      }
      __syncthreads();  // every warp is done with this stage
      if (tid == 0 && i + NSTAGE < n_mine)
        stage_async(smem_addr(s_dyn + st * STAGE_BYTES), tile_of(i + NSTAGE),
                    smem_addr(&s_full[st]));
    }
    seen += total;
  }

  // ---- 5. this split's partial sums ----
  if (qi < n_q) {
    const float4 r = valid ? make_float4(acc.r, acc.g, acc.b, acc.w)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    reinterpret_cast<float4*>(part)[static_cast<long long>(split) * n_q + qi] = r;
  }
}

// out[q] = sum over splits of part[s][q], in ascending s
__global__ void __launch_bounds__(256)
photon_reduce_kernel(const float4* __restrict__ part, int n_q, float4* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n_q) return;
  float4 a = part[i];
  for (int s = 1; s < SPLITS; ++s) {
    const float4 b = part[static_cast<long long>(s) * n_q + i];
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  out[i] = a;
}

constexpr int SMEM = NSTAGE * STAGE_BYTES;
constexpr int MAX_DEVICES = 64;

// the static arrays and the stages pass 48 KB together: opt in once per
// device (the first call on a device returns the attribute's error)
cudaError_t allow_smem() {
  static std::atomic<bool> done[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool known = dev >= 0 && dev < MAX_DEVICES;
  if (known && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  e = cudaFuncSetAttribute(photon_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e == cudaSuccess && known) done[dev].store(true, std::memory_order_release);
  return e;
}

}  // namespace

extern "C" {

// [queries per CTA, splits per query block]: the wrapper sizes the partials
int photon_gather_config(int* out) {
  out[0] = BQC;
  out[1] = SPLITS;
  return 0;
}

// part: SPLITS x n_q x 4 floats of scratch; out: n_q x 4
int photon_gather_launch(const float* tiles, int n_tiles, const float* aabbs, const float* q_pos,
                         const float* q_n, const unsigned char* q_valid, int n_q, float r2,
                         float inv_r2, float* part, float* out, void* stream) {
  if (n_q <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = allow_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((n_q + BQC - 1) / BQC), SPLITS);
  photon_kernel<<<grid, BQC, SMEM, s>>>(tiles, n_tiles, aabbs, q_pos, q_n, q_valid, n_q, r2,
                                        inv_r2, part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  photon_reduce_kernel<<<static_cast<unsigned>((n_q + 255) / 256), 256, 0, s>>>(
      reinterpret_cast<const float4*>(part), n_q, reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

// [registers, local bytes, static shared bytes, dynamic shared bytes,
//  resident CTAs per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)]
int photon_gather_info(int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = allow_smem();
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, photon_kernel);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, photon_kernel, BQC, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = SMEM;
  out[4] = blocks;
  return 0;
}

}  // extern "C"
