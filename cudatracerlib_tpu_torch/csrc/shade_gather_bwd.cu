// Backward of the shade-pack row gather for Hopper (sm_90a): the table
// cotangent grad[r, :] = sum of g[b, :] over the lanes b with
// clamp(idx[b], 0, Tr - 1) = r.
//
// Replaces the custom VJP of cudatracerlib_tpu/ops/shade_gather.py:102-134
// (`_gather_bwd` :127-131, a scatter-add `.at[].add` beside the Pallas
// forward `_gather_tpu` :69). The port also uses it for the Woop-row
// cotangent of the hit refinement (accel/traversal.py, C = 12) and for the
// per-lane lookups of small scene tables (ops/shade_gather.py
// `gather_rows`: textures, materials, shading rows, light triangles; C = 3
// onto a handful of rows).
//
// What bounds it on the H100: bytes, B * C * 4 of g read once (268 MB for
// 2^20 glossy lanes x 64 columns, 12.6 MB for a texture lookup's 2^20 x 3)
// plus the indices; the table-sized output is small. The design streams g
// in lane order, with no global sort:
//
//   1. gather_bwd_tile_kernel: a CTA of 256 threads owns a tile of 256
//      lanes, one contiguous span of g (at most 64 KB), which one thread
//      copies into shared memory with a bulk copy (cp.async.bulk, completion
//      on an mbarrier) while the CTA sorts the tile's keys row * 256 + lane
//      (unique, so the bitonic sort's order is the stable one), a key a
//      thread: partners in a warp by shuffles, farther ones through shared
//      memory; a table of at most 255 rows (a texture, the materials) takes
//      a counting sort by row instead, the same order. The sorted positions
//      are cut into blocks of 32; each row's run in a block is summed in
//      order and left in place in the staged row of the run's first lane; a
//      row's pieces are then added in block order: the tile partial,
//      written compactly (slot = the row's rank among the tile's rows).
//      Above 32 columns a warp takes a block and lanes hold columns; at
//      fewer a thread takes a (block, column), so no warp idles on a narrow
//      row. Per 32-row word of the table, the tile writes the mask of its
//      rows there and the slot of the first (`meta`).
//   2. gather_bwd_range_kernel: one CTA per (word, range of tiles; a range
//      is ceil(tiles / 32) tiles within [32, 1024]) folds each row's tile
//      partials in tile order: the range partial. A hot row (the glossy
//      misses' row 0 is in most tiles) is so cut into up to 32 ranges that
//      run at once.
//   3. gather_bwd_final_kernel: one thread per output element folds the
//      row's range partials in range order (the range kernel sets a bit per
//      (row, range) in a word per row and 32 ranges, which the tile kernel
//      zeroes), or writes 0 for a row no lane hit.
//
// Every sum is a left fold in a fixed order that depends only on the
// indices, with no atomics, so two launches are bit-equal;
// ops/shade_gather.py `packed_gather_bwd_emulated` spells the order out.
// Any C up to 64. Plain C interface for ctypes; the launches go on the
// caller's stream and the function returns the first error.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int TILE = 256;            // lanes a tile
constexpr int LOG_TILE = 8;
constexpr int THREADS = 256;         // a CTA of the final kernel
constexpr int MAX_RANGES = 32;       // ranges the final kernel folds while tiles allow
constexpr int MAX_RANGE_TILES = 1024;
constexpr int MAX_COLS = 64;
constexpr int BATCH = 8;             // loads in flight a fold of the range and final kernels
constexpr int SMALL_COLS = 4;        // up to this many columns, range-kernel lanes hold tiles
constexpr int GROUPS = 4;            // groups of 32 tiles in flight then
constexpr int RANGE_THREADS = 128;   // a CTA of the range kernel: 4 warps
constexpr int SMALL_ROWS = 255;      // tables up to this many rows: a counting sort by row
constexpr unsigned FULL = 0xffffffffu;

// tiles a range: ceil(n_tiles / MAX_RANGES) within [32, MAX_RANGE_TILES]
// (the wrapper's `bwd_range_tiles`)
constexpr long long range_tiles(long long n_tiles) {
  return n_tiles <= 32LL * MAX_RANGES ? 32
         : n_tiles >= static_cast<long long>(MAX_RANGE_TILES) * MAX_RANGES
             ? MAX_RANGE_TILES
             : (n_tiles + MAX_RANGES - 1) / MAX_RANGES;
}

// the staged span of g, rounded to 16 bytes, then the keys and the runs
__host__ __device__ constexpr int stage_bytes(int cols) { return (TILE * cols * 4 + 15) & ~15; }
constexpr int tile_smem(int cols) { return stage_bytes(cols) + 2 * TILE * 4; }
constexpr int HIST_BYTES = TILE / 32 * (SMALL_ROWS + 1) * 4;  // the counting sort's counts

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

// exclusive prefix sum over the CTA of one int a thread; *total gets the sum
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < warps; ++w) {
    const int s = s_warp[w];
    before += w < warp ? s : 0;
    all += s;
  }
  *total = all;
  return before + x - v;
}

// one CTA of TILE threads a tile of TILE lanes; thread tid holds lane tid's
// key, then sorted position tid's
template <bool WIDE>
__global__ void __launch_bounds__(TILE)
gather_bwd_tile_kernel(const float* __restrict__ g, int cols, const int* __restrict__ idx,
                       long long n, int n_rows, int n_words, float* __restrict__ part,
                       uint2* __restrict__ meta, unsigned* __restrict__ rows_in,
                       long long n_rows_in) {
  constexpr int T = TILE, NW = TILE / 32, log_t = LOG_TILE;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) unsigned long long s_bar;
  __shared__ int s_warp[NW];
  const int stage = stage_bytes(cols);
  float* s_g = reinterpret_cast<float*>(smem);                        // T x cols
  unsigned* s_key = reinterpret_cast<unsigned*>(smem + stage);        // T
  int* s_seg = reinterpret_cast<int*>(smem + stage + T * 4);          // T
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long tile = blockIdx.x;
  const long long lane0 = tile << log_t;
  const int nt = static_cast<int>(min(static_cast<long long>(T), n - lane0));
  const int n_floats = nt * cols;
  const int bulk_floats = n_floats & ~3;       // 16-byte multiple; the rest by hand
  const float* src = g + lane0 * cols;
  const uint32_t bar = smem_addr(&s_bar);

  if (tid == 0 && bulk_floats > 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bulk_floats * 4) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1], %2, [%3];\n"
                 :: "r"(smem_addr(s_g)), "l"(src), "r"(bulk_floats * 4), "r"(bar) : "memory");
  }
  if (tid < n_floats - bulk_floats) s_g[bulk_floats + tid] = __ldg(src + bulk_floats + tid);
  // zero the rows' masks of ranges, which the range kernel sets
  for (long long i = tile * T + tid; i < n_rows_in; i += static_cast<long long>(gridDim.x) * T)
    rows_in[i] = 0u;

  // the keys row * T + lane in ascending order (the largest key past the
  // tile's end)
  const int row = tid < nt ? min(max(__ldg(idx + lane0 + tid), 0), n_rows - 1) : n_rows;
  unsigned key = tid < nt ? (static_cast<unsigned>(row) << log_t) | static_cast<unsigned>(tid)
                          : 0xffffffffu;
  if (n_rows <= SMALL_ROWS) {
    // a stable counting sort by row: a lane's position is its row's start,
    // plus the row's lanes in earlier warps, plus those earlier in its warp
    int* s_hist = s_seg + T;                 // NW x (SMALL_ROWS + 1)
    const unsigned peers = __match_any_sync(FULL, row);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    for (int i = tid; i < NW * (SMALL_ROWS + 1); i += T) s_hist[i] = 0;
    __syncthreads();
    if (rank == 0) s_hist[warp * (SMALL_ROWS + 1) + row] = __popc(peers);
    __syncthreads();
    int total = 0;                           // thread r: row r's lanes; before it, by warp
    if (tid <= n_rows) {
      for (int w = 0; w < NW; ++w) {
        const int c = s_hist[w * (SMALL_ROWS + 1) + tid];
        s_hist[w * (SMALL_ROWS + 1) + tid] = total;
        total += c;
      }
    }
    int unused;
    const int start = block_exclusive_scan(total, s_warp, &unused);
    if (tid <= n_rows) s_seg[tid] = start;
    __syncthreads();
    s_key[s_seg[row] + s_hist[warp * (SMALL_ROWS + 1) + row] + rank] = key;
    __syncthreads();
    key = s_key[tid];
  } else {
    // bitonic: partners within a warp by shuffles, farther ones through smem
    for (int k = 2; k <= T; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        unsigned other;
        if (j >= 32) {
          s_key[tid] = key;
          __syncthreads();
          other = s_key[tid ^ j];
          __syncthreads();
        } else {
          other = __shfl_xor_sync(FULL, key, j);
        }
        key = (((tid & k) == 0) == ((tid & j) == 0)) ? min(key, other) : max(key, other);
      }
    }
    s_key[tid] = key;
    __syncthreads();
  }

  // runs of equal row, numbered by a scan over their first positions
  const bool head = tid < nt && (tid == 0 || (s_key[tid - 1] >> log_t) != (key >> log_t));
  int n_seg;
  const int my_seg = block_exclusive_scan(head ? 1 : 0, s_warp, &n_seg);
  if (head) s_seg[my_seg] = tid;
  if (bulk_floats > 0) mbar_wait(bar, 0);
  __syncthreads();

  // pieces: each run of a row within a block of 32 sorted positions summed
  // in order into the staged row of its first lane; then the tile partials:
  // a row's pieces in block order, at slot = the row's rank. WIDE: a warp a
  // block (then a row), lanes holding columns lane and lane + 32; else a
  // thread a (block, column) (then a (row, column))
  const bool h0 = lane < cols, h1 = lane + 32 < cols;
  const int n_blocks = (nt + 31) >> 5;
  const unsigned low = (1u << log_t) - 1;
  const long long cap = min(T, n_rows);
  if (WIDE) {
    for (int blk = warp; blk < n_blocks; blk += NW) {
      const int p1 = min(blk * 32 + 32, nt);
      int p = blk * 32;
      while (p < p1) {                        // warp-uniform
        const unsigned run_key = s_key[p], run_row = run_key >> log_t;
        float* dst = s_g + (run_key & low) * cols;
        float a0 = h0 ? dst[lane] : 0.f, a1 = h1 ? dst[lane + 32] : 0.f;
        for (++p; p < p1 && (s_key[p] >> log_t) == run_row; ++p) {
          const float* x = s_g + (s_key[p] & low) * cols;
          if (h0) a0 = __fadd_rn(a0, x[lane]);
          if (h1) a1 = __fadd_rn(a1, x[lane + 32]);
        }
        if (h0) dst[lane] = a0;
        if (h1) dst[lane + 32] = a1;
      }
    }
    __syncthreads();
    for (int sg = warp; sg < n_seg; sg += NW) {
      const int a = s_seg[sg], b = sg + 1 < n_seg ? s_seg[sg + 1] : nt;
      const float* x = s_g + (s_key[a] & low) * cols;
      float a0 = h0 ? x[lane] : 0.f, a1 = h1 ? x[lane + 32] : 0.f;
      for (int q = (a >> 5) + 1; q * 32 < b; ++q) {
        x = s_g + (s_key[q * 32] & low) * cols;
        if (h0) a0 = __fadd_rn(a0, x[lane]);
        if (h1) a1 = __fadd_rn(a1, x[lane + 32]);
      }
      float* out = part + (tile * cap + sg) * cols;
      if (h0) out[lane] = a0;
      if (h1) out[lane + 32] = a1;
    }
  } else {
    for (int item = tid; item < n_blocks * cols; item += T) {
      const int blk = item / cols, c = item - blk * cols;
      const int p1 = min(blk * 32 + 32, nt);
      int p = blk * 32;
      while (p < p1) {
        const unsigned run_row = s_key[p] >> log_t;
        float* dst = s_g + (s_key[p] & low) * cols + c;
        float acc = *dst;
        for (++p; p < p1 && (s_key[p] >> log_t) == run_row; ++p)
          acc = __fadd_rn(acc, s_g[(s_key[p] & low) * cols + c]);
        *dst = acc;
      }
    }
    __syncthreads();
    for (int item = tid; item < n_seg * cols; item += T) {
      const int sg = item / cols, c = item - sg * cols;
      const int a = s_seg[sg], b = sg + 1 < n_seg ? s_seg[sg + 1] : nt;
      float acc = s_g[(s_key[a] & low) * cols + c];
      for (int q = (a >> 5) + 1; q * 32 < b; ++q)
        acc = __fadd_rn(acc, s_g[(s_key[q * 32] & low) * cols + c]);
      part[(tile * cap + sg) * cols + c] = acc;
    }
  }
  // per 32-row word: the mask of the tile's rows there and the first's slot
  for (int w = tid; w < n_words; w += T) {
    const unsigned base = static_cast<unsigned>(w) << 5;
    int lo = 0, hi = n_seg;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((s_key[s_seg[mid]] >> log_t) < base) lo = mid + 1; else hi = mid;
    }
    unsigned mask = 0;
    for (int q = lo; q < n_seg; ++q) {
      const unsigned r = s_key[s_seg[q]] >> log_t;
      if (r >= base + 32) break;
      mask |= 1u << (r - base);
    }
    meta[tile * n_words + w] = make_uint2(mask, static_cast<unsigned>(lo));
  }
}

// one CTA a (32-row word, range of tiles): the range's row masks
// staged in smem, the word's rows present there dealt to the warps in turn;
// a warp folds its row's tile partials in tile order. Above SMALL_COLS
// columns lanes hold columns and BATCH partials are in flight across the
// range's groups of 32 tiles; at SMALL_COLS or fewer lanes hold tiles,
// GROUPS groups' partials are loaded at once and folded by shuffles
template <bool SMALL>
__global__ void __launch_bounds__(RANGE_THREADS, 12)
gather_bwd_range_kernel(const float* __restrict__ part, const uint2* __restrict__ meta,
                        int cols, long long n_tiles, long long cap, int n_rows, int n_words,
                        int range_tiles, float* __restrict__ rp, unsigned* __restrict__ rows_in) {
  constexpr int NT = RANGE_THREADS, RW = NT / 32;
  extern __shared__ uint2 s_meta[];  // range_tiles rounded up to 32
  __shared__ unsigned s_or[RW];
  const int w = blockIdx.x, j = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long t0 = static_cast<long long>(j) * range_tiles;
  const int nt = static_cast<int>(min(static_cast<long long>(range_tiles), n_tiles - t0));
  const int n_groups = (nt + 31) >> 5;
  unsigned mine = 0;
  for (int i = threadIdx.x; i < n_groups * 32; i += NT) {
    const uint2 m = i < nt ? __ldg(meta + (t0 + i) * n_words + w) : make_uint2(0u, 0u);
    s_meta[i] = m;
    mine |= m.x;
  }
  mine = __reduce_or_sync(FULL, mine);
  if (lane == 0) s_or[warp] = mine;
  __syncthreads();
  unsigned all = 0;
#pragma unroll
  for (int k = 0; k < RW; ++k) all |= s_or[k];
  const bool has0 = lane < cols, has1 = lane + 32 < cols;
  int k = 0;
  for (unsigned rest = all; rest; rest &= rest - 1u, ++k) {
    if (k % RW != warp) continue;            // warp-uniform
    const int b = __ffs(rest) - 1;
    const unsigned below = (1u << b) - 1u;
    float* out = rp + (static_cast<long long>(j) * n_rows + 32LL * w + b) * cols;
    if (lane == 0)  // the row is in range j
      atomicOr(rows_in + static_cast<long long>(j >> 5) * n_rows + 32LL * w + b, 1u << (j & 31));
    if (SMALL) {
      // lanes hold tiles: a group's partials loaded at once, GROUPS groups
      // in flight, then folded in tile order by shuffles
      float acc[SMALL_COLS] = {0.f, 0.f, 0.f, 0.f};
      bool first = true;
      for (int g0 = 0; g0 < n_groups; g0 += GROUPS) {
        unsigned pres[GROUPS];
        float v[GROUPS][SMALL_COLS];
#pragma unroll
        for (int u = 0; u < GROUPS; ++u) {
          const uint2 m = g0 + u < n_groups ? s_meta[(g0 + u) * 32 + lane] : make_uint2(0u, 0u);
          const bool held = (m.x >> b) & 1u;
          pres[u] = __ballot_sync(FULL, held);
          const float* p = part + ((t0 + (g0 + u) * 32 + lane) * cap + m.y +
                                   __popc(m.x & below)) * cols;
#pragma unroll
          for (int c = 0; c < SMALL_COLS; ++c) v[u][c] = held && c < cols ? __ldg(p + c) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < GROUPS; ++u) {
          for (unsigned q = pres[u]; q; q &= q - 1u) {   // warp-uniform
            const int t = __ffs(q) - 1;
#pragma unroll
            for (int c = 0; c < SMALL_COLS; ++c) {
              const float x = __shfl_sync(FULL, v[u][c], t);
              acc[c] = first ? x : __fadd_rn(acc[c], x);
            }
            first = false;
          }
        }
      }
      if (lane < cols) {
#pragma unroll
        for (int c = 0; c < SMALL_COLS; ++c)
          if (c == lane) out[c] = acc[c];
      }
      continue;
    }
    float acc0 = 0.f, acc1 = 0.f;
    bool first = true, more = true;
    int gi = -1, slot = 0;
    unsigned pres = 0;                       // the row's tiles left in group gi
    while (more) {                           // warp-uniform
      float v0[BATCH], v1[BATCH];
      bool ok[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        while (pres == 0u && gi + 1 < n_groups) {
          ++gi;
          const uint2 m = s_meta[gi * 32 + lane];   // lane = tile of the group
          pres = __ballot_sync(FULL, (m.x >> b) & 1u);
          slot = static_cast<int>(m.y) + __popc(m.x & below);
        }
        ok[u] = pres != 0u;
        const int t = ok[u] ? __ffs(pres) - 1 : 0;
        pres &= pres - 1u;                   // 0 stays 0
        const int sl = __shfl_sync(FULL, slot, t);
        const float* p = part + ((t0 + gi * 32 + t) * cap + sl) * cols;
        v0[u] = ok[u] && has0 ? __ldg(p + lane) : 0.f;
        v1[u] = ok[u] && has1 ? __ldg(p + lane + 32) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        if (ok[u]) {
          acc0 = first ? v0[u] : __fadd_rn(acc0, v0[u]);
          acc1 = first ? v1[u] : __fadd_rn(acc1, v1[u]);
          first = false;
        }
      }
      more = ok[BATCH - 1] && (pres != 0u || gi + 1 < n_groups);
    }
    if (has0) out[lane] = acc0;
    if (has1) out[lane + 32] = acc1;
  }
}

// one thread an output element
__global__ void __launch_bounds__(THREADS)
gather_bwd_final_kernel(const float* __restrict__ rp, const unsigned* __restrict__ rows_in,
                        int cols, int n_rows, int n_ranges, float* __restrict__ grad) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= static_cast<long long>(n_rows) * cols) return;
  const int r = static_cast<int>(i / cols);
  const long long stride = static_cast<long long>(n_rows) * cols;
  float acc = 0.f;                           // 0 for a row no lane hit
  bool first = true;
  for (int j0 = 0; j0 < n_ranges; j0 += 32) {
    unsigned bits = __ldg(rows_in + static_cast<long long>(j0 >> 5) * n_rows + r);
    while (bits) {                           // BATCH ranges' values in flight
      float v[BATCH];
      bool ok[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        ok[u] = bits != 0u;
        const int jj = ok[u] ? __ffs(bits) - 1 : 0;
        bits &= bits - 1u;
        v[u] = ok[u] ? __ldg(rp + (j0 + jj) * stride + i) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        if (ok[u]) {
          acc = first ? v[u] : __fadd_rn(acc, v[u]);
          first = false;
        }
      }
    }
  }
  grad[i] = acc;
}

constexpr int SMEM = tile_smem(MAX_COLS) + HIST_BYTES;
constexpr int MAX_DEVICES = 64;

// the stage and the key arrays pass 48 KB: opt in once per device
cudaError_t allow_smem() {
  static std::atomic<bool> done[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool known = dev >= 0 && dev < MAX_DEVICES;
  if (known && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  e = cudaFuncSetAttribute(gather_bwd_tile_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gather_bwd_tile_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e == cudaSuccess && known) done[dev].store(true, std::memory_order_release);
  return e;
}

long long round4(long long x) { return (x + 3) & ~3LL; }

}  // namespace

extern "C" {

// Scratch floats the launch needs for n lanes of n_cols onto n_rows rows
// (the wrapper's `bwd_scratch_floats`): the tile partials, the tiles' row
// masks, the range partials and each row's mask of ranges, each 16-byte
// aligned.
long long shade_gather_bwd_scratch(int n_cols, long long n, int n_rows) {
  const long long n_tiles = (n + TILE - 1) / TILE, n_words = (n_rows + 31) / 32;
  const long long rt = range_tiles(n_tiles), n_ranges = (n_tiles + rt - 1) / rt;
  const long long cap = TILE < n_rows ? TILE : n_rows;
  return round4(n_tiles * cap * n_cols) + round4(2 * n_tiles * n_words) +
         round4(n_ranges * n_rows * n_cols) + round4((n_ranges + 31) / 32 * n_rows);
}

// g (n, n_cols) f32 row-major, 16-byte aligned; idx (n,) i32 (clamped here);
// grad (n_rows, n_cols) f32; scratch of `scratch_floats` f32 (at least
// shade_gather_bwd_scratch's). 1 <= n_cols <= 64, n_rows < 2^24
// (cudaErrorInvalidValue otherwise).
int shade_gather_bwd_launch(const float* g, int n_cols, const int* idx, long long n, int n_rows,
                            float* grad, float* scratch, long long scratch_floats, void* stream) {
  if (n_cols < 1 || n_cols > MAX_COLS || n_rows < 1 || n_rows >= (1 << (32 - LOG_TILE)) ||
      n < 0 || scratch_floats < shade_gather_bwd_scratch(n_cols, n, n_rows) ||
      (reinterpret_cast<uintptr_t>(g) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_tiles = (n + TILE - 1) / TILE, n_words = (n_rows + 31) / 32;
  const long long rt = range_tiles(n_tiles), n_ranges = (n_tiles + rt - 1) / rt;
  const long long cap = TILE < n_rows ? TILE : n_rows;
  float* part = scratch;
  uint2* meta = reinterpret_cast<uint2*>(part + round4(n_tiles * cap * n_cols));
  float* rp = reinterpret_cast<float*>(meta) + round4(2 * n_tiles * n_words);
  unsigned* rows_in = reinterpret_cast<unsigned*>(rp + round4(n_ranges * n_rows * n_cols));
  cudaError_t e = allow_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n_rows_in = (n_ranges + 31) / 32 * n_rows;
  if (n_tiles > 0) {
    const unsigned tiles = static_cast<unsigned>(n_tiles);
    const int smem = tile_smem(n_cols) + (n_rows <= SMALL_ROWS ? HIST_BYTES : 0);
    if (n_cols > 32) {
      gather_bwd_tile_kernel<true><<<tiles, TILE, smem, st>>>(
          g, n_cols, idx, n, n_rows, static_cast<int>(n_words), part, meta, rows_in, n_rows_in);
    } else {
      gather_bwd_tile_kernel<false><<<tiles, TILE, smem, st>>>(
          g, n_cols, idx, n, n_rows, static_cast<int>(n_words), part, meta, rows_in, n_rows_in);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t meta_smem = ((rt + 31) / 32) * 32 * sizeof(uint2);
    const dim3 grid(static_cast<unsigned>(n_words), static_cast<unsigned>(n_ranges));
    if (n_cols <= SMALL_COLS) {
      gather_bwd_range_kernel<true><<<grid, RANGE_THREADS, meta_smem, st>>>(
          part, meta, n_cols, n_tiles, cap, n_rows, static_cast<int>(n_words),
          static_cast<int>(rt), rp, rows_in);
    } else {
      gather_bwd_range_kernel<false><<<grid, RANGE_THREADS, meta_smem, st>>>(
          part, meta, n_cols, n_tiles, cap, n_rows, static_cast<int>(n_words),
          static_cast<int>(rt), rp, rows_in);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long n_out = static_cast<long long>(n_rows) * n_cols;
  gather_bwd_final_kernel<<<static_cast<unsigned>((n_out + THREADS - 1) / THREADS), THREADS, 0,
                            st>>>(rp, rows_in, n_cols, n_rows, static_cast<int>(n_ranges), grad);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
