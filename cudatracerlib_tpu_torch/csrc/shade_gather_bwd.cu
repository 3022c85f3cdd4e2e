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
// 2^20 glossy lanes x 64 columns, 537 MB for a volume grid's 2^27 x 1) plus
// the indices; the table-sized output is small. The design streams g in
// lane order, with no global sort:
//
//   1. Tiles of 256 lanes: each sorts its keys row * 256 + lane (unique, so
//      the bitonic order is the stable one); the sorted positions are cut
//      into blocks of 32; each row's run in a block is summed in order and
//      left in place in the staged row of the run's first lane; a row's
//      pieces are then added in block order: the tile partial, written
//      compactly (slot = the row's rank among the tile's rows). Beside the
//      partials a tile writes its record for the range stage (below).
//      gather_bwd_tile_kernel: a CTA of 256 threads a tile, g bulk-copied
//      into shared memory (cp.async.bulk, completion on an mbarrier) while
//      the CTA sorts a key a thread (partners in a warp by shuffles, farther
//      ones through shared memory; a table of at most 255 rows takes a
//      counting sort by row instead, the same order); above 32 columns a
//      warp takes a block and lanes hold columns, at fewer a thread a
//      (block, column). gather_bwd_warp_tile_kernel (C <= 4, more than 255
//      rows, row lists): a warp a tile, eight keys a lane sorted in
//      registers and by shuffles, a lane a run and column: the CTA kernel's
//      sort costs eight warps' instructions a tile, and at C = 1 its pieces
//      kept eight threads of 256 busy.
//   2. The range stage folds each row's tile partials in tile order within
//      a range of tiles (ceil(tiles / 32) within [32, 1024]): the range
//      partial. A hot row (the glossy misses' row 0 is in most tiles) is so
//      cut into up to 32 ranges that run at once. The rule (`word_masks`,
//      the wrapper's `bwd_word_masks`, a fixed function of rows and C):
//      while a tile's per-32-row-word masks take at most a quarter of its
//      span of g (n_words <= 32 C: the pack, the Woop rows, the small
//      tables), the tile writes per word the mask of its rows there and the
//      first's slot, and gather_bwd_word_kernel takes a CTA per (word,
//      range): the masks staged, a warp a row, its partials folded in tile
//      order. Past the rule those masks would grow with tiles x rows (4.3 GB
//      at the volume grid); the tile writes its rows in ascending order and
//      their count instead, and gather_bwd_range_kernel takes a CTA per (band
//      of rows, range). The band's accumulators live in shared memory, each
//      started at -0.0 (x + (-0.0) == x for every float x, so the first add
//      leaves the first partial as it is); each tile's slice of the band is
//      found by binary searches (fixed steps, a thread's tiles interleaved)
//      and the slices laid end to end in tile order: the stream of (slot,
//      column) items. The stream goes in chunks of 2,048 items, the next
//      chunk's loads in flight; an accumulator's owner is thread (index mod
//      256), a chunk's items are sorted by owner stably (counts by (warp,
//      owner), a scan, then each warp places its items in order, lanes of
//      one owner found by tags and ranked by a match), and each owner adds
//      its items in stream order: tile order for every accumulator, with
//      four barriers a chunk and none a tile. Its reads grow with the
//      (tile, row) pairs that exist plus a search per (tile, band), its
//      scratch with the partials, the row lists and ranges x rows x C. The
//      bands (`bands`, the wrapper's `bwd_bands`): the fewest whose
//      accumulators and hit bytes fit BAND_WORDS words (48 KB), raised
//      towards FILL_CTAS CTAs over the ranges (so 32 ranges still fill the
//      132 SMs) while a band keeps MIN_BAND_ROWS rows.
//   3. gather_bwd_final_kernel: one thread per output element folds the
//      row's range partials in range order (the range stage sets a bit per
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
#include <initializer_list>

namespace {

constexpr int TILE = 256;            // lanes a tile
constexpr int LOG_TILE = 8;
constexpr int THREADS = 256;         // a CTA of the final kernel
constexpr int MAX_RANGES = 32;       // ranges the final kernel folds while tiles allow
constexpr int MAX_RANGE_TILES = 1024;
constexpr int MAX_COLS = 64;
constexpr int BATCH = 8;             // loads in flight a fold of the word and final kernels
constexpr int SMALL_COLS = 4;        // up to this many columns, word-kernel lanes hold tiles
constexpr int GROUPS = 4;            // groups of 32 tiles in flight then
constexpr int WORD_THREADS = 128;    // a CTA of the word kernel: 4 warps
constexpr int MASK_WORDS_PER_COL = 32;  // word masks while n_words <= this x cols (the rule)
constexpr int RANGE_THREADS = 256;   // a CTA of the range kernel: 8 warps, an owner a thread
constexpr int RANGE_WARPS = RANGE_THREADS / 32;
constexpr int ITEMS = 8;             // (slot, column) items a thread loads a chunk
constexpr int CHUNK = RANGE_THREADS * ITEMS;
constexpr int BAND_WORDS = 12288;    // a band's accumulators and hit bytes, at most (48 KB)
constexpr int FILL_CTAS = 256;       // range-kernel CTAs the bands aim at: one wave, two an SM
constexpr int MIN_BAND_ROWS = 256;   // rows a band keeps while the bands are raised for fill
constexpr int SMALL_ROWS = 255;      // tables up to this many rows: a counting sort by row
constexpr int WARP_COLS = 4;         // row lists and up to this many columns: a warp a tile
constexpr int WT_WARPS = 8;          // tiles (warps) a CTA of the warp tile kernel
constexpr int PER_LANE = TILE / 32;  // keys a lane there
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

constexpr long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// the range stage's rule (the wrapper's `bwd_word_masks`): per-32-row-word
// masks and the word kernel while a tile's masks (8 bytes a word) take at
// most a quarter of its span of g (256 lanes x cols x 4 bytes), so their
// bytes never pass the input's; else row lists and the band kernel
constexpr bool word_masks(long long n_rows, int cols) {
  return cdiv(n_rows, 32) <= static_cast<long long>(MASK_WORDS_PER_COL) * cols;
}

// the bands of rows the range kernel's CTAs take (the wrapper's `bwd_bands`):
// the fewest whose band_rows * cols accumulators and band_rows hit bytes fit
// BAND_WORDS, raised towards FILL_CTAS CTAs over n_ranges while a band
// keeps MIN_BAND_ROWS rows; then the rows evened out
struct Bands {
  long long n, rows;
};
constexpr Bands bands(long long n_ranges, long long n_rows, int cols) {
  const long long most = 4LL * BAND_WORDS / (4LL * cols + 1);
  const long long fill = cdiv(FILL_CTAS, n_ranges > 0 ? n_ranges : 1);
  const long long keep = cdiv(n_rows, MIN_BAND_ROWS);
  const long long by_smem = cdiv(n_rows, most), by_fill = fill < keep ? fill : keep;
  const long long nb = by_smem > by_fill ? by_smem : by_fill;
  const long long rows = cdiv(n_rows, nb);
  return Bands{cdiv(n_rows, rows), rows};
}

// the range kernel's shared memory: a band row's accumulators and hit byte;
// a chunk's counts and tags by (warp, owner) and its items by owner; the
// tiles' offsets and slice starts
constexpr long long range_smem(long long band_rows, int cols, long long rt) {
  return (band_rows * cols + cdiv(band_rows, 4) + 2 * RANGE_WARPS * RANGE_THREADS + 2 * CHUNK +
          2 * rt + 1) * 4;
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
                       uint2* __restrict__ meta, int* __restrict__ rows_of,
                       int* __restrict__ nseg, unsigned* __restrict__ rows_in,
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
  if (n_words > 0) {
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
    return;
  }
  // else the tile's record: its rows in ascending order, one a slot, and their count
  for (int sg = tid; sg < n_seg; sg += T)
    rows_of[tile * cap + sg] = static_cast<int>(s_key[s_seg[sg]] >> log_t);
  if (tid == 0) nseg[tile] = n_seg;
}

// the positions 8 lane + e whose bit e of `flags` is set, in order, into
// out[]; returns how many (every lane)
__device__ __forceinline__ int list_positions(unsigned flags, int* out, int lane) {
  const int mine = __popc(flags);
  int x = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  int at = x - mine;
#pragma unroll
  for (int e = 0; e < PER_LANE; ++e)
    if ((flags >> e) & 1u) out[at++] = lane * PER_LANE + e;
  return __shfl_sync(FULL, x, 31);
}

// one warp a tile of TILE lanes (row lists, cols <= WARP_COLS), WT_WARPS
// tiles a CTA: the tile kernel's order and sums with a warp's instructions
// where the CTA kernel spends eight warps'. Lane l holds the keys of
// positions 8l..8l+7 and sorts them by a bitonic network, partners below 8
// apart in registers, farther ones by shuffles; then the pieces, a lane a
// (run, column), all runs at once; the tile partials, a lane a (row,
// column); and the row list, as gather_bwd_tile_kernel writes them.
template <int cols>
__global__ void __launch_bounds__(WT_WARPS * 32, cols <= 2 ? 4 : 3)
gather_bwd_warp_tile_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                            long long n, int n_rows, float* __restrict__ part,
                            int* __restrict__ rows_of, int* __restrict__ nseg,
                            unsigned* __restrict__ rows_in, long long n_rows_in) {
  constexpr int T = TILE, log_t = LOG_TILE;
  __shared__ unsigned s_keys[WT_WARPS][T];
  __shared__ float s_gs[WT_WARPS][T * cols];
  __shared__ int s_segs[WT_WARPS][T];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // zero the rows' masks of ranges, which the range kernel sets
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n_rows_in;
       i += static_cast<long long>(gridDim.x) * blockDim.x)
    rows_in[i] = 0u;
  const long long n_tiles = (n + T - 1) / T;
  const long long tile = static_cast<long long>(blockIdx.x) * WT_WARPS + warp;
  if (tile >= n_tiles) return;               // no barrier of the CTA below
  unsigned* s_key = s_keys[warp];
  float* s_g = s_gs[warp];
  int* s_seg = s_segs[warp];
  const long long lane0 = tile << log_t;
  const int nt = static_cast<int>(min(static_cast<long long>(T), n - lane0));
  const int n_floats = nt * cols;
  const float* src = g + lane0 * cols;
  float gv[PER_LANE * cols];                 // the span of g, loads in flight across the sort
#pragma unroll
  for (int m = 0; m < PER_LANE * cols; ++m)
    gv[m] = m * 32 + lane < n_floats ? __ldg(src + m * 32 + lane) : 0.f;
  unsigned k[PER_LANE];
#pragma unroll
  for (int e = 0; e < PER_LANE; ++e) {
    const int i = lane * PER_LANE + e;
    k[e] = i < nt ? (static_cast<unsigned>(min(max(__ldg(idx + lane0 + i), 0), n_rows - 1))
                     << log_t) | static_cast<unsigned>(i)
                  : 0xffffffffu;
  }
  // bitonic over positions i = 8 lane + e, ascending where (i & kk) == 0
#pragma unroll
  for (int kk = 2; kk <= T; kk <<= 1) {
#pragma unroll
    for (int j = kk >> 1; j > 0; j >>= 1) {
      if (j >= PER_LANE) {
        const int i0 = lane * PER_LANE;     // (i & kk) and (i & j) do not depend on e here
        const bool keep_min = ((i0 & kk) == 0) == ((i0 & j) == 0);
#pragma unroll
        for (int e = 0; e < PER_LANE; ++e) {
          const unsigned other = __shfl_xor_sync(FULL, k[e], j / PER_LANE);
          k[e] = keep_min ? min(k[e], other) : max(k[e], other);
        }
      } else {
#pragma unroll
        for (int e = 0; e < PER_LANE; ++e) {
          if ((e & j) == 0) {
            const bool up = ((lane * PER_LANE + e) & kk) == 0;
            const unsigned a = k[e], b = k[e | j];
            k[e] = up ? min(a, b) : max(a, b);
            k[e | j] = up ? max(a, b) : min(a, b);
          }
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < PER_LANE; ++e) s_key[lane * PER_LANE + e] = k[e];
#pragma unroll
  for (int m = 0; m < PER_LANE * cols; ++m)
    if (m * 32 + lane < n_floats) s_g[m * 32 + lane] = gv[m];
  // heads: the first position of each row's lanes; runs: a row's stretch
  // within a block of 32 positions (a head, or a block's first position)
  const unsigned before_me = __shfl_up_sync(FULL, k[PER_LANE - 1], 1);
  unsigned heads = 0;
#pragma unroll
  for (int e = 0; e < PER_LANE; ++e) {
    const int i = lane * PER_LANE + e;
    const unsigned prev = e == 0 ? before_me : k[e - 1];
    if (i < nt && (i == 0 || (prev >> log_t) != (k[e] >> log_t))) heads |= 1u << e;
  }
  const unsigned starts = heads | ((lane & 3) == 0 && lane * PER_LANE < nt ? 1u : 0u);
  const int n_runs = list_positions(starts, s_seg, lane);
  __syncwarp();

  // pieces: each run summed in order into the staged row of its first lane
  const unsigned low = (1u << log_t) - 1;
  const long long cap = min(T, n_rows);
  for (int item = lane; item < n_runs * cols; item += 32) {
    const int run = item / cols, c = item - run * cols;
    const int p0 = s_seg[run], p1 = run + 1 < n_runs ? s_seg[run + 1] : nt;
    float* dst = s_g + (s_key[p0] & low) * cols + c;
    float acc = *dst;
    for (int p = p0 + 1; p < p1; ++p) acc = __fadd_rn(acc, s_g[(s_key[p] & low) * cols + c]);
    *dst = acc;
  }
  __syncwarp();
  // the tile partials: a row's pieces in block order, at slot = the row's rank
  const int n_seg = list_positions(heads, s_seg, lane);
  __syncwarp();
  for (int item = lane; item < n_seg * cols; item += 32) {
    const int sgi = item / cols, c = item - sgi * cols;
    const int a = s_seg[sgi], b = sgi + 1 < n_seg ? s_seg[sgi + 1] : nt;
    float acc = s_g[(s_key[a] & low) * cols + c];
    for (int q = (a >> 5) + 1; q * 32 < b; ++q)
      acc = __fadd_rn(acc, s_g[(s_key[q * 32] & low) * cols + c]);
    part[(tile * cap + sgi) * cols + c] = acc;
  }
  for (int i = lane; i < n_seg; i += 32)
    rows_of[tile * cap + i] = static_cast<int>(s_key[s_seg[i]] >> log_t);
  if (lane == 0) nseg[tile] = n_seg;
}

// the tile of the range's stream holding item q: the last t with s_off[t] <= q
__device__ __forceinline__ int tile_of(const int* s_off, int nt, int q) {
  int lo = 0, hi = nt;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (s_off[mid] <= q) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// a chunk's item held as (k, this thread): stream position base + 256 warp
// + 32 k + lane, so a warp holds 256 consecutive items and its lanes
// neighbouring ones
__device__ __forceinline__ int item_pos(int k) {
  const int tid = threadIdx.x;
  return (tid & ~31) * ITEMS + k * 32 + (tid & 31);
}

// the chunk's items at base + item_pos(k) below total: the partial, its row
// and column (-1 past the end). rl and pt are the range's row lists and
// partials, s_b[t] tile t's first in-band slot there.
__device__ __forceinline__ void load_items(int base, int total, int nt, const int* s_off,
                                           const int* s_b, const float* __restrict__ pt,
                                           const int* __restrict__ rl, int cols,
                                           float (&v)[ITEMS], int (&row)[ITEMS],
                                           int (&col)[ITEMS]) {
  const int q0 = base + item_pos(0);
  int t = q0 < total ? tile_of(s_off, nt, q0) : 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int q = base + item_pos(k);
    col[k] = -1;
    if (q < total) {
      while (s_off[t + 1] <= q) ++t;
      const int local = q - s_off[t], e = local / cols, c = local - e * cols;
      const int slot = s_b[t] + e;
      row[k] = __ldg(rl + slot);
      v[k] = __ldg(pt + slot * cols + c);
      col[k] = c;
    }
  }
}

// the first of the n ascending rl[] not below r, for PER lists at once:
// fixed steps, so the lists' loads go out together
template <int PER>
__device__ __forceinline__ void lower_bounds(const int* const (&rl)[PER], const int (&n)[PER],
                                             int r, int (&lo)[PER]) {
#pragma unroll
  for (int u = 0; u < PER; ++u) lo[u] = 0;
#pragma unroll
  for (int step = TILE; step > 0; step >>= 1) {
#pragma unroll
    for (int u = 0; u < PER; ++u)
      if (lo[u] + step <= n[u] && __ldg(rl[u] + lo[u] + step - 1) < r) lo[u] += step;
  }
}

// one CTA a (band of rows, range of tiles), blockIdx (band, range): the
// band's range partials, folded in tile order in shared memory. The range's
// in-band items, laid end to end in tile order, go in chunks, the next
// chunk's loads in flight while this one is added. An accumulator's owner
// is thread (index mod 256): a chunk's items are sorted by owner, stably
// (counts by (warp, owner), a scan, then each warp places its items in
// order, equal owners among 32 lanes by lane), and each owner adds its
// items in stream order. So an accumulator takes its partials in tile order
// with four barriers a chunk and none a tile.
template <int CC>
__global__ void __launch_bounds__(RANGE_THREADS, 2)
gather_bwd_range_kernel(const float* __restrict__ part, const int* __restrict__ rows_of,
                        const int* __restrict__ nseg, int n_cols, long long n_tiles,
                        long long cap, int n_rows, int band_rows, int range_tiles,
                        float* __restrict__ rp, unsigned* __restrict__ rows_in) {
  constexpr int NT = RANGE_THREADS, PER = MAX_RANGE_TILES / NT;
  const int cols = CC > 0 ? CC : n_cols;     // CC: the columns fixed at compile time, or 0
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_warp[NT / 32];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, j = blockIdx.y;
  const int r0 = blockIdx.x * band_rows, nr = min(band_rows, n_rows - r0);
  const bool whole = nr == n_rows;           // one band: every slot is in it
  const long long t0 = static_cast<long long>(j) * range_tiles;
  const int nt = static_cast<int>(min(static_cast<long long>(range_tiles), n_tiles - t0));
  float* s_acc = reinterpret_cast<float*>(smem);                  // nr x cols
  unsigned char* s_hit = reinterpret_cast<unsigned char*>(s_acc + nr * cols);  // a byte a row
  int* s_cnt = reinterpret_cast<int*>(s_hit + ((nr + 3) & ~3));  // [warp][owner]
  float* s_lv = reinterpret_cast<float*>(s_cnt + RANGE_WARPS * NT);  // CHUNK by owner: partial
  int* s_la = reinterpret_cast<int*>(s_lv + CHUNK);               // CHUNK by owner: accumulator
  int* s_tag = s_la + CHUNK;                                      // [warp][owner]: a lane
  int* s_off = s_tag + RANGE_WARPS * NT;                          // nt + 1: items before a tile
  int* s_b = s_off + nt + 1;                                      // nt: a tile's first slot here
  const int* rl_range = rows_of + t0 * cap;                       // the range's row lists
  const float* pt_range = part + t0 * cap * cols;                 // and partials
  for (int i = tid; i < nr * cols; i += NT) s_acc[i] = -0.0f;
  for (int i = tid; i < nr; i += NT) s_hit[i] = 0;
  for (int i = tid; i < RANGE_WARPS * NT; i += NT) s_cnt[i] = 0;

  // each tile's slots in the band, [a, b); thread tid takes tiles tid * PER + u
  int cnt[PER], mine = 0;
  {
    const int* rl[PER];
    int n[PER], a[PER], b[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid * PER + u;
      rl[u] = rows_of + (t0 + min(i, nt - 1)) * cap;
      n[u] = i < nt ? __ldg(nseg + t0 + i) : 0;
    }
    if (whole) {
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        a[u] = 0;
        b[u] = n[u];
      }
    } else {
      lower_bounds<PER>(rl, n, r0, a);
      lower_bounds<PER>(rl, n, r0 + nr, b);
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid * PER + u;
      if (i < nt) s_b[i] = i * static_cast<int>(cap) + a[u];
      cnt[u] = (b[u] - a[u]) * cols;
      mine += cnt[u];
    }
  }
  int total;
  int before = block_exclusive_scan(mine, s_warp, &total);
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = tid * PER + u;
    if (i < nt) s_off[i] = before;
    before += cnt[u];
  }
  if (tid == 0) s_off[nt] = total;
  __syncthreads();

  float v[ITEMS], vn[ITEMS];
  int row[ITEMS], rown[ITEMS], col[ITEMS], coln[ITEMS];
  if (total > 0) load_items(0, total, nt, s_off, s_b, pt_range, rl_range, cols, v, row, col);
  for (int base = 0; base < total; base += CHUNK) {
    const bool more = base + CHUNK < total;
    if (more)
      load_items(base + CHUNK, total, nt, s_off, s_b, pt_range, rl_range, cols, vn, rown, coln);
    // counts by (warp, owner); an item's place among its warp's items of its owner
    int acc[ITEMS], place[ITEMS];
    int* cw = s_cnt + warp * NT;
    int* tw = s_tag + warp * NT;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const bool ok = col[k] >= 0;
      const int r = row[k] - r0;
      acc[k] = ok ? r * cols + col[k] : -1;
      if (ok && col[k] == 0) s_hit[r] = 1;
      const int o = acc[k] & (NT - 1);
      // lanes of one owner: found by tags, by the match only where two lanes share one
      if (ok) tw[o] = lane;
      __syncwarp();
      const bool clash = ok && tw[o] != lane;
      const unsigned peers = __any_sync(FULL, clash) ? __match_any_sync(FULL, ok ? o : -1 - lane)
                                                     : 1u << lane;
      __syncwarp();
      const int leader = __ffs(peers) - 1;
      int had = 0;
      if (ok && lane == leader) {
        had = cw[o];
        cw[o] = had + __popc(peers);
      }
      had = __shfl_sync(FULL, had, leader);
      place[k] = had + __popc(peers & ((1u << lane) - 1u));
    }
    __syncthreads();
    // owner tid's items start after the earlier owners' and, within it, the earlier warps'
    int sum = 0;
#pragma unroll
    for (int w = 0; w < RANGE_WARPS; ++w) sum += s_cnt[w * NT + tid];
    int own_total;
    int start = block_exclusive_scan(sum, s_warp, &own_total);
    const int own_start = start;
#pragma unroll
    for (int w = 0; w < RANGE_WARPS; ++w) {
      const int c = s_cnt[w * NT + tid];
      s_cnt[w * NT + tid] = start;
      start += c;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (acc[k] >= 0) {
        const int at = cw[acc[k] & (NT - 1)] + place[k];
        s_lv[at] = v[k];
        s_la[at] = acc[k];
      }
    }
    __syncthreads();
    // owner tid adds its items in stream order
    for (int i = own_start; i < own_start + sum; ++i) {
      float* a = s_acc + s_la[i];
      *a = __fadd_rn(*a, s_lv[i]);
    }
#pragma unroll
    for (int w = 0; w < RANGE_WARPS; ++w) s_cnt[w * NT + tid] = 0;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      v[k] = vn[k];
      row[k] = rown[k];
      col[k] = more ? coln[k] : -1;
    }
  }

  // the range partials of the rows seen here, and their bits
  float* out = rp + (static_cast<long long>(j) * n_rows + r0) * cols;
  for (int i = tid; i < nr * cols; i += NT)
    if (s_hit[i / cols]) out[i] = s_acc[i];
  unsigned* in_word = rows_in + static_cast<long long>(j >> 5) * n_rows + r0;
  for (int r = tid; r < nr; r += NT)
    if (s_hit[r]) atomicOr(in_word + r, 1u << (j & 31));
}

// the word kernel, the range stage where the rule takes word masks: one
// CTA a (32-row word, range of tiles): the range's row masks
// staged in smem, the word's rows present there dealt to the warps in turn;
// a warp folds its row's tile partials in tile order. Above SMALL_COLS
// columns lanes hold columns and BATCH partials are in flight across the
// range's groups of 32 tiles; at SMALL_COLS or fewer lanes hold tiles,
// GROUPS groups' partials are loaded at once and folded by shuffles
template <bool SMALL>
__global__ void __launch_bounds__(WORD_THREADS, 12)
gather_bwd_word_kernel(const float* __restrict__ part, const uint2* __restrict__ meta,
                        int cols, long long n_tiles, long long cap, int n_rows, int n_words,
                        int range_tiles, float* __restrict__ rp, unsigned* __restrict__ rows_in) {
  constexpr int NT = WORD_THREADS, RW = NT / 32;
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
constexpr int RANGE_SMEM = static_cast<int>(
    (BAND_WORDS + 1 + 2 * RANGE_WARPS * RANGE_THREADS + 2 * CHUNK + 2 * MAX_RANGE_TILES + 1) *
    4);
constexpr int MAX_DEVICES = 64;

// the stage, the key arrays and a band pass 48 KB: opt in once per device
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
  for (const auto kernel : {gather_bwd_range_kernel<0>, gather_bwd_range_kernel<1>,
                            gather_bwd_range_kernel<3>, gather_bwd_range_kernel<4>})
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RANGE_SMEM);
  if (e == cudaSuccess && known) done[dev].store(true, std::memory_order_release);
  return e;
}

long long round4(long long x) { return (x + 3) & ~3LL; }

}  // namespace

extern "C" {

// Scratch floats the launch needs for n lanes of n_cols onto n_rows rows
// (the wrapper's `bwd_scratch_floats`): the tile partials, the tiles'
// records (word masks, or row lists and row counts, by `word_masks`), the
// range partials and each row's mask of ranges, each 16-byte aligned.
long long shade_gather_bwd_scratch(int n_cols, long long n, int n_rows) {
  const long long n_tiles = (n + TILE - 1) / TILE;
  const long long rt = range_tiles(n_tiles), n_ranges = (n_tiles + rt - 1) / rt;
  const long long cap = TILE < n_rows ? TILE : n_rows;
  const long long record = word_masks(n_rows, n_cols)
                               ? round4(2 * n_tiles * cdiv(n_rows, 32))
                               : round4(n_tiles * cap) + round4(n_tiles);
  return round4(n_tiles * cap * n_cols) + record + round4(n_ranges * n_rows * n_cols) +
         round4((n_ranges + 31) / 32 * n_rows);
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
  const long long n_tiles = (n + TILE - 1) / TILE;
  const long long rt = range_tiles(n_tiles), n_ranges = (n_tiles + rt - 1) / rt;
  const long long cap = TILE < n_rows ? TILE : n_rows;
  const bool masks = word_masks(n_rows, n_cols);
  const long long n_words = masks ? cdiv(n_rows, 32) : 0;
  float* part = scratch;
  float* record = part + round4(n_tiles * cap * n_cols);
  uint2* meta = reinterpret_cast<uint2*>(record);                 // word masks, or
  int* rows_of = reinterpret_cast<int*>(record);                  // row lists and counts
  int* nseg = rows_of + round4(n_tiles * cap);
  float* rp = record + (masks ? round4(2 * n_tiles * n_words)
                              : round4(n_tiles * cap) + round4(n_tiles));
  unsigned* rows_in = reinterpret_cast<unsigned*>(rp + round4(n_ranges * n_rows * n_cols));
  cudaError_t e = allow_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n_rows_in = (n_ranges + 31) / 32 * n_rows;
  if (n_tiles > 0) {
    const unsigned tiles = static_cast<unsigned>(n_tiles);
    const int smem = tile_smem(n_cols) + (n_rows <= SMALL_ROWS ? HIST_BYTES : 0);
    const unsigned wt_ctas = static_cast<unsigned>(cdiv(n_tiles, WT_WARPS));
    if (!masks && n_cols <= WARP_COLS) {      // past the rule a table has more than SMALL_ROWS rows
      const auto kernel = n_cols == 1   ? gather_bwd_warp_tile_kernel<1>
                          : n_cols == 2 ? gather_bwd_warp_tile_kernel<2>
                          : n_cols == 3 ? gather_bwd_warp_tile_kernel<3>
                                        : gather_bwd_warp_tile_kernel<4>;
      kernel<<<wt_ctas, WT_WARPS * 32, 0, st>>>(g, idx, n, n_rows, part, rows_of, nseg, rows_in,
                                                 n_rows_in);
    } else if (n_cols > 32) {
      gather_bwd_tile_kernel<true><<<tiles, TILE, smem, st>>>(
          g, n_cols, idx, n, n_rows, static_cast<int>(n_words), part, meta, rows_of, nseg,
          rows_in, n_rows_in);
    } else {
      gather_bwd_tile_kernel<false><<<tiles, TILE, smem, st>>>(
          g, n_cols, idx, n, n_rows, static_cast<int>(n_words), part, meta, rows_of, nseg,
          rows_in, n_rows_in);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    if (masks) {
      const size_t meta_smem = ((rt + 31) / 32) * 32 * sizeof(uint2);
      const dim3 grid(static_cast<unsigned>(n_words), static_cast<unsigned>(n_ranges));
      if (n_cols <= SMALL_COLS) {
        gather_bwd_word_kernel<true><<<grid, WORD_THREADS, meta_smem, st>>>(
            part, meta, n_cols, n_tiles, cap, n_rows, static_cast<int>(n_words),
            static_cast<int>(rt), rp, rows_in);
      } else {
        gather_bwd_word_kernel<false><<<grid, WORD_THREADS, meta_smem, st>>>(
            part, meta, n_cols, n_tiles, cap, n_rows, static_cast<int>(n_words),
            static_cast<int>(rt), rp, rows_in);
      }
    } else {
      const Bands bd = bands(n_ranges, n_rows, n_cols);
      const dim3 grid(static_cast<unsigned>(bd.n), static_cast<unsigned>(n_ranges));
      const auto range_kernel = n_cols == 1   ? gather_bwd_range_kernel<1>
                                : n_cols == 3 ? gather_bwd_range_kernel<3>
                                : n_cols == 4 ? gather_bwd_range_kernel<4>
                                              : gather_bwd_range_kernel<0>;
      range_kernel<<<grid, RANGE_THREADS,
                     static_cast<size_t>(range_smem(bd.rows, n_cols, rt)), st>>>(
          part, rows_of, nseg, n_cols, n_tiles, cap, n_rows, static_cast<int>(bd.rows),
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
