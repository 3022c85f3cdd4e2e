// Delta (Woodcock) tracking's trips for Hopper (sm_90a): the loop of
// scene/media.py `delta_track` over volumes whose modes are all 'scalar'
// (one shared scalar density grid) or 'const', one thread a lane.
//
// Replaces no TPU kernel: the JAX package runs the trips as a while loop in
// XLA (cudatracerlib_tpu/scene/media.py `sample_distance`). The port's eager
// loop runs ~115 full-batch kernels over int64 sampler words and corner
// stacks a trip, in blocks of 8 trips with a host read before each block:
// 11,202 launches and 18 host reads over a 1024^2 plume pass's 6 calls.
//
// The batch loop's trip k draws two numbers for every lane, at its start
// state + (2k + 1) G and + (2k + 2) G (G the Weyl step 0x9E3779B9), and a
// lane that has stopped ignores them. So a lane's draws depend only on its
// own start state and trip index, and a thread can run all of a lane's trips
// in registers while it tracks, up to HARD_TRACK_CAP. Each trip repeats
// `_track`'s operations in order, bit for bit: the uint32 `pcg_hash` and its
// top 24 bits x 2^-24; dt = -logf(max(1 - u, 1e-12)) / maj (PyTorch's log
// is logf); t_new; the escape test t_new >= u_far; the point o + d t_new;
// sigma_t summed over the volumes in mode order (a 'scalar' volume: the box
// test of `_inside_v`, then base sigma_t x csrc/trilinear.cuh's lookup; a
// 'const' one: its base sigma_t where inside); the channel mean as
// PyTorch's CUDA `mean(-1)` reduces three floats, ((a0 + a2) + a1) x
// factor, factor = float(B) / float(3 B) as its reduction computes it; then
// clamp(mean / maj, 0, 1) and u2 < ratio. Every float operation is
// __fmul_rn / __fadd_rn / __fdiv_rn, so nothing contracts into an FMA.
//
// T: a lane's count is the number of trips it began while tracking, and T is
// the largest over the lanes, which equals the batch loop's
// `trips += tracking.any()`. Each block reduces its lanes' counts and does
// one atomicMax on the int64 output; the caller sets the sampler to its start
// plus 2 T draws. No host read.
//
// What bounds it on the H100: a trip is ~170 operations (two hashes, dt,
// the point, the box test, the cell and its corner rows, 7 lerps, the mean
// and the test; chip_smoke.py TRACK_TRIP_OPS) and, for a 'scalar' volume, 8
// grid loads at a scattered cell; a lane moves 45 bytes in and 5 out. A
// lane takes ~1.2 trips on average where T is ~12, so the bytes bound it:
// 0.031 ms at the plume pass's 2,097,152 lanes. What costs is the loads'
// latency and the warps' divergence (a warp runs until its slowest lane
// stops). The grid range of the 'scalar' volumes is staged in shared memory
// once a block where it fits (the plume's 32^3 floats are 128 KB), and
// persistent blocks of 1,024 threads, one a SM, walk the lanes with a
// grid-stride loop, as csrc/transmittance.cu does; a range that does not fit
// is read through the read-only path. Measured (NVIDIA H100 80GB HBM3, 700
// W): 0.142 ms on that pass's first call, against the eager loop's 33.4.
//
// Plain C interface for ctypes. The mode tuple's per-volume numbers come in
// host arrays and reach the kernel as a parameter. Launches go on the
// caller's stream; the function returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cmath>

#include "trilinear.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int STAGED_BLOCK = 1024;  // the staged kernel's block, one a SM
constexpr int MAX_VOLUMES = 16;     // scene/media.py MAX_VOLUMES
constexpr int HARD_TRACK_CAP = 256;  // scene/media.py HARD_TRACK_CAP
constexpr unsigned GOLDEN = 0x9E3779B9u;  // sampling/rng.py _GOLDEN

struct Table {
  int n;                        // volumes
  int scalar[MAX_VOLUMES];      // 1: a 'scalar' grid lookup; 0: 'const'
  int off[MAX_VOLUMES];         // a 'scalar' grid's first row
  int r[MAX_VOLUMES][3];        // its resolution
  float qmax[MAX_VOLUMES][3];   // max(r - 1, 0) * (1 - 1e-6), rounded as the eager path
  int stage_lo, stage_n;        // the rows staged in shared memory (0 rows: none)
};

struct Fields {
  const float* box_min;  // (V, 3)
  const float* box_max;
  const int* active;     // (V,)
  const float* sigma_a;  // (V, 3)
  const float* sigma_s;
  const float* grid;     // the flat grid buffer
};

// sampling/rng.py: next_1d's number for a state already stepped by G
__device__ __forceinline__ float unit_draw(unsigned s) {
  const unsigned state = s * 747796405u + 2891336453u;
  const unsigned word = ((state >> ((state >> 28u) + 4u)) ^ state) * 277803737u;
  return __fmul_rn(static_cast<float>(((word >> 22u) ^ word) >> 8u), 1.0f / 16777216.0f);
}

// STAGED: the block first copies the grid rows [stage_lo, stage_lo +
// stage_n) into shared memory and walks the lanes with a grid-stride loop
// (one block of STAGED_BLOCK a SM); otherwise a thread a lane reads the
// corners through the read-only path
template <bool STAGED>
__global__ void __launch_bounds__(STAGED ? STAGED_BLOCK : BLOCK)
delta_track_kernel(Table tab, Fields f, const float* __restrict__ o,
                   const float* __restrict__ d, const float* __restrict__ u_near,
                   const float* __restrict__ u_far, const float* __restrict__ maj,
                   const unsigned char* __restrict__ in_vol,
                   const long long* __restrict__ state, long long n, float factor,
                   float* __restrict__ t_out, unsigned char* __restrict__ real_out,
                   unsigned long long* __restrict__ trips_out) {
  extern __shared__ float cells[];
  // the volume table, read at every trip
  __shared__ float lo[MAX_VOLUMES][3], hi[MAX_VOLUMES][3], base_t[MAX_VOLUMES][3];
  __shared__ float qmax[MAX_VOLUMES][3];
  __shared__ int res[MAX_VOLUMES][3], off[MAX_VOLUMES], looks_up[MAX_VOLUMES];
  __shared__ int warp_max[STAGED_BLOCK / 32];
  if (STAGED)
    for (int k = threadIdx.x; k < tab.stage_n; k += blockDim.x)
      cells[k] = __ldg(f.grid + tab.stage_lo + k);
  for (int k = threadIdx.x; k < 3 * tab.n; k += blockDim.x) {
    const int v = k / 3, c = k % 3;
    lo[v][c] = f.box_min[k];
    hi[v][c] = f.box_max[k];
    base_t[v][c] = __fadd_rn(f.sigma_s[k], f.sigma_a[k]);  // `_sigma_pair_v`'s base_t
    qmax[v][c] = tab.qmax[v][c];
    res[v][c] = tab.r[v][c];
    if (c == 0) {
      off[v] = tab.off[v];
      // an inactive volume adds nothing: `_inside_v` tests `active > 0`
      looks_up[v] = f.active[v] > 0 ? (tab.scalar[v] ? 1 : 0) : -1;
    }
  }
  __syncthreads();

  int most = 0;  // the largest trip count of this thread's lanes
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float t = u_near[i];
    bool real = false;
    int trips = 0;
    if (in_vol[i]) {
      float ro[3], rd[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        ro[c] = o[3 * i + c];
        rd[c] = d[3 * i + c];
      }
      const float far = u_far[i], m = maj[i];
      unsigned s = static_cast<unsigned>(state[i]);
      while (trips < HARD_TRACK_CAP) {
        ++trips;
        s += GOLDEN;
        const float u = unit_draw(s);
        const float dt = __fdiv_rn(-logf(fmaxf(__fsub_rn(1.0f, u), 1e-12f)), m);
        const float t_new = __fadd_rn(t, dt);
        if (t_new >= far) break;  // escaped: t stays
        float p[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) p[c] = __fadd_rn(ro[c], __fmul_rn(rd[c], t_new));
        float st[3] = {0.0f, 0.0f, 0.0f};
        for (int v = 0; v < tab.n; ++v) {
          const bool inside = looks_up[v] >= 0 && p[0] >= lo[v][0] && p[0] <= hi[v][0] &&
                              p[1] >= lo[v][1] && p[1] <= hi[v][1] && p[2] >= lo[v][2] &&
                              p[2] <= hi[v][2];
          if (!inside) continue;  // where(ins, ..., 0): + 0 leaves st as it is
          if (looks_up[v]) {
            const trilinear::Cell cl = trilinear::cell_at(lo[v], hi[v], off[v], res[v], qmax[v], p);
            float corner[8];
#pragma unroll
            for (int k = 0; k < 8; ++k)
              corner[k] = STAGED ? cells[cl.row[k] - tab.stage_lo] : __ldg(f.grid + cl.row[k]);
            const float D = trilinear::interpolate(corner, cl.f);
#pragma unroll
            for (int c = 0; c < 3; ++c) st[c] = __fadd_rn(st[c], __fmul_rn(base_t[v][c], D));
          } else {
#pragma unroll
            for (int c = 0; c < 3; ++c) st[c] = __fadd_rn(st[c], base_t[v][c]);
          }
        }
        const float mean = __fmul_rn(__fadd_rn(__fadd_rn(st[0], st[2]), st[1]), factor);
        const float ratio = fminf(fmaxf(__fdiv_rn(mean, m), 0.0f), 1.0f);
        s += GOLDEN;
        t = t_new;
        if (unit_draw(s) < ratio) {
          real = true;
          break;
        }
      }
    }
    t_out[i] = t;
    real_out[i] = real;
    most = max(most, trips);
  }

  // T: the block's largest count, one atomicMax a block
  most = __reduce_max_sync(0xffffffffu, most);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = most;
  __syncthreads();
  if (threadIdx.x < 32) {
    most = threadIdx.x < blockDim.x / 32 ? warp_max[threadIdx.x] : 0;
    most = __reduce_max_sync(0xffffffffu, most);
    if (threadIdx.x == 0 && most > 0)
      atomicMax(trips_out, static_cast<unsigned long long>(most));
  }
}

}  // namespace

extern "C" int delta_track_launch(const float* o, const float* d, const float* u_near,
                                  const float* u_far, const float* maj,
                                  const unsigned char* in_vol, const long long* state,
                                  long long n, float factor, const float* box_min,
                                  const float* box_max, const int* active,
                                  const float* sigma_a, const float* sigma_s, const float* grid,
                                  int n_vol, const int* scalar, const int* off, const int* res,
                                  const float* qmax, int stage_lo, int stage_n, float* t_out,
                                  unsigned char* real_out, long long* trips_out, void* stream) {
  if (n_vol < 0 || n_vol > MAX_VOLUMES) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(trips_out, 0, sizeof(long long), s);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  Table tab;
  tab.n = n_vol;
  for (int v = 0; v < n_vol; ++v) {
    tab.scalar[v] = scalar[v];
    tab.off[v] = off[v];
    for (int c = 0; c < 3; ++c) {
      tab.r[v][c] = res[3 * v + c];
      tab.qmax[v][c] = qmax[3 * v + c];
    }
  }
  tab.stage_lo = stage_lo;
  tab.stage_n = 0;
  const Fields f{box_min, box_max, active, sigma_a, sigma_s, grid};
  unsigned long long* trips = reinterpret_cast<unsigned long long*>(trips_out);
  int dev = 0, sms = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t smem = sizeof(float) * static_cast<size_t>(stage_n);
  cudaFuncAttributes attr;  // the static shared arrays take their share of the opt-in limit
  cudaFuncGetAttributes(&attr, delta_track_kernel<true>);
  if (stage_n > 0 && smem + attr.sharedSizeBytes <= static_cast<size_t>(smem_max)) {
    tab.stage_n = stage_n;
    cudaFuncSetAttribute(delta_track_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    int per_sm = 1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, delta_track_kernel<true>,
                                                  STAGED_BLOCK, smem);
    const long long need = (n + STAGED_BLOCK - 1) / STAGED_BLOCK;
    const long long fill = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    delta_track_kernel<true><<<static_cast<unsigned>(need < fill ? need : fill), STAGED_BLOCK,
                               smem, s>>>(tab, f, o, d, u_near, u_far, maj, in_vol, state, n,
                                          factor, t_out, real_out, trips);
  } else {
    delta_track_kernel<false><<<static_cast<unsigned>((n + BLOCK - 1) / BLOCK), BLOCK, 0, s>>>(
        tab, f, o, d, u_near, u_far, maj, in_vol, state, n, factor, t_out, real_out, trips);
  }
  return static_cast<int>(cudaGetLastError());
}
