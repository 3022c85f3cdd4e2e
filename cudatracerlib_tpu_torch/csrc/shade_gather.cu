// Shade-pack row gather for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cudatracerlib_tpu/ops/shade_gather.py:69
// `_gather_tpu` (pallas_call :80), the forward of `packed_gather` (:103):
// out[b, :] = table[clamp(idx[b], 0, Tr - 1), :], one (C,) row of per-triangle
// shading data per ray (C = 64 for the shade pack, scene/shade_pack.py).
//
// The TPU kernel gathers through the MXU as a one-hot matrix product over a
// bf16 hi/lo split of the table (about 17 mantissa bits), because a dynamic
// per-lane gather is slow there. On the H100 a gather is a load, so this
// kernel copies rows and is exact: the output equals the table's rows bit
// for bit, and there is no split.
//
// Layout: row-major (B, C) output, so `cols` hands out column views; the
// JAX package's column-major (C, B) layout existed for the TPU's (8, 128)
// tiling. What bounds it on the H100: bytes, B * C * 4 written plus the
// rows read (the table, 1.7 MB for glossy, stays in the 50 MB L2 cache) and
// the indices; no arithmetic. The design moves them in full sectors:
// C / 4 consecutive threads share one row, each moving one float4, so a
// warp reads two whole 256-byte rows and writes 512 contiguous bytes.
//
// Plain C interface for ctypes; the launch goes on the caller's stream and
// the function returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;

__global__ void __launch_bounds__(BLOCK)
gather_kernel(const float4* __restrict__ table, int n_rows, int c4,
              const int* __restrict__ idx, long long n_out, float4* __restrict__ out) {
  const long long k = static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
  if (k >= n_out) return;
  const long long b = k / c4;
  const int c = static_cast<int>(k - b * c4);
  const int r = min(max(__ldg(idx + b), 0), n_rows - 1);
  out[k] = __ldg(table + static_cast<long long>(r) * c4 + c);
}

}  // namespace

extern "C" int shade_gather_launch(const float* table, int n_rows, int n_cols,
                                   const int* idx, int n_idx, float* out, void* stream) {
  const long long n_out = static_cast<long long>(n_idx) * (n_cols / 4);
  if (n_out > 0) {
    const long long grid = (n_out + BLOCK - 1) / BLOCK;
    gather_kernel<<<static_cast<unsigned>(grid), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(table), n_rows, n_cols / 4, idx, n_out,
        reinterpret_cast<float4*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
