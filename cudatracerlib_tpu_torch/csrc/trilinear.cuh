// The trilinear lookup of a 'scalar' volume's grid, as scene/media.py
// `_grid_lookup1` and `_trilinear` compute it: the grid coordinate of a
// point, clamped, floored, its 8 corner rows in x, y, z order and the
// fractions; then the lerps in x, then y, then z. Every operation is
// __fsub_rn / __fdiv_rn / __fmul_rn / __fadd_rn in the eager path's order,
// so no FMA contraction moves a result. csrc/transmittance.cu (each of a
// segment's 32 midpoints) and csrc/delta_track.cu (each tracking trip's
// candidate point) both include it, so the two lookups cannot drift.

#pragma once

namespace trilinear {

struct Cell {
  int row[8];  // corners x, y, z
  float f[3];  // the lerp weights' fractions
};

// the cell of point p in the grid of box [lo, hi] at resolution r, whose
// first row is `off`; qmax = max(r - 1, 0) * (1 - 1e-6), rounded as the eager path
__device__ __forceinline__ Cell cell_at(const float* lo, const float* hi, int off, const int* r,
                                        const float* qmax, const float* p) {
  int i0[3], i1[3];
  Cell out;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float ext = fmaxf(__fsub_rn(hi[c], lo[c]), 1e-9f);
    float q = __fmul_rn(__fdiv_rn(__fsub_rn(p[c], lo[c]), ext),
                        __fsub_rn(static_cast<float>(r[c]), 1.0f));
    q = fminf(fmaxf(q, 0.0f), qmax[c]);
    const float fl = floorf(q);
    i0[c] = static_cast<int>(fl);
    i1[c] = min(i0[c] + 1, r[c] - 1);
    out.f[c] = __fsub_rn(q, fl);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int ix = (k & 4) ? i1[0] : i0[0];
    const int iy = (k & 2) ? i1[1] : i0[1];
    const int iz = (k & 1) ? i1[2] : i0[2];
    out.row[k] = off + (ix * r[1] + iy) * r[2] + iz;
  }
  return out;
}

__device__ __forceinline__ float lerp(float a, float b, float t) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, t)), __fmul_rn(b, t));
}

// the interpolated value of a cell's 8 corners (x, y, z order)
__device__ __forceinline__ float interpolate(const float* corner, const float* f) {
  float x[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)  // x lerps: (y, z) = k
    x[k] = lerp(corner[k], corner[4 + k], f[0]);
  const float y0 = lerp(x[0], x[2], f[1]);
  const float y1 = lerp(x[1], x[3], f[1]);
  return lerp(y0, y1, f[2]);
}

}  // namespace trilinear
