// The watertight ray / triangle edge test (Woop, Benthin and Wald, "Watertight
// Ray/Triangle Intersection", JCGT 2(1), 2013), shared by intersect_dense.cu
// and intersect_bvh.cu. Its plain version is accel/traversal.py `_shear`,
// `_edge_functions` and `_watertight`; every operation is written with
// __fmul_rn / __fadd_rn / __fsub_rn in the plain version's order, so no FMA
// contraction changes a value and every decision equals the plain version's.
//
// Per ray: kz is the axis of the largest |d| component (the first on a tie),
// kx and ky the next two in cyclic order, swapped when d[kz] < 0; the shear
// rows cx, cy hold 1 at kx (ky), -d[kx] / d[kz] (-d[ky] / d[kz]) at kz and 0
// at the third axis. Per triangle: each vertex is translated by -o and
// sheared, x = (cx0 a0 + cx1 a1) + cx2 a2, y likewise, and the edge
// functions are U = Cx By - Cy Bx, V = Ax Cy - Ay Cx, W = Bx Ay - By Ax.
// A float32 edge function that is not zero has the exact sign (each product
// is rounded the same way); one that is zero is recomputed in float64, where
// the products are exact. Two triangles that share an edge share its
// sheared vertices, so the edge's function is the same number in both or its
// exact negative, and a ray that crosses the edge is inside one of them.
// Inside: no two signs opposite, not all three zero (a triangle seen edge-on).
#pragma once

#include <cuda_runtime.h>

// ((a0 b0 + a1 b1) + a2 b2), each operation rounded on its own
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1,
                                      float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

// the sign of a float64 edge function as float32 (NaN stays NaN, as torch.sign keeps it)
__device__ __forceinline__ float sign_of(double x) {
  return x > 0.0 ? 1.f : (x < 0.0 ? -1.f : (x == 0.0 ? 0.f : __int_as_float(0x7fc00000)));
}

struct Shear {
  float cx0, cx1, cx2, cy0, cy1, cy2;
};

__device__ __forceinline__ Shear make_shear(float dx, float dy, float dz) {
  const float ax = fabsf(dx), ay = fabsf(dy), az = fabsf(dz);
  const int kz = (ax >= ay && ax >= az) ? 0 : (ay >= az ? 1 : 2);
  int kx = kz == 2 ? 0 : kz + 1;
  int ky = kx == 2 ? 0 : kx + 1;
  const float d[3] = {dx, dy, dz};
  const float dkz = d[kz];
  if (dkz < 0.f) {
    const int k = kx;
    kx = ky;
    ky = k;
  }
  const float sx = d[kx] / dkz, sy = d[ky] / dkz;
  Shear s;
  s.cx0 = kx == 0 ? 1.f : (kz == 0 ? -sx : 0.f);
  s.cx1 = kx == 1 ? 1.f : (kz == 1 ? -sx : 0.f);
  s.cx2 = kx == 2 ? 1.f : (kz == 2 ? -sx : 0.f);
  s.cy0 = ky == 0 ? 1.f : (kz == 0 ? -sy : 0.f);
  s.cy1 = ky == 1 ? 1.f : (kz == 1 ? -sy : 0.f);
  s.cy2 = ky == 2 ? 1.f : (kz == 2 ? -sy : 0.f);
  return s;
}

// whether the ray (origin o, shear s) crosses the triangle of vertex row (p0, p1, p2)
__device__ __forceinline__ bool crosses(const Shear& s, float4 p0, float4 p1, float4 p2,
                                        float ox, float oy, float oz) {
  float a0 = __fsub_rn(p0.x, ox), a1 = __fsub_rn(p0.y, oy), a2 = __fsub_rn(p0.z, oz);
  const float Ax = dot3(s.cx0, s.cx1, s.cx2, a0, a1, a2);
  const float Ay = dot3(s.cy0, s.cy1, s.cy2, a0, a1, a2);
  a0 = __fsub_rn(p1.x, ox); a1 = __fsub_rn(p1.y, oy); a2 = __fsub_rn(p1.z, oz);
  const float Bx = dot3(s.cx0, s.cx1, s.cx2, a0, a1, a2);
  const float By = dot3(s.cy0, s.cy1, s.cy2, a0, a1, a2);
  a0 = __fsub_rn(p2.x, ox); a1 = __fsub_rn(p2.y, oy); a2 = __fsub_rn(p2.z, oz);
  const float Cx = dot3(s.cx0, s.cx1, s.cx2, a0, a1, a2);
  const float Cy = dot3(s.cy0, s.cy1, s.cy2, a0, a1, a2);
  float U = __fsub_rn(__fmul_rn(Cx, By), __fmul_rn(Cy, Bx));
  float V = __fsub_rn(__fmul_rn(Ax, Cy), __fmul_rn(Ay, Cx));
  float W = __fsub_rn(__fmul_rn(Bx, Ay), __fmul_rn(By, Ax));
  if (U == 0.f || V == 0.f || W == 0.f) {
    const double u = __dsub_rn(__dmul_rn(Cx, By), __dmul_rn(Cy, Bx));
    const double v = __dsub_rn(__dmul_rn(Ax, Cy), __dmul_rn(Ay, Cx));
    const double w = __dsub_rn(__dmul_rn(Bx, Ay), __dmul_rn(By, Ax));
    U = sign_of(u);
    V = sign_of(v);
    W = sign_of(w);
  }
  const bool inside = (U >= 0.f && V >= 0.f && W >= 0.f) || (U <= 0.f && V <= 0.f && W <= 0.f);
  return inside && (U != 0.f || V != 0.f || W != 0.f);
}
