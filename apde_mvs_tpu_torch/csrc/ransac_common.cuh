// The RANSAC pieces shared by K8 (anchor generation) and K9 (fit-plane
// RANSAC) in anchors.cu, so the two cannot drift apart: the remainder that
// turns a raw draw into a rank, the n-th valid slot of a mask, the
// reference's point-in-triangle test, the unit plane through three
// camera-frame points and its distance to a point, and the camera-frame
// back-projection of a pixel at a depth.
//
// Each is written in the operation order of the plain versions in
// ops/anchors.py (`_point_in_triangle`, `_plane_from_triplet`,
// `_plane_dist`, `_dot3`, `_nth_valid`, `geometry.backproject`), every
// product, sum, quotient and square root rounded on its own
// (ncc_common.cuh's mul / add / sub / dvd, __fsqrt_rn: no FMA
// contraction), so each kernel equals its plain version bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ncc_common.cuh"

namespace apde {

// torch.remainder of an int32 by a positive divisor: the divisor's sign
__device__ __forceinline__ int py_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// _nth_valid: the index of the n-th (0-based) set bit of ``mask``; 0 where
// there is none
__device__ __forceinline__ int nth_valid(uint32_t mask, int n) {
  for (int i = 0; i < 32; ++i) {
    if ((mask >> i) & 1u) {
      if (n == 0) return i;
      --n;
    }
  }
  return 0;
}

// _dot3: (a0 b0 + a1 b1) + a2 b2
__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return add(add(mul(a[0], b[0]), mul(a[1], b[1])), mul(a[2], b[2]));
}

// geometry.backproject: (depth (x - cx) / fx, depth (y - cy) / fy, depth)
__device__ __forceinline__ void backproject(float fx, float fy, float cx,
                                            float cy, float x, float y,
                                            float depth, float out[3]) {
  out[0] = dvd(mul(depth, sub(x, cx)), fx);
  out[1] = dvd(mul(depth, sub(y, cy)), fy);
  out[2] = depth;   // depth * 1
}

// _point_in_triangle (reference PointinTriangle, APD.cu:122-143): every
// edge longer than 2 px, the triangle inequalities strict, then the
// same-side test of the three cross products
__device__ __forceinline__ bool point_in_triangle(float ax, float ay,
                                                  float bx, float by,
                                                  float cx, float cy,
                                                  float px, float py) {
  const float abx = sub(bx, ax), aby = sub(by, ay);
  const float bcx = sub(cx, bx), bcy = sub(cy, by);
  const float cax = sub(ax, cx), cay = sub(ay, cy);
  const float ab = __fsqrt_rn(add(mul(abx, abx), mul(aby, aby)));
  const float bc = __fsqrt_rn(add(mul(bcx, bcx), mul(bcy, bcy)));
  const float ca = __fsqrt_rn(add(mul(cax, cax), mul(cay, cay)));
  const bool ok = ab > 2.f && bc > 2.f && ca > 2.f && add(ab, bc) > ca &&
                  add(bc, ca) > ab && add(ab, ca) > bc;
  const float pax = sub(ax, px), pay = sub(ay, py);
  const float pbx = sub(bx, px), pby = sub(by, py);
  const float pcx = sub(cx, px), pcy = sub(cy, py);
  const float t1 = sub(mul(pax, pby), mul(pay, pbx));
  const float t2 = sub(mul(pbx, pcy), mul(pby, pcx));
  const float t3 = sub(mul(pcx, pay), mul(pcy, pax));
  return ok && mul(t1, t2) >= 0.f && mul(t1, t3) >= 0.f;
}

// _plane_from_triplet: the unit plane (n, w) through A, B, C (n = (A - C)
// x (B - C) in jnp.cross's component order, its length clamped below at
// 1e-20, w = -n . A); returns true where the plane is degenerate (length 0
// or not finite)
__device__ __forceinline__ bool plane_from_triplet(const float A[3],
                                                   const float B[3],
                                                   const float C[3],
                                                   float plane[4]) {
  const float u0 = sub(A[0], C[0]), u1 = sub(A[1], C[1]),
              u2 = sub(A[2], C[2]);
  const float v0 = sub(B[0], C[0]), v1 = sub(B[1], C[1]),
              v2 = sub(B[2], C[2]);
  float n[3] = {sub(mul(u1, v2), mul(u2, v1)), sub(mul(u2, v0), mul(u0, v2)),
                sub(mul(u0, v1), mul(u1, v0))};
  const float norm = __fsqrt_rn(dot3(n, n));
  const bool degenerate = norm == 0.f || !isfinite(norm);
  const float d = clamp_min_keep_nan(norm, 1e-20f);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    n[k] = dvd(n[k], d);
    plane[k] = n[k];
  }
  plane[3] = -dot3(n, A);
  return degenerate;
}

// _plane_dist: |n . p + w|
__device__ __forceinline__ float plane_dist(const float p[3],
                                            const float plane[4]) {
  return fabsf(add(dot3(p, plane), plane[3]));
}

}  // namespace apde
