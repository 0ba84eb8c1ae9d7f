// K4 — the geometric-consistency cost of one (pixel, source view) for a
// plane, `cost.geom_cost` (apde_mvs_tpu/ops/cost.py:400-418; the CUDA
// reference is APD.cu:865-902), shared by K5 (sweep.cu, the disparity
// sweeps) and K3 (strong.cu, the strong sweep's colour update), so the two
// cannot drift apart: the depth the plane induces at the pixel, its
// back-projection to the world, its projection into the source view, the
// source depth at the truncated texel (`sampling.trunc_index`'s
// saturation), back-projection and projection into the reference, the
// reprojection distance clamped at 3; 3 for a missing source depth or a
// non-finite result. Every operation is rounded on its own, in the order
// of the torch ops of `cost.geom_cost` (ncc_common.cuh's mul / add / sub /
// dvd), so both kernels equal their plain versions bit for bit.
//
// The columns it reads are the 24 after K2's 16 in a view's row of the
// 40-column camera table (`ops/cuda/sweep.camera_table`): R (9, row-major),
// t (3), K (9, row-major), world centre c (3); row S is the reference's.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "ncc_common.cuh"

namespace apde {

// a view's row of the camera table K5 and K3 read: K2's kCamStride columns,
// then the geometric columns
constexpr int kGeomCamStride = 40;
constexpr int kGeomCols = kCamStride;
constexpr float kGeomCostMax = 3.f;   // cost.GEOM_COST_MAX

// geometry.backproject_world: camera-frame point (depth (x - cx) / fx,
// depth (y - cy) / fy, depth), then R^T X + c, each row summed in order
__device__ __forceinline__ void backproject_world(const float* R,
                                                  const float* K,
                                                  const float* c, float x,
                                                  float y, float depth,
                                                  float out[3]) {
  const float X = dvd(mul(depth, sub(x, K[2])), K[0]);
  const float Y = dvd(mul(depth, sub(y, K[5])), K[4]);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    out[j] = add(add(add(mul(R[j], X), mul(R[3 + j], Y)),
                     mul(R[6 + j], depth)),
                 c[j]);
  }
}

// geometry.project: (R X + t), then K (.), then u / w and v / w; the full
// 3x3 products, zero-skew entries included, as the torch ops take them
__device__ __forceinline__ void project(const float* R, const float* t,
                                        const float* K, const float X[3],
                                        float* u, float* v) {
  float xc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    xc[i] = add(add(add(mul(R[3 * i], X[0]), mul(R[3 * i + 1], X[1])),
                    mul(R[3 * i + 2], X[2])),
                t[i]);
  }
  float uvw[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    uvw[i] = add(add(mul(K[3 * i], xc[0]), mul(K[3 * i + 1], xc[1])),
                 mul(K[3 * i + 2], xc[2]));
  }
  *u = dvd(uvw[0], uvw[2]);
  *v = dvd(uvw[1], uvw[2]);
}

// sampling.trunc_index: NaN -> 0, saturate to [-1, size], truncate toward
// zero, clamp to [0, size - 1]
__device__ __forceinline__ int trunc_index(float v, int size) {
  v = isnan(v) ? 0.f : v;
  const float hi = static_cast<float>(size);
  v = v < -1.f ? -1.f : (v > hi ? hi : v);
  return clamp_int(static_cast<int>(v), size - 1);
}

// geometry.depth_from_plane: the depth the plane (n, w) induces at pixel
// (x, y) of the camera with focal lengths fx, fy and principal point cx, cy
__device__ __forceinline__ float plane_depth(float fx, float fy, float cx,
                                             float cy, float x, float y,
                                             float n0, float n1, float n2,
                                             float w) {
  const float denom =
      add(add(mul(sub(x, cx), n0), mul(mul(dvd(fx, fy), sub(y, cy)), n1)),
          mul(fx, n2));
  return dvd(mul(-w, fx), denom);
}

// K4: cost.geom_cost of one (pixel, view) for the plane (n, w). ``gr`` and
// ``gs`` are the reference's and the view's geometric columns (R, t, K, c).
__device__ __forceinline__ float geom_cost(const float* gr, const float* gs,
                                           const float* __restrict__ dmap,
                                           int dh, int dw, float x, float y,
                                           float n0, float n1, float n2,
                                           float w) {
  const float* Kr = gr + 12;
  const float depth =
      plane_depth(Kr[0], Kr[4], Kr[2], Kr[5], x, y, n0, n1, n2, w);
  float xw[3];
  backproject_world(gr, Kr, gr + 21, x, y, depth, xw);
  float sx, sy;
  project(gs, gs + 9, gs + 12, xw, &sx, &sy);
  // core.sampling.texel_fetch
  const float sd = __ldg(dmap + static_cast<int64_t>(trunc_index(sy, dh)) *
                                    dw + trunc_index(sx, dw));
  float xs[3];
  backproject_world(gs, gs + 12, gs + 21, sx, sy, sd, xs);
  float bx, by;
  project(gr, gr + 9, Kr, xs, &bx, &by);
  const float ex = sub(x, bx);
  const float ey = sub(y, by);
  const float dist = __fsqrt_rn(add(mul(ex, ex), mul(ey, ey)));
  const float cost = dist > kGeomCostMax ? kGeomCostMax : dist;
  return (sd == 0.f || !isfinite(cost)) ? kGeomCostMax : cost;
}

}  // namespace apde
