// The strong NCC of one (pixel, source view) pair, shared by K2 (ncc.cu,
// one plane a launch) and K5 (sweep.cu, a disparity sweep a launch), so the
// two cannot drift apart: the plane homography (geometry.homography), the
// warp of the centre and of the window taps (geometry.warp), K1's bilinear
// sample (csrc/sampler.cu), the three window sums with Kahan compensation
// in tap order, and cost.ncc_from_sums.
//
// Every product, sum, quotient and square root is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn: no FMA
// contraction), in the order the torch ops of the plain versions evaluate
// them, so each kernel equals its plain version bit for bit.
//
// NaN: a plane with w = 0 (or NaN / inf components) warps to NaN
// coordinates. The clamp is written with comparisons, which keep NaN
// (fminf / fmaxf would drop it and return a finite, wrong sample); the row
// index goes through __float2int_rz (NaN -> 0) and an integer clamp, so no
// coordinate reads outside its table. The NaN sample makes the sums and the
// cost NaN, and a non-finite cost is COST_MAX.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace apde {

constexpr int kLanes = 32;        // pixels of a block, one per lane
constexpr int kMaxViews = 32;     // source views, one warp each
// a view's row of the camera table: R_rel (9, row-major), t_rel (3), fx,
// fy, cx, cy; the reference's row holds its fx, fy, cx, cy at 12..15
constexpr int kCamStride = 16;
constexpr float kCostMax = 2.f;   // cost.COST_MAX
constexpr float kMinVar = 1e-5f;  // cost.MIN_VAR, compared in float32

// every operation rounded on its own: no FMA contraction
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float dvd(float a, float b) {
  return __fdiv_rn(a, b);
}

// torch.clamp written with comparisons: NaN stays NaN
__device__ __forceinline__ float clamp_keep_nan(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float clamp_min_keep_nan(float v, float lo) {
  return v < lo ? lo : v;
}

__device__ __forceinline__ int clamp_int(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__device__ __forceinline__ float4 load_row(const uint8_t* __restrict__ tab,
                                           int64_t row) {
  const uchar4 q = __ldg(reinterpret_cast<const uchar4*>(tab) + row);
  return make_float4(q.x, q.y, q.z, q.w);
}

__device__ __forceinline__ float4 load_row(const float* __restrict__ tab,
                                           int64_t row) {
  return __ldg(reinterpret_cast<const float4*>(tab) + row);
}

// K1's sample (csrc/sampler.cu): clamp, floor, one quad row, lerp.
template <typename Q>
__device__ __forceinline__ float sample(const Q* __restrict__ tab,
                                        int64_t view_row0, float x, float y,
                                        int width, int height) {
  x = clamp_keep_nan(x, 0.f, width - 1.f);
  y = clamp_keep_nan(y, 0.f, height - 1.f);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const int xi = clamp_int(__float2int_rz(x0), width - 1);
  const int yi = clamp_int(__float2int_rz(y0), height - 1);
  const float4 v =
      load_row(tab, view_row0 + static_cast<int64_t>(yi) * width + xi);
  const float fx = sub(x, x0);
  const float fy = sub(y, y0);
  const float gx = sub(1.f, fx);
  const float gy = sub(1.f, fy);
  const float top = add(mul(v.x, gx), mul(v.y, fx));
  const float bot = add(mul(v.z, gx), mul(v.w, fx));
  return add(mul(top, gy), mul(bot, fy));
}

// one compensated (Kahan) step: the plain version's four elementwise ops
__device__ __forceinline__ void kahan_add(float& sum, float& comp,
                                          float term) {
  const float y = sub(term, comp);
  const float total = add(sum, y);
  comp = sub(sub(total, sum), y);
  sum = total;
}

// (a * x + b * y) + c, as geometry.warp writes each row
__device__ __forceinline__ float row_dot(float a, float b, float c, float x,
                                         float y) {
  return add(add(mul(a, x), mul(b, y)), c);
}

// shared-memory row stride of a pixel's window: odd, so the 32 lanes
// reading tap t of their own pixels hit 32 distinct banks
__host__ __device__ inline int window_stride(int num_taps) {
  return num_taps | 1;
}

// The plane-induced homography K_src (R_rel - t_rel n^T / w) K_ref^-1 of
// geometry.homography, from a view's camera row ``c`` and the reference's
// row ``r`` of the camera table.
__device__ __forceinline__ void plane_homography(const float* c,
                                                 const float* r, float n0,
                                                 float n1, float n2, float w,
                                                 float h[3][3]) {
  const float nw[3] = {dvd(n0, w), dvd(n1, w), dvd(n2, w)};
  const float fx_r = r[12], fy_r = r[13], cx_r = r[14], cy_r = r[15];
  const float fx_s = c[12], fy_s = c[13], cx_s = c[14], cy_s = c[15];
  float mk[3][3];  // (R_rel - t_rel n^T / w) K_ref^-1
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float ti = c[9 + i];
    const float m0 = sub(c[3 * i + 0], mul(ti, nw[0]));
    const float m1 = sub(c[3 * i + 1], mul(ti, nw[1]));
    const float m2 = sub(c[3 * i + 2], mul(ti, nw[2]));
    const float col0 = dvd(m0, fx_r);
    const float col1 = dvd(m1, fy_r);
    mk[i][0] = col0;
    mk[i][1] = col1;
    mk[i][2] = sub(sub(m2, mul(col0, cx_r)), mul(col1, cy_r));
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    h[0][j] = add(mul(fx_s, mk[0][j]), mul(cx_s, mk[2][j]));
    h[1][j] = add(mul(fy_s, mk[1][j]), mul(cy_s, mk[2][j]));
    h[2][j] = mk[2][j];
  }
}

// A pixel's reference window as one thread reads it: tap offsets (shared by
// every pixel, or the pixel's own), tap values, tap weights (kWeighted),
// and the reference-side sums with 1 / wsum and the empty-window flag.
struct PixelWindow {
  const float* dx;
  const float* dy;
  const float* val;
  const float* tw;
  float sum_ref;
  float sum_rr;
  float inv;
  bool empty;
};

// The strong NCC cost of one (pixel, view): the centre's out-of-image test
// against the real bounds, the warped taps sampled from the view's quad
// table, the compensated sums in tap order, cost.ncc_from_sums; COST_MAX
// where the centre leaves the image, a variance or the window is
// degenerate, or the cost is not finite.
template <typename Q, bool kWeighted>
__device__ __forceinline__ float window_ncc(
    const Q* __restrict__ tab, int64_t view_row0, const float (&h)[3][3],
    float x, float y, int num_taps, const PixelWindow& win, int width,
    int quad_h, float img_w, float img_h) {
  const float pz = row_dot(h[2][0], h[2][1], h[2][2], x, y);
  const float cx = dvd(row_dot(h[0][0], h[0][1], h[0][2], x, y), pz);
  const float cy = dvd(row_dot(h[1][0], h[1][1], h[1][2], x, y), pz);
  const bool oob = cx < 0.f || cx >= img_w || cy < 0.f || cy >= img_h;

  float s_src = 0.f, s_ss = 0.f, s_rs = 0.f;
  float c_src = 0.f, c_ss = 0.f, c_rs = 0.f;
  for (int t = 0; t < num_taps; ++t) {
    const float tx = add(x, win.dx[t]);
    const float ty = add(y, win.dy[t]);
    const float tz = row_dot(h[2][0], h[2][1], h[2][2], tx, ty);
    const float wx = dvd(row_dot(h[0][0], h[0][1], h[0][2], tx, ty), tz);
    const float wy = dvd(row_dot(h[1][0], h[1][1], h[1][2], tx, ty), tz);
    const float sv = sample(tab, view_row0, wx, wy, width, quad_h);
    if (kWeighted) {
      const float tw = win.tw[t];
      const float wsv = mul(tw, sv);
      kahan_add(s_src, c_src, wsv);
      kahan_add(s_ss, c_ss, mul(wsv, sv));
      kahan_add(s_rs, c_rs, mul(mul(tw, win.val[t]), sv));
    } else {
      kahan_add(s_src, c_src, sv);
      kahan_add(s_ss, c_ss, mul(sv, sv));
      kahan_add(s_rs, c_rs, mul(win.val[t], sv));
    }
  }

  // cost.ncc_from_sums
  const float m_ref = mul(win.sum_ref, win.inv);
  const float m_rr = mul(win.sum_rr, win.inv);
  const float m_src = mul(s_src, win.inv);
  const float m_ss = mul(s_ss, win.inv);
  const float m_rs = mul(s_rs, win.inv);
  const float var_ref = sub(m_rr, mul(m_ref, m_ref));
  const float var_src = sub(m_ss, mul(m_src, m_src));
  const float covar = sub(m_rs, mul(m_ref, m_src));
  const float denom =
      __fsqrt_rn(clamp_min_keep_nan(mul(var_ref, var_src), 1e-30f));
  const float cost =
      clamp_keep_nan(sub(1.f, dvd(covar, denom)), 0.f, kCostMax);
  const bool degenerate = var_ref < kMinVar || var_src < kMinVar ||
                          !isfinite(cost) || win.empty;
  return (oob || degenerate) ? kCostMax : cost;
}

// torch.where(wsum <= 0, 0, 1 / clamp(wsum, min=1e-20)) and wsum <= 0, of
// cost.ncc_from_sums for a tensor of weight sums
__device__ __forceinline__ void inverse_weight_sum(float ws, float* inv,
                                                   bool* empty) {
  *empty = ws <= 0.f;
  *inv = ws <= 0.f ? 0.f : dvd(1.f, clamp_min_keep_nan(ws, 1e-20f));
}

}  // namespace apde
