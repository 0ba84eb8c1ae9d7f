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
// The per-tap path avoids the instructions that sm_90 issues at a fraction
// of its f32 rate, with results equal bit for bit:
// - a u8 texel becomes a float by placing its byte in the mantissa of 2^23
//   (one byte permute) and subtracting 2^23, exact for 0..255, in place of
//   an integer-to-float conversion;
// - the clamped coordinate v, in [0, size - 1] with size < 2^23, is
//   floored by a round-down add of 2^23: the sum is 2^23 + floor(v)
//   exactly, so subtracting 2^23 gives floor(v) as a float and the low
//   mantissa bits give it as an integer, in place of a rounding and a
//   float-to-integer conversion;
// - on the main path's 36-tap windows (cost.square_taps(5, 2), and
//   cost.star_taps, which SA mixing pairs only with that square) the tap
//   loop has a compile-time trip count, unrolled by four, so four taps'
//   gathers are in flight while the Kahan steps run in tap order.
// The two divisions of a tap's warp stay IEEE (__fdiv_rn): a reciprocal
// would round differently from the plain versions.
//
// NaN: a plane with w = 0 (or NaN / inf components) warps to NaN
// coordinates. The clamp is written with comparisons, which keep NaN
// (fminf / fmaxf would drop it and return a finite, wrong sample); a NaN
// coordinate's round-down sum is NaN, whose bits give an index that the
// unsigned clamp puts inside the table, so no coordinate reads outside its
// table. The NaN fraction makes the sample, the sums and the cost NaN, and
// a non-finite cost is COST_MAX.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace apde {

constexpr int kMaxViews = 32;     // source views: one warp's lanes
// a view's row of the camera table: R_rel (9, row-major), t_rel (3), fx,
// fy, cx, cy; the reference's row holds its fx, fy, cx, cy at 12..15
constexpr int kCamStride = 16;
constexpr float kCostMax = 2.f;   // cost.COST_MAX
constexpr float kMinVar = 1e-5f;  // cost.MIN_VAR, compared in float32
constexpr int kMainTaps = 36;     // the main path's windows
constexpr float kTwo23 = 8388608.f;
constexpr uint32_t kTwo23Bits = 0x4B000000u;

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

// a byte of ``word`` as a float: 0x4B0000bb is 2^23 + bb
template <int kByte>
__device__ __forceinline__ float byte_to_float(uint32_t word) {
  return sub(__uint_as_float(__byte_perm(word, kTwo23Bits, 0x7440 | kByte)),
             kTwo23);
}

__device__ __forceinline__ float4 load_row(const uint8_t* __restrict__ tab,
                                           uint32_t row) {
  const uint32_t q = __ldg(reinterpret_cast<const unsigned int*>(tab) + row);
  return make_float4(byte_to_float<0>(q), byte_to_float<1>(q),
                     byte_to_float<2>(q), byte_to_float<3>(q));
}

__device__ __forceinline__ float4 load_row(const float* __restrict__ tab,
                                           uint32_t row) {
  return __ldg(reinterpret_cast<const float4*>(tab) + row);
}

// One coordinate of K1's sample: clamped to [0, size - 1] (NaN kept; -0
// taken as +0, whose floor and fraction K1's floorf gives for -0 too), its
// floor (2^23 + floor(v), exact) and the floor as an index, NaN's clamped.
struct Axis {
  float floor;
  float frac;
  uint32_t index;
};

__device__ __forceinline__ Axis axis(float v, int size) {
  v = v <= 0.f ? 0.f : (v > size - 1.f ? size - 1.f : v);
  const float shifted = __fadd_rd(v, kTwo23);
  Axis a;
  a.floor = sub(shifted, kTwo23);
  a.frac = sub(v, a.floor);
  a.index = min(__float_as_uint(shifted) - kTwo23Bits,
                static_cast<uint32_t>(size - 1));
  return a;
}

// K1's sample (csrc/sampler.cu) from one view's quad table: clamp, floor,
// one quad row, lerp.
template <typename Q>
__device__ __forceinline__ float sample(const Q* __restrict__ tab, float x,
                                        float y, int width, int height) {
  const Axis ax = axis(x, width);
  const Axis ay = axis(y, height);
  const float4 v = load_row(tab, ay.index * width + ax.index);
  const float gx = sub(1.f, ax.frac);
  const float gy = sub(1.f, ay.frac);
  const float top = add(mul(v.x, gx), mul(v.y, ax.frac));
  const float bot = add(mul(v.z, gx), mul(v.w, ax.frac));
  return add(mul(top, gy), mul(bot, ay.frac));
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

// A pixel's reference window as a thread reads it: tap offsets (shared by
// every pixel, or the pixel's own), the tap values (kWeighted: each tap's
// weight times its value, the product the plain version forms first), tap
// weights (kWeighted), and the reference-side sums with 1 / wsum and the
// empty-window flag.
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
// table ``tab``, the compensated sums in tap order, cost.ncc_from_sums;
// COST_MAX where the centre leaves the image, a variance or the window is
// degenerate, or the cost is not finite. kTaps is the window's tap count
// where it is known at compile time (kMainTaps), else 0 and ``num_taps``
// counts them.
template <typename Q, bool kWeighted, int kTaps>
__device__ __forceinline__ float window_ncc(
    const Q* __restrict__ tab, const float (&h)[3][3], float x, float y,
    int num_taps, const PixelWindow& win, int width, int quad_h, float img_w,
    float img_h) {
  const float pz = row_dot(h[2][0], h[2][1], h[2][2], x, y);
  const float cx = dvd(row_dot(h[0][0], h[0][1], h[0][2], x, y), pz);
  const float cy = dvd(row_dot(h[1][0], h[1][1], h[1][2], x, y), pz);
  const bool oob = cx < 0.f || cx >= img_w || cy < 0.f || cy >= img_h;

  float s_src = 0.f, s_ss = 0.f, s_rs = 0.f;
  float c_src = 0.f, c_ss = 0.f, c_rs = 0.f;
  auto tap = [&](int t) {
    const float tx = add(x, win.dx[t]);
    const float ty = add(y, win.dy[t]);
    const float tz = row_dot(h[2][0], h[2][1], h[2][2], tx, ty);
    const float wx = dvd(row_dot(h[0][0], h[0][1], h[0][2], tx, ty), tz);
    const float wy = dvd(row_dot(h[1][0], h[1][1], h[1][2], tx, ty), tz);
    const float sv = sample(tab, wx, wy, width, quad_h);
    if (kWeighted) {
      const float wsv = mul(win.tw[t], sv);
      kahan_add(s_src, c_src, wsv);
      kahan_add(s_ss, c_ss, mul(wsv, sv));
    } else {
      kahan_add(s_src, c_src, sv);
      kahan_add(s_ss, c_ss, mul(sv, sv));
    }
    kahan_add(s_rs, c_rs, mul(win.val[t], sv));
  };
  if constexpr (kTaps > 0) {
#pragma unroll 4
    for (int t = 0; t < kTaps; ++t) tap(t);
  } else {
    for (int t = 0; t < num_taps; ++t) tap(t);
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

// One tap of a pixel's window staged in shared memory (source index
// ``src``, slot ``at``): the tap value, or for a weighted (SA) window the
// weight and the weight-value product; the offsets where the window has
// them per pixel.
template <bool kPixelOffsets, bool kWeighted>
__device__ __forceinline__ void stage_tap(const float* __restrict__ tap_val,
                                          const float* __restrict__ tap_w,
                                          const float* __restrict__ tap_dx,
                                          const float* __restrict__ tap_dy,
                                          int64_t src, int at, float* s_val,
                                          float* s_tw, float* s_dx,
                                          float* s_dy) {
  const float v = __ldg(tap_val + src);
  if (kWeighted) {
    const float w = __ldg(tap_w + src);
    s_tw[at] = w;
    s_val[at] = mul(w, v);
  } else {
    s_val[at] = v;
  }
  if (kPixelOffsets) {
    s_dx[at] = __ldg(tap_dx + src);
    s_dy[at] = __ldg(tap_dy + src);
  }
}

}  // namespace apde
