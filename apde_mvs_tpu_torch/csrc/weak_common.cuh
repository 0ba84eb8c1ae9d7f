// A weak pixel's reference side and its deformable (anchor-based) NCC,
// shared by K6 (weak.cu: P planes a launch, and the initial cost's
// re-score) and K7 (weak_sweep.cu, the weak sweep's chunk update), so they
// cannot drift apart.
//
// `build_weak_ref` builds the reference side in a warp's slice of shared
// memory from the reference image, the SA segment ids and the state's
// selections (`ops/cuda/weak.py`, `weak_ref_plain`): the centre window, the
// square taps of (strong_radius, strong_increment), dy outer, under SA
// each tap weighing 1 where the pixel is in no segment (id <= 0) or the
// tap's id is the pixel's (no star, no truncation: APD.cu:523-541); the 8
// anchors' sparse windows around each anchor clamped at 0, weighed against
// the weak pixel's segment; values by a clamped fetch, segment ids 0
// outside the array; sum_ref, sum_rr and the weight sums in tap order; the
// anchors' ``exists`` (x, y >= 0) and ``valid`` (exists and, under SA, the
// anchor's id is the pixel's or the pixel is in no segment) masks and
// their selected views.
//
// `deformable_cost` is the NCC of one (weak pixel, plane, view) pair: the
// centre's out-of-image test, the centre window's NCC, each of the 8
// anchors' sparse window NCC where it counts, the focal softmax over the
// anchors that count and the 0.25 / 0.75 blend (`ops/cuda/weak.py`,
// `weak_plain`; the JAX package's `deformable.ncc_weak`,
// apde_mvs_tpu/ops/deformable.py:124-198; the CUDA reference
// APD.cu:448-593). Every operation is rounded on its own, in the order of
// the plain version's torch ops (ncc_common.cuh says how); the exponential
// is expf, as torch.exp's.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ncc_common.cuh"

namespace apde {

constexpr int kAnchors = 8;           // deformable anchors 1..8
constexpr int kMainAnchorTaps = 9;    // cost.square_taps(5, 5)

// A weak pixel's anchors as a warp reads them from its slice of shared
// memory: the sparse window's offsets (shared by every anchor), each
// anchor's tap values (weighted: each tap's weight times its value) and
// weights, its coordinates, sums, 1 / weight sum and selected views, and
// which anchors are valid and have a positive weight sum.
struct WeakAnchors {
  const float* dx;          // (T',)
  const float* dy;
  const float* val;         // (8, T')
  const float* tw;          // (8, T'); read when weighted
  const float* x;           // (8,)
  const float* y;
  const float* sum_ref;     // (8,)
  const float* sum_rr;
  const float* inv;
  const unsigned* sel;      // (8,) bit s: the anchor selected view s
  unsigned valid;           // bit a: anchor a is valid
  unsigned positive;        // bit a: its weight sum is > 0
};

// the fetch of a segment id: 0 outside the array
__device__ __forceinline__ int segment_id(const int* __restrict__ sa, int x,
                                          int y, int w, int h) {
  return (x >= 0 && x < w && y >= 0 && y < h)
             ? __ldg(sa + static_cast<int64_t>(y) * w + x)
             : 0;
}

// Where a weak pixel's reference side comes from: the reference image
// (ref_h, width), the SA segment ids of the same shape (null: no SA), the
// state's (grid_h, grid_w, S) bool selections.
struct WeakRefSource {
  const float* ref;
  const int* sa;
  int ref_h;
  int width;
  const uint8_t* selected;
  int grid_h;
  int grid_w;
  int num_views;
};

// A pixel's slice of shared memory for its reference side: the centre's
// and the anchors' tap values (SA: the weight-value products) and weights
// (SA only), the anchors' x, y, sum_ref, sum_rr and 1 / wsum, their
// selected views and clamped coordinates (a word each).
struct WeakRefSlice {
  float* cval;     // (T,)
  float* ctw;      // (T,)
  float* aval;     // (8, T')
  float* atw;      // (8, T')
  float* ax;       // (8,)
  float* ay;
  float* asr;
  float* asrr;
  float* ainv;
  unsigned* sel;   // (8,) bit s: the anchor selected view s
  int* acx;        // (8,)
  int* acy;
};

// floats of a `WeakRefSlice` (kSA: with the weights)
__host__ __device__ inline int weak_ref_floats(int num_taps,
                                               int num_anchor_taps, bool sa) {
  return (num_taps + kAnchors * num_anchor_taps) * (sa ? 2 : 1) +
         5 * kAnchors + 3 * kAnchors;
}

// the `WeakRefSlice` laid out from ``base``
template <bool kSA>
__device__ __forceinline__ WeakRefSlice weak_ref_slice(float* base, int T,
                                                       int TA) {
  WeakRefSlice w;
  w.cval = base;
  w.aval = base + T;
  w.ctw = w.aval + kAnchors * TA;          // kSA only
  w.atw = w.ctw + T;
  w.ax = base + (T + kAnchors * TA) * (kSA ? 2 : 1);
  w.ay = w.ax + kAnchors;
  w.asr = w.ay + kAnchors;
  w.asrr = w.asr + kAnchors;
  w.ainv = w.asrr + kAnchors;
  w.sel = reinterpret_cast<unsigned*>(w.ainv + kAnchors);
  w.acx = reinterpret_cast<int*>(w.sel + kAnchors);
  w.acy = w.acx + kAnchors;
  return w;
}

// A built reference side: the centre window and the anchors as
// `deformable_cost` reads them, which anchors exist, and on which lanes
// the caller's ``mark`` returned true.
struct WeakRef {
  PixelWindow cwin;
  WeakAnchors an;
  unsigned exists;   // bit a: anchor a exists
  unsigned marked;   // bit l: lane l's mark
};

// Builds weak pixel (xi, yi)'s reference side in its slice ``w``, every
// lane of the warp taking part; ``anchors`` are the pixel's 9 (x, y) int32
// anchors (anchor 0 the pixel itself), ``cdx`` / ``cdy`` and ``adx`` /
// ``ady`` the two windows' offsets (T and T' taps). ``mark(lane, exists,
// axc, ayc)`` runs on every lane once the anchors are read (lane a < 8
// with anchor a + 1's existence and clamped coordinates, the other lanes
// with false, 0, 0): K7 reads each anchor's state and plane there. The
// sums in tap order: lanes 0-7 an anchor's sum_ref, 8-15 its sum_rr,
// 16-23 its weight sum, lanes 24, 25, 26 the centre's three.
template <bool kSA, typename Mark>
__device__ __forceinline__ WeakRef build_weak_ref(
    const WeakRefSource& src, int xi, int yi, const int* __restrict__ anchors,
    int T, int TA, const float* cdx, const float* cdy, const float* adx,
    const float* ady, const WeakRefSlice& w, int lane, Mark mark) {
  constexpr unsigned kLanes = 0xffffffffu;
  const int S = src.num_views;
  const int gw = src.grid_w, gh = src.grid_h;
  // the pixel's segment: a tap weighs 1 where the pixel is in none (id <= 0)
  // or the tap's id is the pixel's
  const int seg = kSA ? segment_id(src.sa, xi, yi, src.width, src.ref_h) : 0;
  auto tap_weight = [&](int tx, int ty) {
    return (seg <= 0 ||
            segment_id(src.sa, tx, ty, src.width, src.ref_h) == seg)
               ? 1.f
               : 0.f;
  };
  // the clamped fetch of the reference image
  auto ref_value = [&](int tx, int ty) {
    return __ldg(src.ref +
                 static_cast<int64_t>(clamp_int(ty, src.ref_h - 1)) *
                     src.width +
                 clamp_int(tx, src.width - 1));
  };
  for (int t = lane; t < T; t += 32) {
    const int tx = xi + static_cast<int>(cdx[t]);
    const int ty = yi + static_cast<int>(cdy[t]);
    const float v = ref_value(tx, ty);
    if (kSA) {
      const float wt = tap_weight(tx, ty);
      w.ctw[t] = wt;
      w.cval[t] = mul(wt, v);
    } else {
      w.cval[t] = v;
    }
  }
  // the anchors: lane a < 8 reads anchor a + 1 of the pixel's 9
  bool exists = false, valid = false;
  int axc = 0, ayc = 0;
  if (lane < kAnchors) {
    const int* an = anchors + (1 + lane) * 2;
    const int ax = __ldg(an), ay = __ldg(an + 1);
    exists = ax >= 0 && ay >= 0;
    axc = ax > 0 ? ax : 0;
    ayc = ay > 0 ? ay : 0;
    valid = exists &&
            (!kSA || seg <= 0 ||
             segment_id(src.sa, axc, ayc, src.width, src.ref_h) == seg);
    w.ax[lane] = static_cast<float>(ax);
    w.ay[lane] = static_cast<float>(ay);
    w.acx[lane] = axc;
    w.acy[lane] = ayc;
  }
  const bool marked = mark(lane, exists, axc, ayc);
  const unsigned exist_bits = __ballot_sync(kLanes, exists);
  const unsigned valid_bits = __ballot_sync(kLanes, valid);
  const unsigned marked_bits = __ballot_sync(kLanes, marked);
  __syncwarp();
  // each anchor's selected views (bit s: view s) and its window's taps
  for (int a = 0; a < kAnchors; ++a) {
    const int cx = w.acx[a], cy = w.acy[a];
    const bool sel =
        lane < S && cx < gw && cy < gh &&
        src.selected[(static_cast<int64_t>(cy) * gw + cx) * S + lane] != 0;
    const unsigned bits = __ballot_sync(kLanes, sel);
    if (lane == 0) w.sel[a] = bits;
  }
  for (int i = lane; i < kAnchors * TA; i += 32) {
    const int a = i / TA;
    const int t = i - a * TA;
    const int tx = w.acx[a] + static_cast<int>(adx[t]);
    const int ty = w.acy[a] + static_cast<int>(ady[t]);
    const float v = ref_value(tx, ty);
    if (kSA) {
      const float wt = tap_weight(tx, ty);
      w.atw[i] = wt;
      w.aval[i] = mul(wt, v);
    } else {
      w.aval[i] = v;
    }
  }
  __syncwarp();
  // the sums in tap order: lanes 0-7 an anchor's sum_ref, 8-15 its sum_rr,
  // 16-23 its weight sum; lanes 24, 25, 26 the centre's three
  float part = 0.f;
  {
    const int k = lane & 7;
    const int what = lane < 24 ? lane >> 3 : lane - 24;
    const float* val = lane < 24 ? w.aval + k * TA : w.cval;
    const float* tw = lane < 24 ? w.atw + k * TA : w.ctw;
    const int n = lane < 24 ? TA : T;
    if (lane < 27) {
      for (int t = 0; t < n; ++t) {
        const float wv = val[t];
        part = add(part, what == 0 ? wv
                                   : (what == 1 ? mul(wv, wv)
                                                : (kSA ? tw[t] : 1.f)));
      }
    }
  }
  bool positive = false;
  if (lane < kAnchors) {
    w.asr[lane] = part;
  } else if (lane < 2 * kAnchors) {
    w.asrr[lane - kAnchors] = part;
  } else if (lane < 3 * kAnchors) {
    // an anchor's weight sum: the count of its weights, or T' (no SA)
    bool empty;
    const float ws = kSA ? part : static_cast<float>(TA);
    inverse_weight_sum(ws, &w.ainv[lane - 2 * kAnchors], &empty);
    positive = ws > 0.f;
  }
  WeakRef r;
  r.an.positive = (__ballot_sync(kLanes, positive) >> (2 * kAnchors)) & 0xffu;
  r.cwin.dx = cdx;
  r.cwin.dy = cdy;
  r.cwin.val = w.cval;
  r.cwin.tw = w.ctw;
  r.cwin.sum_ref = __shfl_sync(kLanes, part, 24);
  r.cwin.sum_rr = __shfl_sync(kLanes, part, 25);
  const float c_wsum = __shfl_sync(kLanes, part, 26);
  if (kSA) {
    inverse_weight_sum(c_wsum, &r.cwin.inv, &r.cwin.empty);
  } else {
    // cost.ncc_from_sums' float32 1 / T of a float weight sum
    r.cwin.inv = dvd(1.f, static_cast<float>(T));
    r.cwin.empty = false;
  }
  r.an.dx = adx;
  r.an.dy = ady;
  r.an.val = w.aval;
  r.an.tw = w.atw;
  r.an.x = w.ax;
  r.an.y = w.ay;
  r.an.sum_ref = w.asr;
  r.an.sum_rr = w.asrr;
  r.an.inv = w.ainv;
  r.an.sel = w.sel;
  r.an.valid = valid_bits;
  r.exists = exist_bits;
  r.marked = marked_bits;
  return r;
}

// The deformable NCC of the pixel (x, y) against view ``s`` for the plane
// whose homography into the view is ``h`` (`weak_plain` per pair):
//  1. COST_MAX where the centre leaves the image (nothing else is needed);
//  2. the centre window's NCC (`window_cost`);
//  3. the 8 anchors in order: one that is not valid does not count; a valid
//     one whose warp leaves the image counts at COST_MAX iff it selected
//     view s; one that stays in the image counts with its sparse window's
//     NCC iff its weight sum is > 0;
//  4. `deformable._softmax_weighted` over the counting anchors: their max,
//     exp(c - max), the sums of e and of e c in anchor order from +0, one
//     true division, capped at COST_MAX; then 0.25 centre + 0.75 anchors,
//     or the centre's cost alone where no anchor counts.
// ``my_cost`` is the calling lane's column of an (8, 32) scratch array in
// shared memory (anchor a at my_cost[32 a]), where the anchors' costs wait
// for the softmax. kTaps / kATaps are the two windows' tap counts where
// they are known at compile time, else 0 (``num_taps``, ``num_anchor_taps``
// count them).
template <typename Q, bool kWeighted, int kTaps, int kATaps>
__device__ __forceinline__ float deformable_cost(
    const Q* __restrict__ tab, const float (&h)[3][3], float x, float y,
    int num_taps, int num_anchor_taps, const PixelWindow& cwin,
    const WeakAnchors& an, int s, float* my_cost, int width, int quad_h,
    float img_w, float img_h) {
  if (out_of_image(h, x, y, img_w, img_h)) return kCostMax;
  const int TA = kATaps > 0 ? kATaps : num_anchor_taps;
  const float centre = window_cost<Q, kWeighted, kTaps>(
      tab, h, x, y, num_taps, cwin, width, quad_h);
  // the anchors' costs and which of them count, in anchor order
  unsigned counts = 0u;
  float top = -INFINITY;
#pragma unroll 1
  for (int a = 0; a < kAnchors; ++a) {
    if (!((an.valid >> a) & 1u)) continue;
    const float ax = an.x[a];
    const float ay = an.y[a];
    float v = kCostMax;
    if (out_of_image(h, ax, ay, img_w, img_h)) {
      if (!((an.sel[a] >> s) & 1u)) continue;
    } else {
      if (!((an.positive >> a) & 1u)) continue;
      PixelWindow awin;
      awin.dx = an.dx;
      awin.dy = an.dy;
      awin.val = an.val + a * TA;
      awin.tw = an.tw + a * TA;
      awin.sum_ref = an.sum_ref[a];
      awin.sum_rr = an.sum_rr[a];
      awin.inv = an.inv[a];
      awin.empty = false;
      v = window_cost<Q, kWeighted, kATaps>(tab, h, ax, ay, TA, awin, width,
                                             quad_h);
    }
    counts |= 1u << a;
    my_cost[32 * a] = v;
    top = v > top ? v : top;
  }
  if (counts == 0u) return centre;
  // deformable._softmax_weighted: the sums in anchor order from +0 (an
  // anchor that does not count adds +0, which changes nothing)
  float denom = 0.f, num = 0.f;
#pragma unroll 1
  for (int a = 0; a < kAnchors; ++a) {
    if (!((counts >> a) & 1u)) continue;
    const float v = my_cost[32 * a];
    const float e = expf(sub(v, top));
    denom = add(denom, e);
    num = add(num, mul(e, v));
  }
  float anchored = dvd(num, clamp_min_keep_nan(denom, 1e-30f));
  anchored = anchored > kCostMax ? kCostMax : anchored;
  return add(mul(0.25f, centre), mul(0.75f, anchored));
}

}  // namespace apde
