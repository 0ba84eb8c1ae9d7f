// The deformable (anchor-based) NCC of one (weak pixel, plane, view) pair,
// shared by K6 (weak.cu, P planes a launch) and K7 (weak_sweep.cu, the weak
// sweep's chunk update), so the two cannot drift apart: the centre's
// out-of-image test, the centre window's NCC, each of the 8 anchors' sparse
// window NCC where it counts, the focal softmax over the anchors that count
// and the 0.25 / 0.75 blend (`ops/cuda/weak.py`, `weak_plain`; the JAX
// package's `deformable.ncc_weak`, apde_mvs_tpu/ops/deformable.py:124-198;
// the CUDA reference APD.cu:448-593). Every operation is rounded on its own,
// in the order of the plain version's torch ops (ncc_common.cuh says how);
// the exponential is expf, as torch.exp's.

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
