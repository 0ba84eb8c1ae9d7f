// K7 — the weak sweep's chunk update, hand-written for Hopper (sm_90a), with
// K6's deformable NCC (weak_common.cuh) and the geometric cost K4 inside.
//
// Replaces the weak chunk body the JAX package leaves to XLA
// (apde_mvs_tpu/ops/propagation.py:739, `_weak_body`; the CUDA reference is
// APD.cu:1441-1615, CheckerboardPropagationWeak, and :1008-1096,
// PlaneHypothesisRefinementWeak). The port first composed it from two K6
// launches (the 10 candidate planes against every view, the 5 refinement
// probes against the weighted views) and ~250 torch ops a chunk: the
// reference side `deformable.WeakRefData.build` (the (B, 8, 9) anchor taps,
// weights and selections through device memory), the candidate gathers,
// the selection, the adoption, the fit-plane test, the probes' planes and
// weighted sums and the REFINE_INIT commit, each a launch the host issues
// (`testing/weak_composition.py`, `weak_body_composition`). Here one launch
// updates a chunk of weak pixels (x, y) and writes only the four outputs:
// the planes, the costs, the new selections and the view weights.
//
// Per pixel, in the order of the plain version (ops/cuda/weak_sweep.py,
// `weak_update_plain`):
//  1. the reference side, built here from the reference image and the SA
//     segment ids: the centre window, the square taps of (strong_radius,
//     strong_increment), dy outer; under SA each tap's 0/1 weight is "the
//     pixel is in no segment (id <= 0), or the tap's id equals the
//     pixel's" (no star, no truncation: APD.cu:523-541); the 8 anchors'
//     sparse windows, square_taps(weak_radius, weak_increment) around each
//     anchor clamped at 0, weighed against the weak pixel's segment; values
//     by a clamped fetch, segment ids 0 outside the array; sum_ref, sum_rr
//     and the weight sums in tap order;
//  2. the anchors: ``exists`` (x, y >= 0) gates the priors; ``valid``
//     (exists and, under SA, the anchor's id equals the pixel's or the
//     pixel is in no segment) gates whether its window counts in the NCC;
//     ``flag`` (exists and the anchor's state STRONG) gates the cost array
//     and the adoption; the candidate planes are the state's at the clamped
//     anchors, with the current plane and the fit plane 10 slots;
//  3. phase 0: K6's deformable NCC (and K4 when the pass is geometric) of
//     every flagged candidate, the current plane and, where the fit plane
//     has a normal, the fit plane against every view;
//  4. the (8, S) cost array (an unflagged row 0, but 2 at [0][0]: the
//     reference's `float cost_array[8][32] = {2.0f}`), the priors (0.9 /
//     0.1 votes of the existing anchors' selections, in anchor order), the
//     selection (propagation_common.cuh's `select_views`, K3's);
//  5. each slot's weighted cost over the views in view order times
//     1 / wnorm (geometric: + geom_factor times K4's cost, GEOM_COST_MAX for
//     an unflagged candidate, no impetus gate); the current plane's
//     (COST_MAX without views); the adoption of the last minimum where its
//     flag is set, its depth is in range, its cost below the current one and
//     the pixel has views;
//  6. the fit-plane test: a fit plane with a non-zero normal component, its
//     depth in range, its cost below the current one, the pixel with views;
//  7. the 5 hypotheses of `refinement_from_raws` (K3's), phase 1 against the
//     pixel's weighted views, inf where a depth leaves [depth_min,
//     depth_max] or the pixel has no views; the first minimum, taken if
//     lower and only where the fit plane has a normal (the reference's early
//     return, APD.cu:1029-1032: no fit, no refinement);
//  8. under REFINE_INIT the commit only on an improvement of more than 0.1.
// A weak pixel reads only its anchors' state, which the chunk does not
// write (the scatter after the sweep writes WEAK pixels only), so no pixel
// reads another's output.
//
// Layout: a warp a pixel, 4 warps a block, as K3 and K6. The block stages
// the camera table and the two windows' offsets; each warp builds its
// pixel's reference side in its own slice of shared memory (about 3.1 KB at
// S = 5 with SA and the geometric cost: the 36 centre and 72 anchor tap
// values and weights, the anchors' coordinates, sums and selected views,
// the 10 plane slots, the (10, S) costs and geometric costs, the view
// weights, the hypotheses and their weighted terms, and K6's (8, 32)
// column of anchor costs a lane). The (plane, view) pairs run across the
// lanes in two phases, as K3's: every flagged candidate, the current plane
// and the fit plane against every view (at most 10 x S), then the 5
// hypotheses against the weighted views only (at most 5 x 15). A view
// whose weight is 0 adds +-0 to a sum that starts at +0 (every cost is
// finite), so leaving its pair out keeps each sum bit for bit; a slot whose
// result no output uses (an unflagged candidate, a fit plane without a
// normal, the hypotheses of a pixel without one) is not evaluated.
//
// Arithmetic equals the plain PyTorch version bit for bit: every operation
// rounded on its own (ncc_common.cuh), in its torch ops' order; the window
// sums' (w v) v is taken as (w v) (w v), equal for a 0/1 weight.
//
// Bound: operations, counted as chip_smoke.py counts them (K7_OPS_*,
// `k7_bound`): K6's counts for every evaluated pair of both phases (the
// homography, the centre window of each pair whose centre stays in the
// image, each anchor tested, computed and counted), K4's 115 a pair and 36
// a plane, the reference side's 4 a tap (36 + 72 taps a pixel), the
// selection's 84 a (pixel, view), 30 a (pixel, weighted view) and ~250 a
// pixel for the anchors' masks, the adoption, the fit test, the hypotheses
// and the commit. At the chip_smoke chunk (22,034 pixels, 5 views, SA,
// geometric) that is 2.24 GFLOP: 0.033 ms at the H100's 67 TFLOP/s of
// plain f32, against 7.5 MB of inputs and outputs (the state cells and
// reference taps it reads, the table rows and depth texels its pairs
// read, the draws). No matrix product, so no tensor core work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "geom_common.cuh"
#include "ncc_common.cuh"
#include "propagation_common.cuh"
#include "weak_common.cuh"

namespace {

using namespace apde;

constexpr int kWarps = 4;             // a block's warps, a pixel each
constexpr int kThreads = kWarps * 32;
constexpr int kSlots = kAnchors + 2;  // plane slots: candidates, current, fit
constexpr int kCurrent = kAnchors;    // the current plane's slot
constexpr int kFit = kAnchors + 1;    // the fit plane's slot
constexpr int kStrong = 1;            // config.STRONG
// the main path's windows: the centre cost.square_taps(5, 2), the anchors'
// cost.square_taps(5, 5)
constexpr int kMainRadius = 5;
constexpr int kMainIncrement = 2;
constexpr int kMainAnchorIncrement = 5;

struct Params {
  const void* quads;         // (S, quad_h * width, 4) u8 or f32
  const float* cams;         // (S + 1, 40): sweep.camera_table
  const float* src_depths;   // (S, depth_h, depth_w); read when kGeom
  int depth_h;
  int depth_w;
  float geom_factor;
  const float* planes;       // (grid_h, grid_w, 4) the state's planes
  const uint8_t* selected;   // (grid_h, grid_w, S) bool
  const int* weak;           // (grid_h, grid_w) int32 pixel states
  int grid_h;
  int grid_w;
  const int* x;              // (B,) int32
  const int* y;
  const int* anchors;        // (B, 9, 2) int32 (x, y), -1 where missing
  const float* fit;          // (B, 4) fit planes, 0 where none
  const float* ref;          // (ref_h, width) the reference image
  int ref_h;
  const int* sa;             // (ref_h, width) SA segment ids; read when kSA
  int c_radius;              // the centre's square: offsets -radius +
  int c_increment;           // i * increment, i < axis, each axis
  int c_axis;
  int a_radius;              // the anchors' square
  int a_increment;
  int a_axis;
  const float* sel_u;        // (B, 15) Monte-Carlo uniforms
  const float* u_rand;       // (B,) refinement draws
  const float* gauss;        // (B, 3)
  const float* u_pert;       // (B,)
  const float* angles;       // (B, 3)
  float cost_threshold;      // 0.8 exp(-it^2 / 90)
  float fallback;            // exp(-threshold^2 / 0.32)
  float depth_min;
  float depth_max;
  int refine_init;
  float* planes_out;         // (B, 4)
  float* costs_out;          // (B,)
  uint8_t* sel_out;          // (B, S) bool
  float* vw_out;             // (B, S)
  int64_t num_pix;
  int num_views;
  int num_taps;              // T = c_axis^2
  int num_anchor_taps;       // T' = a_axis^2
  int width;
  int quad_h;
  float img_w;               // real (unpadded) bounds of the warp tests
  float img_h;
};

// floats of a warp's slice: the centre's and the anchors' tap values (SA:
// the weight-value products) and weights (SA), the anchors' x, y, sum_ref,
// sum_rr and 1 / wsum, their selected views and clamped coordinates (a
// word each), K6's (8, 32) column of anchor costs a lane, the plane slots
// (10, 4), the costs (10, S) and geometric costs (10, S, geometric passes),
// the view weights (S), the hypotheses (5, 4) and their weighted terms
// (5, 15)
__host__ __device__ inline int warp_floats(int num_views, int num_taps,
                                           int num_anchor_taps, bool sa,
                                           bool geom) {
  return (num_taps + kAnchors * num_anchor_taps) * (sa ? 2 : 1) +
         5 * kAnchors + 3 * kAnchors + kAnchors * 32 + kSlots * 4 +
         kSlots * num_views * (geom ? 2 : 1) + num_views + kHyps * 4 +
         kHyps * kSamples;
}

// the camera table, the two windows' offsets, then one slice a warp
__host__ __device__ inline size_t smem_floats(int num_views, int num_taps,
                                              int num_anchor_taps, bool sa,
                                              bool geom) {
  return static_cast<size_t>(num_views + 1) * kGeomCamStride +
         2 * static_cast<size_t>(num_taps + num_anchor_taps) +
         static_cast<size_t>(kWarps) *
             warp_floats(num_views, num_taps, num_anchor_taps, sa, geom);
}

// cost.ref_window_taps' `fetch` of a segment id: 0 outside the array
__device__ __forceinline__ int segment_id(const int* __restrict__ sa, int x,
                                          int y, int w, int h) {
  return (x >= 0 && x < w && y >= 0 && y < h)
             ? __ldg(sa + static_cast<int64_t>(y) * w + x)
             : 0;
}

// kStop, for timing only (``stop`` of `apde_weak_sweep`; the main path
// runs 0): 1 stops after the reference side (step 1), 2 after the
// selection, the adoption and the fit-plane test (steps 2-6), 3 after the
// refinement hypotheses (step 7 but its pairs), each writing what it
// computed to the outputs so that none of it is left out
template <typename Q, bool kSA, bool kGeom, bool kMain, int kStop = 0>
__global__ void __launch_bounds__(kThreads)
weak_update_kernel(const Params p) {
  extern __shared__ float smem[];
  const int S = p.num_views;
  const int T = kMain ? kMainTaps : p.num_taps;
  const int TA = kMain ? kMainAnchorTaps : p.num_anchor_taps;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* s_cam = smem;
  float* s_cdx = s_cam + (S + 1) * kGeomCamStride;
  float* s_cdy = s_cdx + T;
  float* s_adx = s_cdy + T;
  float* s_ady = s_adx + TA;
  float* slice = s_ady + TA + warp * warp_floats(S, T, TA, kSA, kGeom);
  float* w_cval = slice;
  float* w_aval = w_cval + T;
  float* w_ctw = w_aval + kAnchors * TA;          // kSA only
  float* w_atw = w_ctw + T;
  float* w_ax = slice + (T + kAnchors * TA) * (kSA ? 2 : 1);
  float* w_ay = w_ax + kAnchors;
  float* w_asr = w_ay + kAnchors;
  float* w_asrr = w_asr + kAnchors;
  float* w_ainv = w_asrr + kAnchors;
  unsigned* w_sel = reinterpret_cast<unsigned*>(w_ainv + kAnchors);
  int* w_acx = reinterpret_cast<int*>(w_sel + kAnchors);
  int* w_acy = w_acx + kAnchors;
  float* w_acost = reinterpret_cast<float*>(w_acy + kAnchors);  // [8][32]
  float* w_plane = w_acost + kAnchors * 32;
  float* w_cost = w_plane + kSlots * 4;
  float* w_geom = w_cost + kSlots * S;            // kGeom only
  float* w_vw = w_cost + kSlots * S * (kGeom ? 2 : 1);
  float* w_hyp = w_vw + S;
  float* w_term = w_hyp + kHyps * 4;

  // ---- the cameras and the two windows' offsets, once a block ----------
  for (int i = threadIdx.x; i < (S + 1) * kGeomCamStride; i += kThreads) {
    s_cam[i] = __ldg(p.cams + i);
  }
  {
    const int cn = kMain ? 6 : p.c_axis;
    const int ci = kMain ? kMainIncrement : p.c_increment;
    const int cr = kMain ? kMainRadius : p.c_radius;
    for (int i = threadIdx.x; i < T; i += kThreads) {
      const int iy = i / cn;
      s_cdx[i] = static_cast<float>(ci * (i - iy * cn) - cr);
      s_cdy[i] = static_cast<float>(ci * iy - cr);
    }
    const int an = kMain ? 3 : p.a_axis;
    const int ai = kMain ? kMainAnchorIncrement : p.a_increment;
    const int ar = kMain ? kMainRadius : p.a_radius;
    for (int i = threadIdx.x; i < TA; i += kThreads) {
      const int iy = i / an;
      s_adx[i] = static_cast<float>(ai * (i - iy * an) - ar);
      s_ady[i] = static_cast<float>(ai * iy - ar);
    }
  }
  __syncthreads();

  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (b >= p.num_pix) return;
  const float* r = s_cam + S * kGeomCamStride;
  const float fx = r[12], fy = r[13], cx = r[14], cy = r[15];
  const Q* __restrict__ quads = static_cast<const Q*>(p.quads);
  const int64_t view_elems =
      static_cast<int64_t>(p.quad_h) * p.width * 4;   // a view's table
  const int gw = p.grid_w, gh = p.grid_h;
  const int xi = __ldg(p.x + b);
  const int yi = __ldg(p.y + b);
  const float x = static_cast<float>(xi);
  const float y = static_cast<float>(yi);
  const int64_t at = static_cast<int64_t>(yi) * gw + xi;

  // ---- 1. the reference side ----------------------------------------------
  // the pixel's segment: a tap weighs 1 where the pixel is in none (id <= 0)
  // or the tap's id is the pixel's
  const int seg = kSA ? segment_id(p.sa, xi, yi, p.width, p.ref_h) : 0;
  auto tap_weight = [&](int tx, int ty) {
    return (seg <= 0 || segment_id(p.sa, tx, ty, p.width, p.ref_h) == seg)
               ? 1.f
               : 0.f;
  };
  // the clamped fetch of the reference image
  auto ref_value = [&](int tx, int ty) {
    return __ldg(p.ref +
                 static_cast<int64_t>(clamp_int(ty, p.ref_h - 1)) * p.width +
                 clamp_int(tx, p.width - 1));
  };
  for (int t = lane; t < T; t += 32) {
    const int tx = xi + static_cast<int>(s_cdx[t]);
    const int ty = yi + static_cast<int>(s_cdy[t]);
    const float v = ref_value(tx, ty);
    if (kSA) {
      const float w = tap_weight(tx, ty);
      w_ctw[t] = w;
      w_cval[t] = mul(w, v);
    } else {
      w_cval[t] = v;
    }
  }
  // the anchors: lane a < 8 reads anchor a + 1 of the pixel's 9; lane 8
  // the current plane, lane 9 the fit plane
  bool exists = false, valid = false, flag = false;
  if (lane < kAnchors) {
    const int* an = p.anchors + (b * (kAnchors + 1) + 1 + lane) * 2;
    const int ax = __ldg(an), ay = __ldg(an + 1);
    exists = ax >= 0 && ay >= 0;
    const int axc = ax > 0 ? ax : 0, ayc = ay > 0 ? ay : 0;
    const bool in_grid = axc < gw && ayc < gh;
    const int64_t cell = static_cast<int64_t>(ayc) * gw + axc;
    flag = exists && in_grid && __ldg(p.weak + cell) == kStrong;
    valid = exists &&
            (!kSA || seg <= 0 ||
             segment_id(p.sa, axc, ayc, p.width, p.ref_h) == seg);
    w_ax[lane] = static_cast<float>(ax);
    w_ay[lane] = static_cast<float>(ay);
    w_acx[lane] = axc;
    w_acy[lane] = ayc;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w_plane[4 * lane + j] = in_grid ? __ldg(p.planes + 4 * cell + j) : 0.f;
    }
  } else if (lane == kCurrent) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w_plane[4 * kCurrent + j] = __ldg(p.planes + 4 * at + j);
    }
  } else if (lane == kFit) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w_plane[4 * kFit + j] = __ldg(p.fit + 4 * b + j);
    }
  }
  const unsigned exist_bits = __ballot_sync(kFull, exists);
  const unsigned valid_bits = __ballot_sync(kFull, valid);
  const unsigned flags = __ballot_sync(kFull, flag);
  __syncwarp();
  // each anchor's selected views (bit s: view s) and its window's taps
  for (int a = 0; a < kAnchors; ++a) {
    const int axc = w_acx[a], ayc = w_acy[a];
    const bool sel =
        lane < S && axc < gw && ayc < gh &&
        p.selected[(static_cast<int64_t>(ayc) * gw + axc) * S + lane] != 0;
    const unsigned bits = __ballot_sync(kFull, sel);
    if (lane == 0) w_sel[a] = bits;
  }
  for (int i = lane; i < kAnchors * TA; i += 32) {
    const int a = i / TA;
    const int t = i - a * TA;
    const int tx = w_acx[a] + static_cast<int>(s_adx[t]);
    const int ty = w_acy[a] + static_cast<int>(s_ady[t]);
    const float v = ref_value(tx, ty);
    if (kSA) {
      const float w = tap_weight(tx, ty);
      w_atw[i] = w;
      w_aval[i] = mul(w, v);
    } else {
      w_aval[i] = v;
    }
  }
  __syncwarp();
  // the sums in tap order: lanes 0-7 an anchor's sum_ref, 8-15 its sum_rr,
  // 16-23 its weight sum; lanes 24, 25, 26 the centre's three
  float part = 0.f;
  {
    const int k = lane & 7;
    const int what = lane < 24 ? lane >> 3 : lane - 24;
    const float* val = lane < 24 ? w_aval + k * TA : w_cval;
    const float* tw = lane < 24 ? w_atw + k * TA : w_ctw;
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
    w_asr[lane] = part;
  } else if (lane < 2 * kAnchors) {
    w_asrr[lane - kAnchors] = part;
  } else if (lane < 3 * kAnchors) {
    // an anchor's weight sum: the count of its weights, or T' (no SA)
    bool empty;
    const float ws = kSA ? part : static_cast<float>(TA);
    inverse_weight_sum(ws, &w_ainv[lane - 2 * kAnchors], &empty);
    positive = ws > 0.f;
  }
  const unsigned positive_bits =
      (__ballot_sync(kFull, positive) >> (2 * kAnchors)) & 0xffu;
  PixelWindow cwin;
  cwin.dx = s_cdx;
  cwin.dy = s_cdy;
  cwin.val = w_cval;
  cwin.tw = w_ctw;
  cwin.sum_ref = __shfl_sync(kFull, part, 24);
  cwin.sum_rr = __shfl_sync(kFull, part, 25);
  const float c_wsum = __shfl_sync(kFull, part, 26);
  if (kSA) {
    inverse_weight_sum(c_wsum, &cwin.inv, &cwin.empty);
  } else {
    // cost.ncc_from_sums' float32 1 / T of a float weight sum
    cwin.inv = dvd(1.f, static_cast<float>(T));
    cwin.empty = false;
  }
  if constexpr (kStop == 1) {
    __syncwarp();
    if (lane == 0) {
      float acc = add(add(cwin.sum_ref, cwin.sum_rr), cwin.inv);
      unsigned sel = 0u;
      for (int a = 0; a < kAnchors; ++a) {
        acc = add(acc, add(add(w_asr[a], w_asrr[a]), w_ainv[a]));
        sel ^= w_sel[a];
      }
      p.costs_out[b] = acc;
      p.planes_out[4 * b] = __uint_as_float(
          exist_bits ^ valid_bits ^ flags ^ positive_bits ^ sel);
    }
    return;
  }
  // an unflagged candidate's row: 0, and 2 at [0][0] (the aggregate-init
  // quirk)
  if (lane < S) {
    for (int c = 0; c < kAnchors; ++c) {
      if (!((flags >> c) & 1u)) {
        w_cost[c * S + lane] = (c == 0 && lane == 0) ? kCostMax : 0.f;
      }
    }
  }
  __syncwarp();
  WeakAnchors an;
  an.dx = s_adx;
  an.dy = s_ady;
  an.val = w_aval;
  an.tw = w_atw;
  an.x = w_ax;
  an.y = w_ay;
  an.sum_ref = w_asr;
  an.sum_rr = w_asrr;
  an.inv = w_ainv;
  an.sel = w_sel;
  an.valid = valid_bits;
  an.positive = positive_bits;
  const float* fit = w_plane + 4 * kFit;
  // the fit plane has a normal (NaN counts): else no fit test, no refinement
  const bool fit_ok = fit[0] != 0.f || fit[1] != 0.f || fit[2] != 0.f;

  // the first phase's plane slots: the flagged candidates, the current
  // plane, the fit plane where it has a normal
  const unsigned slots =
      flags | (1u << kCurrent) | (fit_ok ? 1u << kFit : 0u);
  const int n_slots = __popc(slots);
  // what the selection and the adoption leave for the refinement
  float my_vw = 0.f, inv = 0.f, cost_rec = 0.f, cost_cur = 0.f;
  float plane_cur[4] = {0.f, 0.f, 0.f, 0.f};
  unsigned weighted = 0u, ok_mask = 0u;
  int n_w = 0;
  bool sel_new = false;
  float* my_acost = w_acost + lane;   // anchor a's cost at my_acost[32 a]

#pragma unroll 1
  for (int phase = 0; phase < 2; ++phase) {
    if (phase == 1) {
      // ---- 4. the selection: lane s < S takes view s -------------------
      const int s = lane < S ? lane : S - 1;
      // the existing anchors' votes, in anchor order
      float prior = 0.f;
      for (int a = 0; a < kAnchors; ++a) {
        const bool sel = (w_sel[a] >> s) & 1u;
        prior = add(prior, ((exist_bits >> a) & 1u)
                               ? (sel ? kPriorSelected : kPriorUnselected)
                               : 0.f);
      }
      const Selection vs =
          select_views(w_cost, S, lane, prior, p.cost_threshold, p.fallback,
                       p.sel_u + b * kSamples);
      my_vw = vs.vw;
      weighted = vs.weighted;
      n_w = vs.n_weighted;
      inv = vs.inv;
      const bool has = vs.has;
      if (lane < S) w_vw[lane] = my_vw;
      __syncwarp();

      // ---- 5. weighted costs: lane c < 8 candidate c, 8 current, 9 fit --
      float sum = 0.f;
      if (lane < kSlots) {
        const bool open = lane < kAnchors && !((flags >> lane) & 1u);
        for (int t = 0; t < S; ++t) {
          float v = w_cost[lane * S + t];
          if (kGeom) {
            v = add(v, mul(p.geom_factor,
                           open ? kGeomCostMax : w_geom[lane * S + t]));
          }
          sum = add(sum, mul(w_vw[t], v));
        }
        sum = mul(sum, inv);
      }
      cost_rec = has ? __shfl_sync(kFull, sum, kCurrent) : kCostMax;
      const float fit_cost = __shfl_sync(kFull, sum, kFit);
      // the adoption: the last minimum (FindMinCostIndex's <=)
      float best_cost;
      const int best = last_minimum(sum, &best_cost);
      const float* bp = w_plane + 4 * best;
      const float d_before =
          plane_depth(fx, fy, cx, cy, x, y, bp[0], bp[1], bp[2], bp[3]);
      const bool adopt = ((flags >> best) & 1u) && d_before >= p.depth_min &&
                         d_before <= p.depth_max && best_cost < cost_rec &&
                         has;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        plane_cur[j] = adopt ? bp[j] : w_plane[4 * kCurrent + j];
      }
      cost_cur = adopt ? best_cost : cost_rec;
      sel_new =
          adopt ? my_vw > 0.f : (lane < S && p.selected[at * S + s] != 0);

      // ---- 6. the fit-plane test (PlaneHypothesisRefinementWeak) ---------
      const float fit_depth =
          plane_depth(fx, fy, cx, cy, x, y, fit[0], fit[1], fit[2], fit[3]);
      const bool take_fit = fit_ok && fit_depth >= p.depth_min &&
                            fit_depth <= p.depth_max && fit_cost < cost_cur &&
                            has;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        plane_cur[j] = take_fit ? fit[j] : plane_cur[j];
      }
      cost_cur = take_fit ? fit_cost : cost_cur;
      if constexpr (kStop == 2) {
        if (lane == 0) {
#pragma unroll
          for (int j = 0; j < 4; ++j) p.planes_out[4 * b + j] = plane_cur[j];
          p.costs_out[b] = cost_cur;
        }
        if (lane < S) {
          p.sel_out[b * S + lane] = sel_new ? 1 : 0;
          p.vw_out[b * S + lane] = my_vw;
        }
        return;
      }

      // ---- 7. the refinement hypotheses (refinement_from_raws) -----------
      const RefineDraws draws = {p.u_rand, p.gauss, p.u_pert, p.angles};
      ok_mask = refinement_hypotheses(draws, b, x, y, fx, fy, cx, cy,
                                      plane_cur, p.depth_min, p.depth_max,
                                      has, lane, w_hyp);
      __syncwarp();
      if constexpr (kStop == 3) {
        if (lane < kHyps * 4) p.vw_out[b * S + lane % S] = w_hyp[lane];
        if (lane == 0) p.costs_out[b] = __uint_as_float(ok_mask);
        return;
      }
    }

    // ---- 3. (phase 0) and 7. (phase 1): the (plane, view) pairs ----------
    const int pairs =
        phase == 0 ? n_slots * S : (fit_ok ? kHyps * n_w : 0);
    for (int i = lane; i < pairs; i += 32) {
      int view, slot = 0, k = 0, h = 0;
      const float* pl;
      if (phase == 0) {
        view = i / n_slots;
        slot = nth_bit(slots, i - view * n_slots);
        pl = w_plane + 4 * slot;
      } else {
        k = i / kHyps;
        h = i - k * kHyps;
        view = nth_bit(weighted, k);
        pl = w_hyp + 4 * h;
      }
      const float* c = s_cam + view * kGeomCamStride;
      float hm[3][3];
      plane_homography(c, r, pl[0], pl[1], pl[2], pl[3], hm);
      float cv = deformable_cost<Q, kSA, kMain ? kMainTaps : 0,
                                 kMain ? kMainAnchorTaps : 0>(
          quads + view * view_elems, hm, x, y, T, TA, cwin, an, view,
          my_acost, p.width, p.quad_h, p.img_w, p.img_h);
      float g = 0.f;
      if constexpr (kGeom) {
        const float* dmap = p.src_depths + static_cast<int64_t>(view) *
                                               p.depth_h * p.depth_w;
        g = geom_cost(r + kGeomCols, c + kGeomCols, dmap, p.depth_h,
                      p.depth_w, x, y, pl[0], pl[1], pl[2], pl[3]);
      }
      if (phase == 0) {
        w_cost[slot * S + view] = cv;
        if (kGeom) w_geom[slot * S + view] = g;
      } else {
        if (kGeom) cv = add(cv, mul(p.geom_factor, g));
        w_term[h * kSamples + k] = mul(w_vw[view], cv);
      }
    }
    __syncwarp();
  }

  // ---- the hypotheses' first minimum, taken where lower and the fit plane
  // has a normal -------------------------------------------------------------
  float rv;
  const int rb = first_minimum(w_term, fit_ok ? n_w : 0, ok_mask, inv, lane,
                               &rv);
  const bool take = fit_ok && rv < cost_cur;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    plane_cur[j] = take ? w_hyp[4 * rb + j] : plane_cur[j];
  }
  cost_cur = take ? rv : cost_cur;

  // ---- 8. the commit (REFINE_INIT: an improvement of more than 0.1) ------
  const bool commit = !p.refine_init || cost_cur < sub(cost_rec, 0.1f);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p.planes_out[4 * b + j] =
          commit ? plane_cur[j] : w_plane[4 * kCurrent + j];
    }
    p.costs_out[b] = commit ? cost_cur : cost_rec;
  }
  if (lane < S) {
    p.sel_out[b * S + lane] = sel_new ? 1 : 0;
    p.vw_out[b * S + lane] = my_vw;
  }
}

using Kernel = void (*)(const Params);

template <typename Q, bool kSA>
Kernel pick_form(bool geom, bool main_windows) {
  if (geom) {
    return main_windows ? weak_update_kernel<Q, kSA, true, true>
                        : weak_update_kernel<Q, kSA, true, false>;
  }
  return main_windows ? weak_update_kernel<Q, kSA, false, true>
                      : weak_update_kernel<Q, kSA, false, false>;
}

// the instantiation for a table type, SA windows, the geometric cost and
// the main path's windows (the centre of radius 5, increment 2, the anchors
// of radius 5, increment 5) or others
Kernel pick(bool quads_u8, bool sa, bool geom, bool main_windows) {
  if (quads_u8) {
    return sa ? pick_form<uint8_t, true>(geom, main_windows)
              : pick_form<uint8_t, false>(geom, main_windows);
  }
  return sa ? pick_form<float, true>(geom, main_windows)
            : pick_form<float, false>(geom, main_windows);
}

// the timing-only forms (kStop 1, 2, 3) of the main path's windows, u8
// tables
template <int kStop>
Kernel pick_stop(bool sa, bool geom) {
  return sa ? (geom ? weak_update_kernel<uint8_t, true, true, true, kStop>
                    : weak_update_kernel<uint8_t, true, false, true, kStop>)
            : (geom ? weak_update_kernel<uint8_t, false, true, true, kStop>
                    : weak_update_kernel<uint8_t, false, false, true, kStop>);
}

Kernel pick_timing(int stop, bool sa, bool geom) {
  return stop == 1   ? pick_stop<1>(sa, geom)
         : stop == 2 ? pick_stop<2>(sa, geom)
                     : pick_stop<3>(sa, geom);
}

bool is_main(int c_radius, int c_increment, int a_radius, int a_increment) {
  return c_radius == kMainRadius && c_increment == kMainIncrement &&
         a_radius == kMainRadius && a_increment == kMainAnchorIncrement;
}

// taps an axis of the square of (radius, increment): cost.square_taps
int axis_taps(int radius, int increment) {
  return 2 * radius / increment + 1;
}

// its shared memory, with the attribute set where it passes 48 KB
cudaError_t prepare(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

size_t smem_bytes(int num_views, int c_radius, int c_increment, int a_radius,
                  int a_increment, bool sa, bool geom) {
  const int cn = axis_taps(c_radius, c_increment);
  const int an = axis_taps(a_radius, a_increment);
  return smem_floats(num_views, cn * cn, an * an, sa, geom) * sizeof(float);
}

}  // namespace

// Plain C interface for ctypes. Every pointer is a device pointer (sa and
// src_depths may be null: no SA windows, no geometric cost); the function
// returns cudaGetLastError() after its launch (0 = cudaSuccess), or the
// error of the shared-memory attribute.
extern "C" {

int apde_weak_sweep_max_views() { return kMaxViews; }

int apde_weak_sweep_cam_stride() { return kGeomCamStride; }

int apde_weak_sweep_num_samples() { return kSamples; }

long long apde_weak_sweep_smem_bytes(int num_views, int c_radius,
                                     int c_increment, int a_radius,
                                     int a_increment, int sa, int geom) {
  return static_cast<long long>(smem_bytes(num_views, c_radius, c_increment,
                                           a_radius, a_increment, sa != 0,
                                           geom != 0));
}

// The instantiation's registers, local memory (spills) and resident blocks
// an SM (the CUDA runtime's occupancy calculator) at S views; returns the
// first error.
int apde_weak_sweep_kernel_info(int quads_u8, int sa, int geom, int c_radius,
                                int c_increment, int a_radius,
                                int a_increment, int num_views, int* regs,
                                int* local_bytes, int* blocks_per_sm) {
  const Kernel kernel =
      pick(quads_u8 != 0, sa != 0, geom != 0,
           is_main(c_radius, c_increment, a_radius, a_increment));
  const size_t bytes = smem_bytes(num_views, c_radius, c_increment, a_radius,
                                  a_increment, sa != 0, geom != 0);
  cudaFuncAttributes attr;
  cudaError_t err = prepare(kernel, bytes);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                        kThreads, bytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}

// K7 on a chunk of num_pix weak pixels. ``stop`` is 0 on the main path;
// 1, 2 and 3 run the timing-only forms of the main path's windows with u8
// tables that end after the reference side, after the selection, the
// adoption and the fit-plane test, and after the refinement hypotheses
// (the kernel's kStop).
int apde_weak_sweep(const void* quads, int quads_u8, const void* cams,
                    const void* src_depths, int depth_h, int depth_w,
                    float geom_factor, const void* planes,
                    const void* selected, const void* weak, int grid_h,
                    int grid_w, const void* x, const void* y,
                    const void* anchors, const void* fit, const void* ref,
                    int ref_h, const void* sa, int c_radius, int c_increment,
                    int a_radius, int a_increment, const void* sel_u,
                    const void* u_rand, const void* gauss, const void* u_pert,
                    const void* angles, float cost_threshold, float fallback,
                    float depth_min, float depth_max, int refine_init,
                    void* planes_out, void* costs_out, void* sel_out,
                    void* vw_out, int64_t num_pix, int num_views, int width,
                    int quad_h, int img_w, int img_h, int stop,
                    void* stream) {
  if (num_pix <= 0) return static_cast<int>(cudaGetLastError());
  if (num_views < 1 || num_views > kMaxViews || c_radius < 0 ||
      c_increment < 1 || a_radius < 0 || a_increment < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.quads = quads;
  p.cams = static_cast<const float*>(cams);
  p.src_depths = static_cast<const float*>(src_depths);
  p.depth_h = depth_h;
  p.depth_w = depth_w;
  p.geom_factor = geom_factor;
  p.planes = static_cast<const float*>(planes);
  p.selected = static_cast<const uint8_t*>(selected);
  p.weak = static_cast<const int*>(weak);
  p.grid_h = grid_h;
  p.grid_w = grid_w;
  p.x = static_cast<const int*>(x);
  p.y = static_cast<const int*>(y);
  p.anchors = static_cast<const int*>(anchors);
  p.fit = static_cast<const float*>(fit);
  p.ref = static_cast<const float*>(ref);
  p.ref_h = ref_h;
  p.sa = static_cast<const int*>(sa);
  p.c_radius = c_radius;
  p.c_increment = c_increment;
  p.c_axis = axis_taps(c_radius, c_increment);
  p.a_radius = a_radius;
  p.a_increment = a_increment;
  p.a_axis = axis_taps(a_radius, a_increment);
  p.sel_u = static_cast<const float*>(sel_u);
  p.u_rand = static_cast<const float*>(u_rand);
  p.gauss = static_cast<const float*>(gauss);
  p.u_pert = static_cast<const float*>(u_pert);
  p.angles = static_cast<const float*>(angles);
  p.cost_threshold = cost_threshold;
  p.fallback = fallback;
  p.depth_min = depth_min;
  p.depth_max = depth_max;
  p.refine_init = refine_init != 0;
  p.planes_out = static_cast<float*>(planes_out);
  p.costs_out = static_cast<float*>(costs_out);
  p.sel_out = static_cast<uint8_t*>(sel_out);
  p.vw_out = static_cast<float*>(vw_out);
  p.num_pix = num_pix;
  p.num_views = num_views;
  p.num_taps = p.c_axis * p.c_axis;
  p.num_anchor_taps = p.a_axis * p.a_axis;
  p.width = width;
  p.quad_h = quad_h;
  p.img_w = static_cast<float>(img_w);
  p.img_h = static_cast<float>(img_h);
  const bool with_sa = p.sa != nullptr;
  const bool geom = p.src_depths != nullptr;
  const bool main_windows =
      is_main(c_radius, c_increment, a_radius, a_increment);
  if (stop != 0 && (stop < 0 || stop > 3 || !main_windows || !quads_u8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Kernel kernel = stop != 0 ? pick_timing(stop, with_sa, geom)
                                  : pick(quads_u8 != 0, with_sa, geom,
                                         main_windows);
  const size_t bytes = smem_bytes(num_views, c_radius, c_increment, a_radius,
                                  a_increment, with_sa, geom);
  const cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int grid =
      static_cast<unsigned int>((num_pix + kWarps - 1) / kWarps);
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
