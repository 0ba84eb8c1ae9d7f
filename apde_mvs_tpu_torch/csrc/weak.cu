// K6 — the deformable (anchor-based) NCC of weak pixels, hand-written for
// Hopper (sm_90a), with the geometric cost K4 inside.
//
// Replaces the weak sites of K1 (apde_mvs_tpu/ops/pallas/sampler.py:38,
// `_sampler_kernel`, which the port ran as csrc/sampler.cu) and the torch
// ops around them: the JAX package's `deformable.ncc_weak`
// (apde_mvs_tpu/ops/deformable.py:124-198, `_per_view_ncc_weak` under a
// scan over views; the CUDA reference is APD.cu:448-593, :809-818) and
// `cost.geom_cost` (:400-418) at each plane of the weak sweep. The port
// ran it, per plane hypothesis, as two K1 launches (the (S, B, 36) centre
// taps and the (S, B, 8, 9) anchor taps), ~310 torch kernels and a
// torch-op geometric cost: 30 K1 launches and ~14,000 torch ops a weak
// chunk. Here one launch evaluates P planes a pixel for a chunk of weak
// pixels against every source view (the weak sweep's 10 candidates), or
// against the views a pixel weights (its 5 refinement probes), and writes
// only the (B, P, S) costs and, when the pass is geometric, the (B, P, S)
// geometric costs.
//
// Per (pixel, plane, view), in the order of the plain version
// (ops/cuda/weak.py, `weak_plain`; steps 1-4 are weak_common.cuh's
// `deformable_cost`, which K7, the weak sweep's chunk update, runs too):
//  1. the plane homography (ncc_common.cuh's `plane_homography`) and the
//     centre's out-of-image test against the real bounds: COST_MAX where
//     the centre leaves the image (nothing else is needed then);
//  2. the centre window: its taps warped, K1's sample, the Kahan sums in
//     tap order (weighted by the SA tap weights: 0/1 skips, no star, no
//     truncation), cost.ncc_from_sums (ncc_common.cuh's `window_cost`);
//  3. the 8 anchors in order: an anchor that is not valid does not count;
//     a valid one whose warp leaves the image counts at COST_MAX iff it
//     selected this view; one that stays in the image counts with its
//     9-tap sparse window's NCC iff its weight sum is > 0;
//  4. `deformable._softmax_weighted` over the counting anchors: their max,
//     exp(c - max), the sums of e and of e c in anchor order, one true
//     division, capped at COST_MAX; then 0.25 centre + 0.75 anchors, or
//     the centre's cost alone where no anchor counts;
//  5. with the geometric cost, K4's `geom_cost` (geom_common.cuh) of the
//     pair into its own output.
// A view whose weight is not > 0 gets COST_MAX and geometric cost 0 where
// view weights are given: the probes are only ever weighted by them, and
// 0 times either is +0, so the weighted sums equal the all-views sums bit
// for bit.
//
// Layout: a warp a pixel, 4 warps a block. The block stages the camera
// table and the two windows' offsets; each warp stages its pixel's
// reference side in its own slice of shared memory (about 1 KB: 36 centre
// and 72 anchor tap values, for SA their weights too, the anchors'
// coordinates, sums, reciprocal weight sums and selected views) and builds
// the pixel's list of views with one ballot. The pixel's (plane, view)
// pairs run across the lanes, plane-major (50 at the main path's 10
// candidates and 5 views: two passes of 32); every lane reads the same
// staged tap at the same step (a broadcast), and each keeps its anchors'
// costs in its own column of the warp's slice until the softmax. The
// staging is a few plain loads a lane against ~5,000 taps of work a pixel,
// so `cp.async` would hide nothing worth its code; tensor cores, `wgmma`
// and TMA tiles do not apply: the taps are gathers at data-dependent
// coordinates, and every f32 operation is rounded on its own (no FMA
// contraction) so that K6 equals its plain version bit for bit.
//
// Arithmetic equals the plain PyTorch version bit for bit: every operation
// is rounded on its own, in the order of the torch ops there
// (ncc_common.cuh says how); the exponential is expf, as torch.exp's.
// Since K7 the weak sweep's candidates and probes run inside K7, and the
// main path launches only the re-score form below.
//
// The re-score form (`rescore_weak_kernel`, plain version `weak.py`
// `rescore_plain`) replaces the initial cost's re-score
// (apde_mvs_tpu/ops/init.py:72-84 over deformable.py:30 `WeakRefData.build`
// and :190 `ncc_weak`), which the port ran as ~40 torch ops writing the
// reference side through device memory and this kernel's weak-sweep form
// with 5 of 32 lanes busy. It takes the weak list (x, y, anchors), the
// state's planes and prior selections, builds each pixel's reference side
// in shared memory with K7's `build_weak_ref` (weak_common.cuh), costs the
// pixel's own plane against every view and writes the S costs straight into
// the pixel's column of the initial cost's (S, H W) costs (or a compact
// block on the tile route); the pixels of a list are distinct, so no two
// warps write one cell. A warp takes 32 / S pixels (at most 8): it builds
// their sides one after another, then each lane costs one (pixel, view).
// Bound: operations (K6's counts on the pixels' own planes and the
// reference side's 4 a tap, chip_smoke.py's `rescore_bound`): 0.53 GFLOP
// at the APD scan's 65,536-pixel chunk, 0.008 ms; the kernel is held back
// by its pixels' reference sides, each a chain of dependent loads and
// serial sums in tap order.
//
// Bound: operations, counted as chip_smoke.py counts them (K6_OPS_*,
// `k6_bound`): per evaluated (pixel, plane, view) K2's 90 a pair and 38 a
// tap of the centre window (40 with SA weights), and per counting anchor
// 18 for its warp and test, 38 (40) a tap of its window and ~15 for its
// NCC, ~8 for its softmax terms; 115 for the geometric cost. At the
// chip_smoke chunk (22,034 pixels, 10 planes, 5 views) that is ~5 GFLOP:
// ~0.08 ms at the H100's 67 TFLOP/s of plain f32, against ~15 MB of
// inputs and outputs. The u8 quad tables (2.4 MB at 600x800x5) stay in
// the 50 MB L2.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "geom_common.cuh"
#include "ncc_common.cuh"
#include "weak_common.cuh"

namespace {

using namespace apde;

// a view's row of K6's camera table: K5's (K2's 16 columns, then the
// geometric columns); row S is the reference's
constexpr int kWeakCamStride = kGeomCamStride;
constexpr int kWarps = 4;             // a block's warps, a pixel each
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* quads;         // (S, quad_h * width, 4) u8 or f32
  const float* cams;         // (S + 1, 40)
  const float* src_depths;   // (S, depth_h, depth_w); read when kGeom
  int depth_h;
  int depth_w;
  const float* x;            // (B,)
  const float* y;            // (B,)
  const float* planes;       // (B, P, 4)
  int num_planes;
  const float* vw;           // (B, S) view weights, or null: every view
  // the centre window: shared offsets, per-pixel values, SA weights, sums
  const float* c_dx;         // (T,)
  const float* c_dy;
  const float* c_val;        // (B, T)
  const float* c_w;          // (B, T); read when kWeighted
  const float* c_sum_ref;    // (B,)
  const float* c_sum_rr;     // (B,)
  const float* c_wsum;       // (B,) or null
  float c_inv;               // the float32 1 / T where c_wsum is null
  // the anchors' sparse windows
  const float* a_dx;         // (T',)
  const float* a_dy;
  const float* a_x;          // (B, 8)
  const float* a_y;          // (B, 8)
  const uint8_t* a_valid;    // (B, 8) bool
  const uint8_t* a_sel;      // (B, 8, S) bool
  const float* a_val;        // (B, 8, T')
  const float* a_w;          // (B, 8, T'); read when kWeighted
  const float* a_sum_ref;    // (B, 8)
  const float* a_sum_rr;     // (B, 8)
  const float* a_wsum;       // (B, 8)
  float* out_ncc;            // (B, P, S)
  float* out_geom;           // (B, P, S); written when kGeom
  int64_t num_pix;
  int num_views;
  int num_taps;              // T
  int num_anchor_taps;       // T'
  int width;
  int quad_h;
  float img_w;               // real (unpadded) bounds of the warp tests
  float img_h;
};

// floats of a warp's slice: the centre's and the anchors' tap values (SA:
// the weight-value products) and weights, the anchors' x, y, sum_ref,
// sum_rr and 1 / wsum, their selected views (a word each), the pixel's
// view list, and a column of 8 anchor costs for each lane
__host__ __device__ inline size_t slice_floats(int num_taps,
                                               int num_anchor_taps,
                                               bool weighted) {
  return static_cast<size_t>(num_taps + kAnchors * num_anchor_taps) *
             (weighted ? 2 : 1) +
         5 * kAnchors + kAnchors + 32 + kAnchors * 32;
}

// the camera table, the two windows' offsets, then one slice a warp
__host__ __device__ inline size_t smem_floats(int num_views, int num_taps,
                                              int num_anchor_taps,
                                              bool weighted) {
  return static_cast<size_t>(num_views + 1) * kWeakCamStride +
         2 * static_cast<size_t>(num_taps + num_anchor_taps) +
         kWarps * slice_floats(num_taps, num_anchor_taps, weighted);
}

template <typename Q, bool kWeighted, bool kGeom, int kTaps, int kATaps>
__global__ void __launch_bounds__(kThreads) weak_kernel(const Params p) {
  extern __shared__ float smem[];
  const int S = p.num_views;
  const int P = p.num_planes;
  const int T = kTaps > 0 ? kTaps : p.num_taps;
  const int TA = kATaps > 0 ? kATaps : p.num_anchor_taps;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* s_cam = smem;
  float* s_cdx = s_cam + (S + 1) * kWeakCamStride;
  float* s_cdy = s_cdx + T;
  float* s_adx = s_cdy + T;
  float* s_ady = s_adx + TA;
  float* slice = s_ady + TA + warp * slice_floats(T, TA, kWeighted);
  float* w_cval = slice;
  float* w_aval = w_cval + T;
  float* w_ctw = w_aval + kAnchors * TA;          // kWeighted only
  float* w_atw = w_ctw + T;
  float* w_ax = slice + (T + kAnchors * TA) * (kWeighted ? 2 : 1);
  float* w_ay = w_ax + kAnchors;
  float* w_asr = w_ay + kAnchors;
  float* w_asrr = w_asr + kAnchors;
  float* w_ainv = w_asrr + kAnchors;
  unsigned* w_sel = reinterpret_cast<unsigned*>(w_ainv + kAnchors);
  int* w_views = reinterpret_cast<int*>(w_sel + kAnchors);
  float* w_cost = reinterpret_cast<float*>(w_views + 32);  // [8][32]

  // ---- the cameras and the offsets, once a block ------------------------
  for (int i = threadIdx.x; i < (S + 1) * kWeakCamStride; i += kThreads) {
    s_cam[i] = __ldg(p.cams + i);
  }
  for (int i = threadIdx.x; i < T; i += kThreads) {
    s_cdx[i] = __ldg(p.c_dx + i);
    s_cdy[i] = __ldg(p.c_dy + i);
  }
  for (int i = threadIdx.x; i < TA; i += kThreads) {
    s_adx[i] = __ldg(p.a_dx + i);
    s_ady[i] = __ldg(p.a_dy + i);
  }
  __syncthreads();

  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (b >= p.num_pix) return;
  const float* r = s_cam + S * kWeakCamStride;
  const Q* __restrict__ quads = static_cast<const Q*>(p.quads);
  const int64_t view_elems =
      static_cast<int64_t>(p.quad_h) * p.width * 4;   // a view's table

  // ---- the pixel's reference side ----------------------------------------
  const float x = __ldg(p.x + b);
  const float y = __ldg(p.y + b);
  PixelWindow cwin;
  cwin.dx = s_cdx;
  cwin.dy = s_cdy;
  cwin.val = w_cval;
  cwin.tw = w_ctw;
  cwin.sum_ref = __ldg(p.c_sum_ref + b);
  cwin.sum_rr = __ldg(p.c_sum_rr + b);
  cwin.inv = p.c_inv;
  cwin.empty = false;
  if (p.c_wsum != nullptr) {
    inverse_weight_sum(__ldg(p.c_wsum + b), &cwin.inv, &cwin.empty);
  }
  for (int i = lane; i < T; i += 32) {
    stage_tap<false, kWeighted>(p.c_val, p.c_w, nullptr, nullptr, b * T + i,
                                i, w_cval, w_ctw, nullptr, nullptr);
  }
  for (int i = lane; i < kAnchors * TA; i += 32) {
    stage_tap<false, kWeighted>(p.a_val, p.a_w, nullptr, nullptr,
                                b * kAnchors * TA + i, i, w_aval, w_atw,
                                nullptr, nullptr);
  }
  bool valid = false, positive = false;
  if (lane < kAnchors) {
    const int64_t a = b * kAnchors + lane;
    w_ax[lane] = __ldg(p.a_x + a);
    w_ay[lane] = __ldg(p.a_y + a);
    w_asr[lane] = __ldg(p.a_sum_ref + a);
    w_asrr[lane] = __ldg(p.a_sum_rr + a);
    const float ws = __ldg(p.a_wsum + a);
    bool empty;
    inverse_weight_sum(ws, &w_ainv[lane], &empty);
    valid = p.a_valid[a] != 0;
    positive = ws > 0.f;
  }
  // bit a: anchor a is valid; its weight sum is > 0
  const unsigned valid_bits = __ballot_sync(kFull, valid);
  const unsigned positive_bits = __ballot_sync(kFull, positive);
  for (int a = 0; a < kAnchors; ++a) {
    // bit s: anchor a selected view s
    const unsigned sel = __ballot_sync(
        kFull, lane < S && p.a_sel[(b * kAnchors + a) * S + lane] != 0);
    if (lane == 0) w_sel[a] = sel;
  }
  // bit s: view s is evaluated (every view, or those weighing > 0)
  const bool in_view =
      lane < S && (p.vw == nullptr || __ldg(p.vw + b * S + lane) > 0.f);
  const unsigned views = __ballot_sync(kFull, in_view);
  if (in_view) w_views[__popc(views & ((1u << lane) - 1u))] = lane;
  const int nv = __popc(views);
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

  // ---- the pixel's (plane, view) pairs across the lanes ------------------
  float* my_cost = w_cost + lane;   // anchor a's cost at my_cost[32 a]
  for (int k = lane; k < P * nv; k += 32) {
    const int pl = k / nv;
    const int s = w_views[k - pl * nv];
    const float* plane = p.planes + (b * P + pl) * 4;
    const float n0 = __ldg(plane + 0);
    const float n1 = __ldg(plane + 1);
    const float n2 = __ldg(plane + 2);
    const float w = __ldg(plane + 3);
    const float* c = s_cam + s * kWeakCamStride;
    float h[3][3];
    plane_homography(c, r, n0, n1, n2, w, h);
    const Q* __restrict__ tab = quads + s * view_elems;
    const float cost = deformable_cost<Q, kWeighted, kTaps, kATaps>(
        tab, h, x, y, T, TA, cwin, an, s, my_cost, p.width, p.quad_h,
        p.img_w, p.img_h);
    const int64_t at = (b * P + pl) * S + s;
    p.out_ncc[at] = cost;
    if constexpr (kGeom) {
      const float* dmap =
          p.src_depths + static_cast<int64_t>(s) * p.depth_h * p.depth_w;
      p.out_geom[at] = geom_cost(r + kGeomCols, c + kGeomCols, dmap,
                                 p.depth_h, p.depth_w, x, y, n0, n1, n2, w);
    }
  }
  // the views left out: COST_MAX and geometric cost 0
  if (nv < S) {
    for (int k = lane; k < P * S; k += 32) {
      const int s = k % S;
      if ((views >> s) & 1u) continue;
      const int64_t at = b * P * S + k;
      p.out_ncc[at] = kCostMax;
      if constexpr (kGeom) p.out_geom[at] = 0.f;
    }
  }
}

// ---- the re-score form: the initial cost's deformable NCC of a weak list -

// a warp's pixels in the re-score form: as many as fill its lanes with
// their S views, at most kRescoreMax
constexpr int kRescoreMax = 8;
__host__ __device__ inline int rescore_pixels(int num_views) {
  const int g = 32 / num_views;
  return g < kRescoreMax ? g : kRescoreMax;
}

// the main path's windows: the centre cost.square_taps(5, 2), the anchors'
// cost.square_taps(5, 5)
constexpr int kMainRadius = 5;
constexpr int kMainIncrement = 2;
constexpr int kMainAnchorIncrement = 5;

struct RescoreParams {
  const void* quads;         // (S, quad_h * width, 4) u8 or f32
  const float* cams;         // (S + 1, 40)
  const float* planes;       // (grid_h, grid_w, 4) the state's planes
  WeakRefSource src;         // the image, SA ids, the prior selections
  const int* x;              // (B,) int32
  const int* y;
  const int* anchors;        // (B, 9, 2) int32 (x, y), -1 where missing
  int c_radius;              // the centre's square
  int c_increment;
  int c_axis;
  int a_radius;              // the anchors' square
  int a_increment;
  int a_axis;
  float* out;                // the costs: out + s * view_stride + column
  int64_t view_stride;       //   * pixel_stride, the column the pixel's
  int64_t pixel_stride;      //   raster index (scatter) or its list index
  int scatter;
  int64_t num_pix;
  int num_views;
  int num_taps;              // T = c_axis^2
  int num_anchor_taps;       // T' = a_axis^2
  int quad_h;
  float img_w;               // real (unpadded) bounds of the warp tests
  float img_h;
};

// floats of a warp's slice in the re-score form: its pixels' reference
// sides, then K6's (8, 32) column of anchor costs a lane
__host__ __device__ inline size_t rescore_warp_floats(int num_views,
                                                      int num_taps,
                                                      int num_anchor_taps,
                                                      bool sa) {
  return static_cast<size_t>(rescore_pixels(num_views)) *
             weak_ref_floats(num_taps, num_anchor_taps, sa) +
         kAnchors * 32;
}

// the camera table, the two windows' offsets, then one slice a warp
__host__ __device__ inline size_t rescore_smem_floats(int num_views,
                                                      int num_taps,
                                                      int num_anchor_taps,
                                                      bool sa) {
  return static_cast<size_t>(num_views + 1) * kWeakCamStride +
         2 * static_cast<size_t>(num_taps + num_anchor_taps) +
         kWarps * rescore_warp_floats(num_views, num_taps, num_anchor_taps,
                                      sa);
}

// A warp takes G = rescore_pixels(S) consecutive pixels of the list and
// builds their reference sides one after another (weak_common.cuh's
// `build_weak_ref`, as K7 does); then lane l costs pixel l / S's own plane
// (the state's at the pixel) against view l % S (`deformable_cost`), so
// that G S of the 32 lanes work (30 at the main path's 5 views, where the
// weak-sweep form's one pixel a warp had 5).
template <typename Q, bool kSA, bool kMain>
__global__ void __launch_bounds__(kThreads)
rescore_weak_kernel(const RescoreParams p) {
  extern __shared__ float smem[];
  const int S = p.num_views;
  const int T = kMain ? kMainTaps : p.num_taps;
  const int TA = kMain ? kMainAnchorTaps : p.num_anchor_taps;
  const int G = rescore_pixels(S);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pf = weak_ref_floats(T, TA, kSA);
  float* s_cam = smem;
  float* s_cdx = s_cam + (S + 1) * kWeakCamStride;
  float* s_cdy = s_cdx + T;
  float* s_adx = s_cdy + T;
  float* s_ady = s_adx + TA;
  float* slice = s_ady + TA + warp * (G * pf + kAnchors * 32);
  float* w_acost = slice + G * pf;   // [8][32]

  // ---- the cameras and the two windows' offsets, once a block ----------
  for (int i = threadIdx.x; i < (S + 1) * kWeakCamStride; i += kThreads) {
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

  const int64_t b0 = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * G;
  if (b0 >= p.num_pix) return;
  const int n = p.num_pix - b0 < G ? static_cast<int>(p.num_pix - b0) : G;
  // ---- the warp's pixels' reference sides, one after another ------------
  const int mine = lane / S;   // this lane's pixel, n or more: none
  WeakRef ref = {};
  int mx = 0, my = 0;
  auto no_mark = [](int, bool, int, int) { return false; };
  for (int g = 0; g < n; ++g) {
    const int64_t b = b0 + g;
    const int xi = __ldg(p.x + b);
    const int yi = __ldg(p.y + b);
    const WeakRef r = build_weak_ref<kSA>(
        p.src, xi, yi, p.anchors + b * (kAnchors + 1) * 2, T, TA, s_cdx,
        s_cdy, s_adx, s_ady, weak_ref_slice<kSA>(slice + g * pf, T, TA),
        lane, no_mark);
    if (g == mine) {
      ref = r;
      mx = xi;
      my = yi;
    }
  }
  __syncwarp();
  if (mine >= n) return;

  // ---- lane l: pixel l / S's own plane against view l % S ----------------
  const int s = lane - mine * S;
  const int64_t at = static_cast<int64_t>(my) * p.src.grid_w + mx;
  const float* plane = p.planes + 4 * at;
  const float* c = s_cam + s * kWeakCamStride;
  const float* r = s_cam + S * kWeakCamStride;
  float h[3][3];
  plane_homography(c, r, __ldg(plane + 0), __ldg(plane + 1),
                   __ldg(plane + 2), __ldg(plane + 3), h);
  const Q* __restrict__ tab =
      static_cast<const Q*>(p.quads) +
      static_cast<int64_t>(s) * p.quad_h * p.src.width * 4;
  const float x = static_cast<float>(mx);
  const float y = static_cast<float>(my);
  const float cost =
      deformable_cost<Q, kSA, kMain ? kMainTaps : 0,
                      kMain ? kMainAnchorTaps : 0>(
          tab, h, x, y, T, TA, ref.cwin, ref.an, s, w_acost + lane,
          p.src.width, p.quad_h, p.img_w, p.img_h);
  const int64_t column = p.scatter ? at : b0 + mine;
  p.out[s * p.view_stride + column * p.pixel_stride] = cost;
}

using RescoreKernel = void (*)(const RescoreParams);

template <typename Q, bool kSA>
RescoreKernel pick_rescore_windows(bool main_windows) {
  return main_windows ? rescore_weak_kernel<Q, kSA, true>
                      : rescore_weak_kernel<Q, kSA, false>;
}

// the re-score form's instantiation for a table type, SA and the main
// path's windows (the centre of radius 5, increment 2, the anchors of
// radius 5, increment 5) or others
RescoreKernel pick_rescore(bool quads_u8, bool sa, bool main_windows) {
  if (quads_u8) {
    return sa ? pick_rescore_windows<uint8_t, true>(main_windows)
              : pick_rescore_windows<uint8_t, false>(main_windows);
  }
  return sa ? pick_rescore_windows<float, true>(main_windows)
            : pick_rescore_windows<float, false>(main_windows);
}

bool is_main(int c_radius, int c_increment, int a_radius, int a_increment) {
  return c_radius == kMainRadius && c_increment == kMainIncrement &&
         a_radius == kMainRadius && a_increment == kMainAnchorIncrement;
}

// taps an axis of the square of (radius, increment): cost.square_taps
int axis_taps(int radius, int increment) {
  return 2 * radius / increment + 1;
}

size_t rescore_smem_bytes(int num_views, int c_radius, int c_increment,
                          int a_radius, int a_increment, bool sa) {
  const int cn = axis_taps(c_radius, c_increment);
  const int an = axis_taps(a_radius, a_increment);
  return rescore_smem_floats(num_views, cn * cn, an * an, sa) *
         sizeof(float);
}

using Kernel = void (*)(const Params);

template <typename Q, bool kWeighted, bool kGeom>
Kernel pick_taps(int num_taps, int num_anchor_taps) {
  return num_taps == kMainTaps && num_anchor_taps == kMainAnchorTaps
             ? weak_kernel<Q, kWeighted, kGeom, kMainTaps, kMainAnchorTaps>
             : weak_kernel<Q, kWeighted, kGeom, 0, 0>;
}

template <typename Q>
Kernel pick_form(bool weighted, bool geom, int num_taps, int num_anchor_taps) {
  if (weighted) {
    return geom ? pick_taps<Q, true, true>(num_taps, num_anchor_taps)
                : pick_taps<Q, true, false>(num_taps, num_anchor_taps);
  }
  return geom ? pick_taps<Q, false, true>(num_taps, num_anchor_taps)
              : pick_taps<Q, false, false>(num_taps, num_anchor_taps);
}

// the instantiation for a table type, SA weights, geometric cost and the
// two windows' tap counts
Kernel pick(bool quads_u8, bool weighted, bool geom, int num_taps,
            int num_anchor_taps) {
  return quads_u8
             ? pick_form<uint8_t>(weighted, geom, num_taps, num_anchor_taps)
             : pick_form<float>(weighted, geom, num_taps, num_anchor_taps);
}

// its shared memory, with the attribute set where it passes 48 KB
template <typename K>
cudaError_t prepare(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// Plain C interface for ctypes. Every pointer is a device pointer (c_w,
// a_w, c_wsum, vw, src_depths and out_geom may be null: null weights mean
// every tap weighs 1, a null c_wsum takes c_inv, a null vw evaluates every
// view, a null src_depths no geometric cost); the function returns
// cudaGetLastError() after its launch (0 = cudaSuccess), or the error of
// the shared-memory attribute.
extern "C" {

int apde_weak_max_views() { return kMaxViews; }

int apde_weak_cam_stride() { return kWeakCamStride; }

int apde_weak_anchors() { return kAnchors; }

long long apde_weak_smem_bytes(int num_views, int num_taps,
                               int num_anchor_taps, int weighted) {
  return static_cast<long long>(
      smem_floats(num_views, num_taps, num_anchor_taps, weighted != 0) *
      sizeof(float));
}

// The instantiation's registers, local memory (spills) and resident blocks
// an SM (the CUDA runtime's occupancy calculator) at S views; returns the
// first error.
int apde_weak_kernel_info(int quads_u8, int weighted, int geom, int num_taps,
                          int num_anchor_taps, int num_views, int* regs,
                          int* local_bytes, int* blocks_per_sm) {
  const Kernel kernel = pick(quads_u8 != 0, weighted != 0, geom != 0,
                             num_taps, num_anchor_taps);
  const size_t bytes =
      smem_floats(num_views, num_taps, num_anchor_taps, weighted != 0) *
      sizeof(float);
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

int apde_weak(const void* quads, int quads_u8, const void* cams,
              const void* src_depths, int depth_h, int depth_w,
              const void* x, const void* y, const void* planes,
              int num_planes, const void* vw, const void* c_dx,
              const void* c_dy, const void* c_val, const void* c_w,
              const void* c_sum_ref, const void* c_sum_rr,
              const void* c_wsum, float c_inv, const void* a_dx,
              const void* a_dy, const void* a_x, const void* a_y,
              const void* a_valid, const void* a_sel, const void* a_val,
              const void* a_w, const void* a_sum_ref, const void* a_sum_rr,
              const void* a_wsum, void* out_ncc, void* out_geom,
              int64_t num_pix, int num_views, int num_taps,
              int num_anchor_taps, int width, int quad_h, int img_w,
              int img_h, void* stream) {
  if (num_pix <= 0) return static_cast<int>(cudaGetLastError());
  const bool weighted = c_w != nullptr;
  const bool geom = src_depths != nullptr;
  if (num_views < 1 || num_views > kMaxViews || num_taps < 1 ||
      num_anchor_taps < 1 || num_planes < 1 ||
      weighted != (a_w != nullptr) || geom != (out_geom != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.quads = quads;
  p.cams = static_cast<const float*>(cams);
  p.src_depths = static_cast<const float*>(src_depths);
  p.depth_h = depth_h;
  p.depth_w = depth_w;
  p.x = static_cast<const float*>(x);
  p.y = static_cast<const float*>(y);
  p.planes = static_cast<const float*>(planes);
  p.num_planes = num_planes;
  p.vw = static_cast<const float*>(vw);
  p.c_dx = static_cast<const float*>(c_dx);
  p.c_dy = static_cast<const float*>(c_dy);
  p.c_val = static_cast<const float*>(c_val);
  p.c_w = static_cast<const float*>(c_w);
  p.c_sum_ref = static_cast<const float*>(c_sum_ref);
  p.c_sum_rr = static_cast<const float*>(c_sum_rr);
  p.c_wsum = static_cast<const float*>(c_wsum);
  p.c_inv = c_inv;
  p.a_dx = static_cast<const float*>(a_dx);
  p.a_dy = static_cast<const float*>(a_dy);
  p.a_x = static_cast<const float*>(a_x);
  p.a_y = static_cast<const float*>(a_y);
  p.a_valid = static_cast<const uint8_t*>(a_valid);
  p.a_sel = static_cast<const uint8_t*>(a_sel);
  p.a_val = static_cast<const float*>(a_val);
  p.a_w = static_cast<const float*>(a_w);
  p.a_sum_ref = static_cast<const float*>(a_sum_ref);
  p.a_sum_rr = static_cast<const float*>(a_sum_rr);
  p.a_wsum = static_cast<const float*>(a_wsum);
  p.out_ncc = static_cast<float*>(out_ncc);
  p.out_geom = static_cast<float*>(out_geom);
  p.num_pix = num_pix;
  p.num_views = num_views;
  p.num_taps = num_taps;
  p.num_anchor_taps = num_anchor_taps;
  p.width = width;
  p.quad_h = quad_h;
  p.img_w = static_cast<float>(img_w);
  p.img_h = static_cast<float>(img_h);
  const Kernel kernel =
      pick(quads_u8 != 0, weighted, geom, num_taps, num_anchor_taps);
  const size_t bytes =
      smem_floats(num_views, num_taps, num_anchor_taps, weighted) *
      sizeof(float);
  const cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int grid =
      static_cast<unsigned int>((num_pix + kWarps - 1) / kWarps);
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

long long apde_weak_rescore_smem_bytes(int num_views, int c_radius,
                                       int c_increment, int a_radius,
                                       int a_increment, int sa) {
  return static_cast<long long>(rescore_smem_bytes(
      num_views, c_radius, c_increment, a_radius, a_increment, sa != 0));
}

// The re-score form's registers, local memory (spills) and resident blocks
// an SM at S views; returns the first error.
int apde_weak_rescore_kernel_info(int quads_u8, int sa, int c_radius,
                                  int c_increment, int a_radius,
                                  int a_increment, int num_views, int* regs,
                                  int* local_bytes, int* blocks_per_sm) {
  const RescoreKernel kernel =
      pick_rescore(quads_u8 != 0, sa != 0,
                   is_main(c_radius, c_increment, a_radius, a_increment));
  const size_t bytes = rescore_smem_bytes(num_views, c_radius, c_increment,
                                          a_radius, a_increment, sa != 0);
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

// The re-score form on num_pix weak pixels (x, y) with their anchors: each
// pixel's own plane from ``planes`` (grid_h, grid_w, 4) against every view,
// its reference side built from ``ref`` (ref_h, width), the SA ids ``sa``
// (null: no SA) and the prior selections ``selected`` (grid_h, grid_w, S);
// view s's cost at out + s * view_stride + column * pixel_stride, the
// column the pixel's raster index y * grid_w + x (``scatter``) or its
// index in the list.
int apde_weak_rescore(const void* quads, int quads_u8, const void* cams,
                      const void* planes, const void* selected, int grid_h,
                      int grid_w, const void* x, const void* y,
                      const void* anchors, const void* ref, int ref_h,
                      const void* sa, int c_radius, int c_increment,
                      int a_radius, int a_increment, void* out,
                      int64_t view_stride, int64_t pixel_stride, int scatter,
                      int64_t num_pix, int num_views, int width, int quad_h,
                      int img_w, int img_h, void* stream) {
  if (num_pix <= 0) return static_cast<int>(cudaGetLastError());
  if (num_views < 1 || num_views > kMaxViews || c_radius < 0 ||
      c_increment < 1 || a_radius < 0 || a_increment < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RescoreParams p;
  p.quads = quads;
  p.cams = static_cast<const float*>(cams);
  p.planes = static_cast<const float*>(planes);
  p.src.ref = static_cast<const float*>(ref);
  p.src.sa = static_cast<const int*>(sa);
  p.src.ref_h = ref_h;
  p.src.width = width;
  p.src.selected = static_cast<const uint8_t*>(selected);
  p.src.grid_h = grid_h;
  p.src.grid_w = grid_w;
  p.src.num_views = num_views;
  p.x = static_cast<const int*>(x);
  p.y = static_cast<const int*>(y);
  p.anchors = static_cast<const int*>(anchors);
  p.c_radius = c_radius;
  p.c_increment = c_increment;
  p.c_axis = axis_taps(c_radius, c_increment);
  p.a_radius = a_radius;
  p.a_increment = a_increment;
  p.a_axis = axis_taps(a_radius, a_increment);
  p.out = static_cast<float*>(out);
  p.view_stride = view_stride;
  p.pixel_stride = pixel_stride;
  p.scatter = scatter;
  p.num_pix = num_pix;
  p.num_views = num_views;
  p.num_taps = p.c_axis * p.c_axis;
  p.num_anchor_taps = p.a_axis * p.a_axis;
  p.quad_h = quad_h;
  p.img_w = static_cast<float>(img_w);
  p.img_h = static_cast<float>(img_h);
  const bool with_sa = p.src.sa != nullptr;
  const RescoreKernel kernel = pick_rescore(
      quads_u8 != 0, with_sa,
      is_main(c_radius, c_increment, a_radius, a_increment));
  const size_t bytes = rescore_smem_bytes(num_views, c_radius, c_increment,
                                          a_radius, a_increment, with_sa);
  const cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t per_block =
      static_cast<int64_t>(kWarps) * rescore_pixels(num_views);
  const unsigned int grid =
      static_cast<unsigned int>((num_pix + per_block - 1) / per_block);
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
