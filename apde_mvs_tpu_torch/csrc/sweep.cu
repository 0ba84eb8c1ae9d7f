// K5 — the disparity sweeps of DepthToWeak and LocalRefine, hand-written for
// Hopper (sm_90a), with the geometric-consistency cost (K4) inside.
//
// Replaces the probe loops of the JAX package's `filters.depth_to_weak` and
// `filters.local_refine` (apde_mvs_tpu/ops/filters.py:234, :476, around
// `_sweep_cost` :196 and `cost.geom_cost` :418; XLA-compiled jnp, no
// Pallas; the CUDA reference is APD.cu:2103-2250 and :2346-2432). The port
// ran them as a Python loop over probe depths, each probe one launch of K2
// (ncc.cu) plus ~25 torch ops (over 100 with the geometric cost). Here one
// launch runs a whole sweep for a chunk of pixels against every source
// view and writes only its output: the (B, 61) cost curve of DepthToWeak
// (classify), or the (B, 12) costs of LocalRefine (refine: the current
// depth, unmasked, then the 11 probes).
//
// Per probe k, per pixel: the probe depth f * baseline / (disp + offset)
// (`filters.probe_depths`), the plane with the pixel's fixed camera-frame
// normal through that depth (w of `geometry.plane_dist_to_origin`, its
// three products summed in order); per (pixel, view): K2's strong NCC
// (ncc_common.cuh, the same code K2 runs), plus geom_factor times the
// geometric cost K4 of `cost.geom_cost` (geom_common.cuh, the same code K3
// runs: depth from the plane, back-projection
// to the world, projection into the source view, the source depth at the
// truncated texel with `sampling.trunc_index`'s saturation, back-projection
// and projection into the reference, the reprojection distance clamped at
// 3; 3 for a missing source depth or a non-finite result); then the
// selection-gated weighted mean over the views, in view order s = 0 .. S-1
// from 0, divided by clamp(wnorm, 1e-20), COST_MAX where wnorm <= 0 or the
// probe depth lies outside [depth_min, depth_max], and in classify mode
// clamped at COST_MAX.
//
// Layout: a warp a pixel, the pixel's weighted views in view order, its
// probes across the lanes. A block is 4 warps, so 4 pixels: a block ends
// when its slowest pixel does, and pixels differ in their weighted views,
// so blocks stay small. The block stages the camera table; each warp
// stages its pixel's window (tap values; for an SA window the per-pixel
// offsets, the weights and the weight-value products) in its own slice of
// shared memory, and builds the pixel's list of weighted views with one
// ballot over its lanes (lane s holds the weight of view s; a weight
// counts where it is != 0, so NaN does and -0 does not). Only those
// (pixel, view) pairs run: a view whose weight is +-0 adds +-0 to the sum
// (its cost is finite and >= 0), which leaves the sum unchanged (it starts
// at +0 and never becomes -0), so leaving it out keeps the sum bit for
// bit; a pixel whose weight sum is not > 0 runs none (every probe is
// COST_MAX). The lanes run the probes: classify's 61 in two passes of 32;
// refine's 12 in one pass of two half-warps, each half taking every other
// weighted view, the two terms of a round added in view order after a
// shuffle. Each lane keeps its probe's running view sum in a register,
// adding the views in order s = 0 .. S-1 from +0 as the plain version
// does; no barrier follows the block's start. The window taps every lane
// reads are one shared-memory word (a broadcast); the lanes' samples lie
// along one epipolar segment of one source table. The curve is stored a
// pixel row at a time, coalesced.
//
// Two forms of the kernel run that sweep. The sweep form takes a chunk's
// per-pixel inputs (``SweepPixels``: the camera-frame plane, disparity,
// baseline, view weights and their sum) and its reference window from
// device memory and writes the (B, 61) or (B, 12) costs. The stage form is
// the whole of DepthToWeak or LocalRefine for a chunk of pixels (x, y)
// int32, one launch with no torch op around it:
//  - the setup (`filters._sweep_scalars`): from the state's maps (the
//    planes' world normal and depth, the selections, the view weights, the
//    valid mask, 0 outside the maps) the camera-frame normal R n (each row
//    ((a + b) + c), as geometry.mat3_vec), the selection-gated weights, their
//    sum, the baseline (the selected views' camera distances, passed in as
//    an (S,) table, summed and divided by their count), the disparity and
//    the setup's ok; every sum in view order from +0 (shuffles);
//  - the reference window, built by window_common.cuh as K3 builds it;
//  - the sweep, as the sweep form runs it;
//  - the decision rule in the epilogue. Classify (`filters._classify_peaks`):
//    the 61-value curve across the warp, two values a lane (probes j and
//    j + 32); the strict inner minima over i in [2, 58] (one shuffle each
//    way); their count (two ballots); the first minimum among them (a
//    butterfly on (value, index), the lower index on a tie), min_peak = 0
//    and a cost of 2 unless it is below 2; the distance and cost rules; the
//    variance of the other peaks, its squares summed in index order from
//    +0; the margin, ok and valid guards; the int32 class, and with
//    ``curve_out`` the curve. Refine (`filters._refine_depths`): the 12
//    costs across lanes 0..11, a COST_MAX start, the first strict minimum
//    of the probes with NaN as +inf, its depth taken on an improvement of
//    more than 0.1, then ok, wnorm > 0 and valid; the new depth.
//
// Arithmetic equals the plain PyTorch versions (ops/cuda/sweep.py,
// `sweep_plain` and `stage_plain`) bit for bit: every operation is rounded on its own, in the
// order of the torch ops there (ncc_common.cuh says how).
//
// Bound: operations, counted as chip_smoke.py counts them (K2_OPS_*,
// K5_OPS_*, `k5_bound`). Per (pixel, view, probe) whose weight is not 0,
// K2's 38 f32 operations a tap (40 on an SA window) and 90 a pair, 2 for
// the weighting and 115 for the geometric cost; per (pixel, probe) 22 for
// the probe depth, the plane and the masks, and 36 for the geometric
// cost's depth and back-projection. At S = 10, B = 65,536, 61 probes, 36
// taps and 32.5% of the pairs weighted (3.5 views a pixel) that is 20.7
// GFLOP: 0.309 ms at the H100's 67 TFLOP/s of plain f32, against 69 MB of
// inputs and curve (0.02 ms at 3.35 TB/s). The u8 quad tables (19.2 MB at
// 600x800x10) and the f32 source depth maps (19.2 MB) together fit the
// 50 MB L2; f32 quad tables (76.8 MB) do not. No matrix product, so no
// tensor core work. The stage form adds the setup's ~10 operations a
// (pixel, view) and ~30 a pixel, the window's 4 a (pixel, tap) and the
// rule's ~20 a probe (K5_STAGE_OPS_*); it reads the state's cells of the
// chunk's pixels, the reference image rows it touches and writes 4 bytes
// a pixel (the curve too with ``curve_out``).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "geom_common.cuh"
#include "ncc_common.cuh"
#include "window_common.cuh"

namespace {

using namespace apde;

// a view's row of K5's camera table: K2's 16 columns, then the view's own
// R (9, row-major), t (3), K (9, row-major), world centre c (3) for the
// geometric cost; row S is the reference's
constexpr int kSweepCamStride = kGeomCamStride;
constexpr int kWarps = 4;             // a block's warps, a pixel each
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxProbes = 64;        // two passes of 32 lanes
// config: RELIABLE_CURVE_SAMPLE_NUM, the pixel states
constexpr int kCurve = 61;
constexpr int kCurveRadius = (kCurve - 1) / 2;
constexpr int kWeak = 0;
constexpr int kStrong = 1;
constexpr int kUnknown = 2;
constexpr int kRefineProbes = 12;

// what every launch of either form shares
struct Sweep {
  const void* quads;         // (S, quad_h * width, 4) u8 or f32
  const float* cams;         // (S + 1, 40)
  const float* src_depths;   // (S, depth_h, depth_w) or null (no geom)
  int depth_h;
  int depth_w;
  float geom_factor;
  float depth_min;
  float depth_max;
  int refine;                // 1: column 0 is the current depth, unmasked
  int num_probes;            // output columns: 61 classify, 12 refine
  int first_disp;            // disparity offset of the first swept probe
  int64_t num_pix;
  int num_views;
  int num_taps;
  int width;
  int quad_h;
  float img_w;               // real (unpadded) bounds of the centre test
  float img_h;
};

// the sweep form: a chunk's per-pixel inputs and window from memory
struct Params {
  Sweep c;
  const float* x;            // (B,)
  const float* y;            // (B,)
  const float* planes;       // (B, 4): camera-frame normal, depth
  const float* disp;         // (B,)
  const float* base_line;    // (B,)
  const float* vw;           // (B, S) selection-gated view weights
  const float* wnorm;        // (B,)
  const float* tap_dx;       // (T,) shared, or (B, T) per pixel
  const float* tap_dy;
  const float* tap_val;      // (B, T)
  const float* tap_w;        // (B, T) or null (every tap weighs 1)
  const float* sum_ref;      // (B,)
  const float* sum_rr;       // (B,)
  const float* wsum;         // (B,) or null
  float inv_wsum;            // the float32 1 / T where wsum is null
  float* out;                // (B, num_probes)
};

// the stage form: DepthToWeak or LocalRefine from the state's maps
struct StageParams {
  Sweep c;
  const int* x;              // (B,) int32
  const int* y;
  const float* planes;       // (grid_h, grid_w, 4): world normal, depth
  const uint8_t* selected;   // (grid_h, grid_w, S) bool
  const float* view_weights; // (grid_h, grid_w, S)
  const uint8_t* valid;      // (grid_h, grid_w) bool
  int grid_h;
  int grid_w;
  const float* dists;        // (S,) |c_ref - c_src|
  WindowSource win;          // the reference image, SA ids, the square
  float weak_peak_radius;
  int margin;                // full_pass.MIN_MARGIN
  int img_wi;                // real (unpadded) bounds of the margin test
  int img_hi;
  int* weak_out;             // (B,) int32 classes (classify)
  float* curve_out;          // (B, 61) or null (classify)
  float* depth_out;          // (B,) new depths (refine)
};

// rows of a warp's window slice in shared memory: the tap values (weighted:
// the weight-value products), the weights, the per-pixel offsets
__host__ __device__ inline int slice_rows(bool pixel_offsets, bool weighted) {
  return 1 + (weighted ? 1 : 0) + (pixel_offsets ? 2 : 0);
}

// the camera table, the shared offsets, then one window slice a warp (rows
// of T floats: every lane of a warp reads the same word, a broadcast)
__host__ __device__ inline size_t smem_floats(int num_views, int num_taps,
                                              bool pixel_offsets,
                                              bool weighted) {
  return static_cast<size_t>(num_views + 1) * kSweepCamStride +
         (pixel_offsets ? 0 : 2 * static_cast<size_t>(num_taps)) +
         static_cast<size_t>(kWarps) * num_taps *
             slice_rows(pixel_offsets, weighted);
}

// A pixel's sweep inputs, every lane of its warp holding them: its
// coordinates, camera-frame normal, current depth, disparity, f * baseline,
// weight sum, lane s's view weight and the weighted views (bit s: view s)
struct Pixel {
  float x, y, n0, n1, n2, depth, disp, fb, wnorm, my_vw;
  unsigned views;
};

// The lanes: G groups of L lanes (L the power of two >= P, at most 32);
// lane j of a group runs probes j, j + L, ...; the groups take the pixel's
// weighted views in turn.
struct Lanes {
  int L, G, g, j, passes;
};

__device__ __forceinline__ Lanes lanes_for(int P, int lane) {
  Lanes l;
  l.L = 2;
  while (l.L < P && l.L < 32) l.L <<= 1;
  l.G = 32 / l.L;
  l.g = lane / l.L;
  l.j = lane % l.L;
  l.passes = (P + l.L - 1) / l.L;
  return l;
}

// One pass of the sweep, every lane of the warp calling it: the cost of
// probe k = j + L pass (valid on group 0's lanes where k < P), and its
// depth in ``probe_depth``.
template <typename Q, bool kWeighted, int kTaps>
__device__ __forceinline__ float sweep_pass(const Sweep& p, const float* s_cam,
                                            const PixelWindow& win,
                                            const Pixel& px, int T,
                                            const Lanes& l, int pass,
                                            float* probe_depth) {
  const int S = p.num_views;
  const int P = p.num_probes;
  const float* r = s_cam + S * kSweepCamStride;
  const float fx_r = r[12], fy_r = r[13], cx_r = r[14], cy_r = r[15];
  const Q* __restrict__ quads = static_cast<const Q*>(p.quads);
  const int64_t view_elems =
      static_cast<int64_t>(p.quad_h) * p.width * 4;   // a view's table
  const int k = l.j + l.L * pass;
  // the probe depth (filters.probe_depths) and its bounds
  float pd = px.depth, lo = -INFINITY, hi = INFINITY;
  if (!(p.refine && k == 0)) {
    const float d =
        add(px.disp, static_cast<float>(p.first_disp + k - p.refine));
    pd = dvd(px.fb, d != 0.f ? d : 1e-20f);
    lo = p.depth_min;
    hi = p.depth_max;
  }
  *probe_depth = pd;
  // the plane through it: w = -((n0 X + n1 Y) + n2 Z) of the
  // back-projected point (geometry.plane_dist_to_origin)
  const float X = dvd(mul(pd, sub(px.x, cx_r)), fx_r);
  const float Y = dvd(mul(pd, sub(px.y, cy_r)), fy_r);
  const float w =
      -add(add(mul(px.n0, X), mul(px.n1, Y)), mul(px.n2, pd));

  // the weighted views in order, G a round: group g takes the g-th
  float acc = 0.f;
  unsigned rest = px.views;
  while (rest != 0u) {
    int mine = -1, count = 0;
    for (; count < l.G && rest != 0u; ++count) {
      if (count == l.g) mine = __ffs(rest) - 1;
      rest &= rest - 1;
    }
    const float weight = __shfl_sync(kFull, px.my_vw, mine < 0 ? 0 : mine);
    float term = 0.f;
    if (mine >= 0 && k < P) {
      const float* c = s_cam + mine * kSweepCamStride;
      float h[3][3];
      plane_homography(c, r, px.n0, px.n1, px.n2, w, h);
      float cv = window_ncc<Q, kWeighted, kTaps>(
          quads + mine * view_elems, h, px.x, px.y, T, win, p.width,
          p.quad_h, p.img_w, p.img_h);
      if (p.src_depths != nullptr) {
        const float* dmap = p.src_depths +
                            static_cast<int64_t>(mine) * p.depth_h *
                                p.depth_w;
        cv = add(cv, mul(p.geom_factor,
                         geom_cost(r + kGeomCols, c + kGeomCols, dmap,
                                   p.depth_h, p.depth_w, px.x, px.y, px.n0,
                                   px.n1, px.n2, w)));
      }
      term = mul(weight, cv);
    }
    // the round's terms in view order: group 0's view comes first
    for (int i = 0; i < count; ++i) {
      acc = add(acc,
                l.G == 1 ? term : __shfl_sync(kFull, term, i * l.L + l.j));
    }
  }
  float cost = dvd(acc, clamp_min_keep_nan(px.wnorm, 1e-20f));
  cost = px.wnorm > 0.f ? cost : kCostMax;
  cost = (pd >= lo && pd <= hi) ? cost : kCostMax;
  if (!p.refine) cost = cost > kCostMax ? kCostMax : cost;
  return cost;
}

template <typename Q, bool kPixelOffsets, bool kWeighted, int kTaps>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const Params p) {
  extern __shared__ float smem[];
  const int S = p.c.num_views;
  const int T = kTaps > 0 ? kTaps : p.c.num_taps;
  const int P = p.c.num_probes;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* s_cam = smem;
  float* s_off = s_cam + (S + 1) * kSweepCamStride;
  float* slice = s_off + (kPixelOffsets ? 0 : 2 * T) +
                 warp * T * slice_rows(kPixelOffsets, kWeighted);
  float* w_val = slice;
  float* w_tw = slice + T;
  float* w_dx = kPixelOffsets ? slice + (kWeighted ? 2 : 1) * T : s_off;
  float* w_dy = kPixelOffsets ? w_dx + T : s_off + T;

  // ---- the cameras and the shared offsets, once a block -----------------
  for (int i = threadIdx.x; i < (S + 1) * kSweepCamStride; i += kThreads) {
    s_cam[i] = __ldg(p.c.cams + i);
  }
  if (!kPixelOffsets) {
    for (int i = threadIdx.x; i < T; i += kThreads) {
      s_off[i] = __ldg(p.tap_dx + i);
      s_off[T + i] = __ldg(p.tap_dy + i);
    }
  }
  __syncthreads();

  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (b >= p.c.num_pix) return;
  const float fx_r = s_cam[S * kSweepCamStride + 12];
  const Lanes l = lanes_for(P, lane);

  // ---- the pixel: scalars, weighted views, window ------------------------
  Pixel px;
  px.x = __ldg(p.x + b);
  px.y = __ldg(p.y + b);
  px.n0 = __ldg(p.planes + 4 * b + 0);
  px.n1 = __ldg(p.planes + 4 * b + 1);
  px.n2 = __ldg(p.planes + 4 * b + 2);
  px.depth = __ldg(p.planes + 4 * b + 3);
  px.disp = __ldg(p.disp + b);
  px.fb = mul(fx_r, __ldg(p.base_line + b));
  px.wnorm = __ldg(p.wnorm + b);
  px.my_vw = lane < S ? __ldg(p.vw + b * S + lane) : 0.f;
  // bit s: view s weighs != 0; none where wnorm <= 0 (COST_MAX anyway)
  px.views =
      __ballot_sync(kFull, px.my_vw != 0.f) & (px.wnorm > 0.f ? kFull : 0u);
  PixelWindow win;
  win.dx = w_dx;
  win.dy = w_dy;
  win.val = w_val;
  win.tw = w_tw;
  win.sum_ref = __ldg(p.sum_ref + b);
  win.sum_rr = __ldg(p.sum_rr + b);
  win.inv = p.inv_wsum;
  win.empty = false;
  if (p.wsum != nullptr) {
    inverse_weight_sum(__ldg(p.wsum + b), &win.inv, &win.empty);
  }
  for (int i = lane; i < T; i += 32) {
    stage_tap<kPixelOffsets, kWeighted>(p.tap_val, p.tap_w, p.tap_dx,
                                        p.tap_dy, b * T + i, i, w_val,
                                        w_tw, w_dx, w_dy);
  }
  __syncwarp();

  for (int pass = 0; pass < l.passes; ++pass) {
    float pd;
    const float cost = sweep_pass<Q, kWeighted, kTaps>(p.c, s_cam, win, px,
                                                       T, l, pass, &pd);
    const int k = l.j + l.L * pass;
    if (l.g == 0 && k < P) p.out[b * P + k] = cost;
  }
}

// The stage form: DepthToWeak (classify) or LocalRefine (refine) of pixel
// (x[b], y[b]) from the state's maps, a warp a pixel.
template <typename Q, bool kSA, int kTaps>
__global__ void __launch_bounds__(kThreads)
stage_sweep_kernel(const StageParams p) {
  extern __shared__ float smem[];
  const int S = p.c.num_views;
  const int T = kTaps > 0 ? kTaps : p.c.num_taps;
  const int P = p.c.num_probes;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* s_cam = smem;
  float* s_off = s_cam + (S + 1) * kSweepCamStride;
  float* slice =
      s_off + (kSA ? 0 : 2 * T) + warp * T * slice_rows(kSA, kSA);
  float* w_val = slice;
  float* w_tw = slice + T;
  float* w_dx = kSA ? slice + 2 * T : s_off;
  float* w_dy = kSA ? w_dx + T : s_off + T;

  // ---- the cameras and the square's offsets, once a block ---------------
  for (int i = threadIdx.x; i < (S + 1) * kSweepCamStride; i += kThreads) {
    s_cam[i] = __ldg(p.c.cams + i);
  }
  if (!kSA) {
    for (int i = threadIdx.x; i < T; i += kThreads) {
      int dx, dy;
      square_offsets<false>(p.win, i, &dx, &dy);
      s_off[i] = static_cast<float>(dx);
      s_off[T + i] = static_cast<float>(dy);
    }
  }
  __syncthreads();

  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (b >= p.c.num_pix) return;
  const float* r = s_cam + S * kSweepCamStride;
  const float fx_r = r[12];
  const float* R = r + kGeomCols;   // the reference camera's rotation

  // ---- the setup (filters._sweep_scalars): fetch, 0 outside the maps -----
  const int xi = __ldg(p.x + b);
  const int yi = __ldg(p.y + b);
  const bool inb = xi >= 0 && xi < p.grid_w && yi >= 0 && yi < p.grid_h;
  const int64_t at = inb ? static_cast<int64_t>(yi) * p.grid_w + xi : 0;
  float pw[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) pw[i] = inb ? __ldg(p.planes + 4 * at + i) : 0.f;
  Pixel px;
  px.x = static_cast<float>(xi);
  px.y = static_cast<float>(yi);
  // geometry.normal_world_to_cam: R n, each row ((a + b) + c)
  px.n0 = add(add(mul(R[0], pw[0]), mul(R[1], pw[1])), mul(R[2], pw[2]));
  px.n1 = add(add(mul(R[3], pw[0]), mul(R[4], pw[1])), mul(R[5], pw[2]));
  px.n2 = add(add(mul(R[6], pw[0]), mul(R[7], pw[1])), mul(R[8], pw[2]));
  px.depth = pw[3];
  const bool sel = lane < S && inb && p.selected[at * S + lane] != 0;
  const float vw = (lane < S && inb) ? __ldg(p.view_weights + at * S + lane)
                                     : 0.f;
  px.my_vw = sel ? vw : 0.f;
  const float dist = sel ? __ldg(p.dists + lane) : 0.f;
  // wnorm and the baseline's sum in view order from +0
  float wnorm = 0.f, dsum = 0.f;
  for (int s = 0; s < S; ++s) {
    wnorm = add(wnorm, __shfl_sync(kFull, px.my_vw, s));
    dsum = add(dsum, __shfl_sync(kFull, dist, s));
  }
  const int valid_src = __popc(__ballot_sync(kFull, sel));
  const float base_line =
      dvd(dsum, static_cast<float>(valid_src > 1 ? valid_src : 1));
  px.wnorm = wnorm;
  px.disp = dvd(mul(fx_r, base_line), px.depth != 0.f ? px.depth : 1.f);
  px.fb = mul(fx_r, base_line);
  px.views =
      __ballot_sync(kFull, px.my_vw != 0.f) & (wnorm > 0.f ? kFull : 0u);
  const bool ok = px.depth != 0.f && valid_src > 0;
  const bool valid = inb && p.valid[at] != 0;

  // ---- the reference window (window_common.cuh) -------------------------
  const PixelWindow win =
      build_window<kSA, false, false>(p.win, xi, yi, T, lane, w_val, w_tw,
                                      w_dx, w_dy);

  // ---- the sweep: two passes (classify), one (refine) --------------------
  const Lanes l = lanes_for(P, lane);
  // pass 0's cost and probe depth, pass 1's cost (classify's probes 32..)
  float c0 = 0.f, c1 = 0.f, pd0 = 0.f;
  for (int pass = 0; pass < l.passes; ++pass) {
    float pd;
    const float c = sweep_pass<Q, kSA, kTaps>(p.c, s_cam, win, px, T, l,
                                              pass, &pd);
    if (pass == 0) {
      c0 = c;
      pd0 = pd;
    } else {
      c1 = c;
    }
  }

  if (p.c.refine) {
    // ---- LocalRefine's rule (filters._refine_depths) ---------------------
    const float cost_now = __shfl_sync(kFull, c0, 0);
    float best_c = kCostMax, best_d = px.depth;
    for (int k = 1; k < kRefineProbes; ++k) {
      float ck = __shfl_sync(kFull, c0, k);
      const float dk = __shfl_sync(kFull, pd0, k);
      ck = isnan(ck) ? INFINITY : ck;
      if (ck < best_c) {
        best_c = ck;
        best_d = dk;
      }
    }
    const float refined = sub(cost_now, best_c) > 0.1f ? best_d : px.depth;
    if (lane == 0) {
      p.depth_out[b] = (ok && wnorm > 0.f && valid) ? refined : px.depth;
    }
    return;
  }

  // ---- DepthToWeak's rule (filters._classify_peaks) ----------------------
  // lane j holds c[j] (c0) and c[j + 32] (c1)
  if (p.curve_out != nullptr) {
    p.curve_out[b * kCurve + lane] = c0;
    if (lane + 32 < kCurve) p.curve_out[b * kCurve + lane + 32] = c1;
  }
  const float c31 = __shfl_sync(kFull, c0, 31);
  const float c32 = __shfl_sync(kFull, c1, 0);
  const float up0 = __shfl_up_sync(kFull, c0, 1);
  const float down0 = __shfl_down_sync(kFull, c0, 1);
  const float up1 = __shfl_up_sync(kFull, c1, 1);
  const float down1 = __shfl_down_sync(kFull, c1, 1);
  const float prev0 = up0, next0 = lane == 31 ? c32 : down0;
  const float prev1 = lane == 0 ? c31 : up1, next1 = down1;
  const int i0 = lane, i1 = lane + 32;
  // strict local minima over i in [2, 58]
  const bool peak0 = i0 >= 2 && prev0 > c0 && next0 > c0;
  const bool peak1 = i1 <= kCurve - 3 && prev1 > c1 && next1 > c1;
  const int peaks = __popc(__ballot_sync(kFull, peak0)) +
                    __popc(__ballot_sync(kFull, peak1));
  // the first minimum of the peaks' costs (+inf off the peaks)
  float bv = peak0 ? c0 : INFINITY;
  int bi = i0;
  if (peak1 && c1 < bv) {
    bv = c1;
    bi = i1;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, bv, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    if (ov < bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  // min_peak = 0 and a cost of 2 unless a peak is below 2
  const bool has_min = bv < 2.f;
  const int min_peak = has_min ? bi : 0;
  const float min_cost = has_min ? bv : 2.f;
  const int dpk = min_peak - kCurveRadius;
  const bool far =
      static_cast<float>(dpk < 0 ? -dpk : dpk) > p.weak_peak_radius ||
      min_cost > 0.5f;
  // the other peaks' squared distances from min_cost, in index order
  float t0 = 0.f, t1 = 0.f;
  if (peak0 && i0 != min_peak) {
    const float d = sub(c0, min_cost);
    t0 = mul(d, d);
  }
  if (peak1 && i1 != min_peak) {
    const float d = sub(c1, min_cost);
    t1 = mul(d, d);
  }
  float sq = 0.f;
  for (int i = 1; i < kCurve - 1; ++i) {
    sq = add(sq, __shfl_sync(kFull, i < 32 ? t0 : t1, i & 31));
  }
  const float var = dvd(__fsqrt_rn(sq),
                        static_cast<float>(peaks - 1 > 1 ? peaks - 1 : 1));
  int cls = far ? kWeak
                : (peaks == 1 ? (min_cost <= 0.15f ? kStrong : kWeak)
                              : (var > 0.2f ? kStrong : kWeak));
  // guards: margins and degenerate setups
  const int m = p.margin;
  const bool margin = xi < m || yi < m || xi >= p.img_wi - m ||
                      yi >= p.img_hi - m;
  if (margin || !ok || !valid) cls = kUnknown;
  if (lane == 0) p.weak_out[b] = cls;
}

using Kernel = void (*)(const Params);
using StageKernel = void (*)(const StageParams);

template <typename Q, bool kPixelOffsets, bool kWeighted>
Kernel pick_taps(int num_taps) {
  return num_taps == kMainTaps
             ? sweep_kernel<Q, kPixelOffsets, kWeighted, kMainTaps>
             : sweep_kernel<Q, kPixelOffsets, kWeighted, 0>;
}

template <typename Q>
Kernel pick_window(bool pixel_offsets, bool weighted, int num_taps) {
  if (pixel_offsets) {
    return weighted ? pick_taps<Q, true, true>(num_taps)
                    : pick_taps<Q, true, false>(num_taps);
  }
  return weighted ? pick_taps<Q, false, true>(num_taps)
                  : pick_taps<Q, false, false>(num_taps);
}

// the instantiation for a table type, window form and tap count
Kernel pick(bool quads_u8, bool pixel_offsets, bool weighted, int num_taps) {
  return quads_u8 ? pick_window<uint8_t>(pixel_offsets, weighted, num_taps)
                  : pick_window<float>(pixel_offsets, weighted, num_taps);
}

template <typename Q, bool kSA>
StageKernel pick_stage_taps(int num_taps) {
  return num_taps == kMainTaps ? stage_sweep_kernel<Q, kSA, kMainTaps>
                               : stage_sweep_kernel<Q, kSA, 0>;
}

// the stage form's instantiation: table type, SA or the square, tap count
StageKernel pick_stage(bool quads_u8, bool sa, int num_taps) {
  if (quads_u8) {
    return sa ? pick_stage_taps<uint8_t, true>(num_taps)
              : pick_stage_taps<uint8_t, false>(num_taps);
  }
  return sa ? pick_stage_taps<float, true>(num_taps)
            : pick_stage_taps<float, false>(num_taps);
}

// its shared memory, with the attribute set where it passes 48 KB
template <typename K>
cudaError_t prepare(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename K>
int kernel_info(K kernel, size_t bytes, int* regs, int* local_bytes,
                int* blocks_per_sm) {
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

Sweep sweep_consts(const void* quads, const void* cams,
                   const void* src_depths, int depth_h, int depth_w,
                   float geom_factor, float depth_min, float depth_max,
                   int refine, int num_probes, int first_disp,
                   int64_t num_pix, int num_views, int num_taps, int width,
                   int quad_h, int img_w, int img_h) {
  Sweep c;
  c.quads = quads;
  c.cams = static_cast<const float*>(cams);
  c.src_depths = static_cast<const float*>(src_depths);
  c.depth_h = depth_h;
  c.depth_w = depth_w;
  c.geom_factor = geom_factor;
  c.depth_min = depth_min;
  c.depth_max = depth_max;
  c.refine = refine != 0;
  c.num_probes = num_probes;
  c.first_disp = first_disp;
  c.num_pix = num_pix;
  c.num_views = num_views;
  c.num_taps = num_taps;
  c.width = width;
  c.quad_h = quad_h;
  c.img_w = static_cast<float>(img_w);
  c.img_h = static_cast<float>(img_h);
  return c;
}

}  // namespace

// Plain C interface for ctypes. Every pointer is a device pointer (tap_w,
// wsum and src_depths may be null; a null src_depths means no geometric
// cost); the function returns cudaGetLastError() after its launch
// (0 = cudaSuccess), or the error of the shared-memory attribute.
extern "C" {

int apde_sweep_max_views() { return kMaxViews; }

int apde_sweep_cam_stride() { return kSweepCamStride; }

long long apde_sweep_smem_bytes(int num_views, int num_taps, int pixel_offsets,
                                int weighted) {
  return static_cast<long long>(
      smem_floats(num_views, num_taps, pixel_offsets != 0, weighted != 0) *
      sizeof(float));
}

// The instantiation's registers, local memory (spills) and resident blocks
// an SM (the CUDA runtime's occupancy calculator) at S views; returns the
// first error.
int apde_sweep_kernel_info(int quads_u8, int pixel_offsets, int weighted,
                           int num_taps, int num_views, int* regs,
                           int* local_bytes, int* blocks_per_sm) {
  return kernel_info(
      pick(quads_u8 != 0, pixel_offsets != 0, weighted != 0, num_taps),
      smem_floats(num_views, num_taps, pixel_offsets != 0, weighted != 0) *
          sizeof(float),
      regs, local_bytes, blocks_per_sm);
}

// The same of the stage form (sa: the SA window, per-pixel offsets and
// weights; else the square, shared offsets).
int apde_sweep_stage_kernel_info(int quads_u8, int sa, int num_taps,
                                 int num_views, int* regs, int* local_bytes,
                                 int* blocks_per_sm) {
  return kernel_info(
      pick_stage(quads_u8 != 0, sa != 0, num_taps),
      smem_floats(num_views, num_taps, sa != 0, sa != 0) * sizeof(float),
      regs, local_bytes, blocks_per_sm);
}

int apde_sweep(const void* quads, int quads_u8, const void* cams,
               const void* src_depths, int depth_h, int depth_w,
               float geom_factor, const void* x, const void* y,
               const void* planes, const void* disp, const void* base_line,
               const void* vw, const void* wnorm, const void* tap_dx,
               const void* tap_dy, int pixel_offsets, const void* tap_val,
               const void* tap_w, const void* sum_ref, const void* sum_rr,
               const void* wsum, float inv_wsum, float depth_min,
               float depth_max, int refine, int num_probes, int first_disp,
               void* out, int64_t num_pix, int num_views, int num_taps,
               int width, int quad_h, int img_w, int img_h, void* stream) {
  if (num_pix <= 0) return static_cast<int>(cudaGetLastError());
  if (num_views < 1 || num_views > kMaxViews || num_taps < 1 ||
      num_probes < 1 + (refine != 0) || num_probes > kMaxProbes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.c = sweep_consts(quads, cams, src_depths, depth_h, depth_w, geom_factor,
                     depth_min, depth_max, refine, num_probes, first_disp,
                     num_pix, num_views, num_taps, width, quad_h, img_w,
                     img_h);
  p.x = static_cast<const float*>(x);
  p.y = static_cast<const float*>(y);
  p.planes = static_cast<const float*>(planes);
  p.disp = static_cast<const float*>(disp);
  p.base_line = static_cast<const float*>(base_line);
  p.vw = static_cast<const float*>(vw);
  p.wnorm = static_cast<const float*>(wnorm);
  p.tap_dx = static_cast<const float*>(tap_dx);
  p.tap_dy = static_cast<const float*>(tap_dy);
  p.tap_val = static_cast<const float*>(tap_val);
  p.tap_w = static_cast<const float*>(tap_w);
  p.sum_ref = static_cast<const float*>(sum_ref);
  p.sum_rr = static_cast<const float*>(sum_rr);
  p.wsum = static_cast<const float*>(wsum);
  p.inv_wsum = inv_wsum;
  p.out = static_cast<float*>(out);
  const bool weighted = p.tap_w != nullptr;
  const Kernel kernel =
      pick(quads_u8 != 0, pixel_offsets != 0, weighted, num_taps);
  const size_t bytes =
      smem_floats(num_views, num_taps, pixel_offsets != 0, weighted) *
      sizeof(float);
  const cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int grid =
      static_cast<unsigned int>((num_pix + kWarps - 1) / kWarps);
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The stage form: DepthToWeak (refine 0: 61 probes from -30; weak_out,
// curve_out null or the (B, 61) curve) or LocalRefine (refine 1: the
// current depth then 11 probes from -5; depth_out) of pixels (x, y) int32
// from the state's maps (grid_h, grid_w): planes (world normal, depth),
// selected (bool), view_weights, valid (bool); dists the (S,) camera
// distances; the reference image (ref_h, width) and SA ids (sa, or null:
// the square of (radius, increment) for every pixel).
int apde_sweep_stage(const void* quads, int quads_u8, const void* cams,
                     const void* src_depths, int depth_h, int depth_w,
                     float geom_factor, const void* x, const void* y,
                     const void* planes, const void* selected,
                     const void* view_weights, const void* valid,
                     int grid_h, int grid_w, const void* dists,
                     const void* ref, int ref_h, const void* sa, int radius,
                     int increment, float inv_wsum, float depth_min,
                     float depth_max, int refine, float weak_peak_radius,
                     int margin, void* weak_out, void* curve_out,
                     void* depth_out, int64_t num_pix, int num_views,
                     int width, int quad_h, int img_w, int img_h,
                     void* stream) {
  if (num_pix <= 0) return static_cast<int>(cudaGetLastError());
  const int axis = radius >= 0 && increment >= 1
                       ? axis_taps(radius, increment)
                       : 0;
  if (num_views < 1 || num_views > kMaxViews || axis < 1 ||
      (sa != nullptr && axis != kAxis) ||
      (refine != 0 ? depth_out == nullptr : weak_out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int num_taps = axis * axis;
  StageParams p;
  p.c = sweep_consts(quads, cams, src_depths, depth_h, depth_w, geom_factor,
                     depth_min, depth_max, refine,
                     refine != 0 ? kRefineProbes : kCurve,
                     refine != 0 ? -5 : -kCurveRadius, num_pix, num_views,
                     num_taps, width, quad_h, img_w, img_h);
  p.x = static_cast<const int*>(x);
  p.y = static_cast<const int*>(y);
  p.planes = static_cast<const float*>(planes);
  p.selected = static_cast<const uint8_t*>(selected);
  p.view_weights = static_cast<const float*>(view_weights);
  p.valid = static_cast<const uint8_t*>(valid);
  p.grid_h = grid_h;
  p.grid_w = grid_w;
  p.dists = static_cast<const float*>(dists);
  p.win.ref = static_cast<const float*>(ref);
  p.win.sa = static_cast<const int*>(sa);
  p.win.ref_h = ref_h;
  p.win.width = width;
  p.win.img_w = img_w;
  p.win.img_h = img_h;
  p.win.radius = radius;
  p.win.increment = increment;
  p.win.axis_n = axis;
  p.win.inv_wsum = inv_wsum;
  p.weak_peak_radius = weak_peak_radius;
  p.margin = margin;
  p.img_wi = img_w;
  p.img_hi = img_h;
  p.weak_out = static_cast<int*>(weak_out);
  p.curve_out = static_cast<float*>(curve_out);
  p.depth_out = static_cast<float*>(depth_out);
  const bool with_sa = sa != nullptr;
  const StageKernel kernel = pick_stage(quads_u8 != 0, with_sa, num_taps);
  const size_t bytes =
      smem_floats(num_views, num_taps, with_sa, with_sa) * sizeof(float);
  const cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int grid =
      static_cast<unsigned int>((num_pix + kWarps - 1) / kWarps);
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
