// K2 — the fused strong multi-view NCC, hand-written for Hopper (sm_90a).
//
// Replaces the strong NCC that the JAX package leaves to XLA
// (apde_mvs_tpu/ops/cost.py:248-297, `_per_view_ncc` + `ncc_strong`; the
// CUDA reference is APD.cu:596-721). The port first composed it from torch
// ops around the sampler K1: the plane homography, an (S, B, T) warp of
// the window taps, K1, three (S, B, T) products and sums, the NCC. Every
// intermediate went through device memory. Here one launch takes a pixel
// batch, its planes and its reference window and writes the (S, B) costs;
// the warped coordinates and samples live in registers only.
//
// Layout: one thread per (pixel, source view); a warp is one view of 32
// consecutive pixels (a pixel group), so the (S, B) store is coalesced and
// neighbouring lanes' taps land on neighbouring texels of one quad table.
// The grid's warps run the (group, view) pairs in order, view fastest, and
// a block is 8 warps whatever S is, so every warp has work at any S: the
// block's 8 pairs span at most 2 + 6 / S groups, whose window (tap values;
// for an SA window also the per-pixel offsets, and the weights and
// weight-value products) the block stages in shared memory with the
// per-view camera constants and the pixels' coordinates, planes and
// reference sums. Window rows are padded to an odd stride, so the 32 lanes
// reading tap t of their own pixels hit 32 distinct banks. The main path's
// 36-tap windows run ncc_common.cuh's unrolled tap loop.
//
// Arithmetic equals the plain PyTorch version (ops/cuda/ncc.py,
// `ncc_strong_plain`) bit for bit: the per-(pixel, view) code, with its
// rounding and NaN rules, is ncc_common.cuh's, which K5 (sweep.cu) shares.
// The three window sums start at 0 and take the taps in order t = 0 .. T-1
// in one thread, compensated (Kahan: four rounded operations a term), as
// the plain version does with four elementwise ops a tap. One running f32
// sum over the 36 taps drifts past the 1e-4 parity tests with the JAX
// package; four interleaved partial sums pass them but differ from the
// torch-op composition K2 replaced by more than 1e-4 at the strong shape.
// The compensation is this kernel's choice, not the function's work. The
// per-view R_rel / t_rel come in precomputed (`geometry.relative_pose`,
// the same torch ops for both versions).
//
// The stage form (`ncc_stage_kernel`, plain version ncc.py
// `init_stage_plain`, with the selection `init_stage_select_plain`) is the
// initial cost's strong NCC (apde_mvs_tpu/ops/init.py:43-90 with cost.py:140
// `precompute_ref_window`) and, on the serial and view-parallel routes, its
// top-k view selection (cost.py:430 `initial_cost_and_selection`): it takes
// a range of the image's pixels and the state's planes map, derives each
// pixel's (x, y) from its raster index and builds its window in the block
// from the reference image and the SA segment ids (window_common.cuh: the
// square, or the star cut at the segment's edge), in place of the window's
// torch ops. A block owns all S views of G whole 32-pixel groups, so each
// window, its star cut and its sums are built once (a block of the sweep
// form's 8 (group, view) pairs would build every window of the groups its
// pairs span: 2x at S = 10, 1.5x at S = 5, 4x at S = 32). Then all 8 warps
// loop over the block's G S (group, view) pairs, view fastest, with the
// sweep form's tap loop, Kahan sums and lane layout. In the selection mode
// the pairs' costs stay in shared memory; after one __syncthreads a thread
// a pixel runs select_common.cuh's selection, writes the state's cost map,
// and the block writes its selections as 16-byte stores: the (S, H W)
// costs are never written and no selection launch (K11) follows. The tile
// route's cost-out mode writes the (S, n) costs of a view-major block, or
// the (n, S) of a pixel-major one, for its gather.
//
// Bound: operations, counted as chip_smoke.py counts them (K2_OPS_PER_TAP,
// K2_OPS_PER_PAIR, `k2_bound`). The function needs 38 f32 operations a tap
// (offsets 2, warp 12 and 2 divisions, sample 17, products 2, sums 3; an
// SA tap 2 products more) and 90 a (pixel, view) pair for the homography,
// the centre test and the NCC; the compensation's 9 a tap are not counted.
// At S = 10, B = 240,000, T = 36 that is 3.5 GFLOP: 0.052 ms at the H100's
// 67 TFLOP/s of plain f32, against 59 MB of inputs, touched table rows and
// output (0.018 ms at 3.35 TB/s). The u8 quad tables (19.2 MB at
// 600x800x10) stay in the 50 MB L2. No matrix product, so no tensor core
// work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ncc_common.cuh"
#include "select_common.cuh"
#include "window_common.cuh"

namespace {

using namespace apde;

constexpr int kWarps = 8;             // a block's warps: 8 (group, view) pairs
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 32;            // pixels of a group, one a lane
// per-pixel arrays in shared memory: x, y, the plane (4), sum_ref,
// sum_rr, 1 / wsum, wsum <= 0
constexpr int kPixelArrays = 10;

struct Params {
  const void* quads;       // (S, quad_h * width, 4) u8 or f32
  const float* cams;       // (S + 1, 16): the views; row S holds the
                           // reference's fx, fy, cx, cy at 12..15
  const float* x;          // (B,)
  const float* y;          // (B,)
  const float* planes;     // (B, 4)
  const float* tap_dx;     // (T,) shared, or (B, T) per pixel
  const float* tap_dy;
  const float* tap_val;    // (B, T)
  const float* tap_w;      // (B, T) or null (every tap weighs 1)
  const float* sum_ref;    // (B,)
  const float* sum_rr;     // (B,)
  const float* wsum;       // (B,) or null
  float inv_wsum;          // the float32 1 / T where wsum is null
  float* out;              // (S, B)
  int64_t num_pix;
  int num_views;
  int num_taps;
  int width;
  int quad_h;
  float img_w;             // real (unpadded) bounds of the centre test
  float img_h;
};

// shared-memory row stride of a pixel's window: odd, so the 32 lanes
// reading tap t of their own pixels hit 32 distinct banks
__host__ __device__ inline int window_stride(int num_taps) {
  return num_taps | 1;
}

// the pixel groups a block's kWarps consecutive (group, view) pairs span
__host__ __device__ inline int block_groups(int num_views) {
  const int g = 2 + (kWarps - 2) / num_views;
  return g < kWarps ? g : kWarps;
}

__host__ __device__ inline size_t smem_floats(int num_views, int num_taps,
                                              bool pixel_offsets,
                                              bool weighted) {
  const size_t pix = static_cast<size_t>(kGroup) * block_groups(num_views);
  const size_t rows = pix * window_stride(num_taps);
  size_t n = static_cast<size_t>(num_views + 1) * kCamStride +
             kPixelArrays * pix + rows;
  n += pixel_offsets ? 2 * rows : 2 * static_cast<size_t>(num_taps);
  if (weighted) n += rows;
  return n;
}

template <typename Q, bool kPixelOffsets, bool kWeighted, int kTaps>
__global__ void __launch_bounds__(kThreads)
ncc_strong_kernel(const Params p) {
  extern __shared__ float smem[];
  const int S = p.num_views;
  const int T = kTaps > 0 ? kTaps : p.num_taps;
  const int tp = window_stride(T);
  const int pix = kGroup * block_groups(S);
  float* s_cam = smem;
  float* s_pix = s_cam + (S + 1) * kCamStride;
  float* s_x = s_pix;
  float* s_y = s_x + pix;
  float* s_n0 = s_y + pix;
  float* s_n1 = s_n0 + pix;
  float* s_n2 = s_n1 + pix;
  float* s_w = s_n2 + pix;
  float* s_sref = s_w + pix;
  float* s_srr = s_sref + pix;
  float* s_inv = s_srr + pix;
  float* s_empty = s_inv + pix;
  float* s_val = s_pix + kPixelArrays * pix;
  float* s_dx = s_val + pix * tp;
  float* s_dy = s_dx + (kPixelOffsets ? pix * tp : T);
  float* s_tw = s_dy + (kPixelOffsets ? pix * tp : T);

  // the block's (group, view) pairs, view fastest, and the groups they span
  const int64_t groups = (p.num_pix + kGroup - 1) / kGroup;
  const int64_t pairs = groups * S;
  const int64_t pair0 = static_cast<int64_t>(blockIdx.x) * kWarps;
  const int64_t pair_end = pair0 + kWarps < pairs ? pair0 + kWarps : pairs;
  const int64_t g0 = pair0 / S;
  const int64_t b0 = g0 * kGroup;
  const int64_t b_end = (pair_end - 1) / S * kGroup + kGroup;
  const int npix = static_cast<int>(
      (b_end < p.num_pix ? b_end : p.num_pix) - b0);

  // ---- stage the block's inputs in shared memory --------------------------
  const int tid = threadIdx.x;
  for (int i = tid; i < (S + 1) * kCamStride; i += kThreads) {
    s_cam[i] = __ldg(p.cams + i);
  }
  for (int i = tid; i < npix; i += kThreads) {
    const int64_t b = b0 + i;
    s_x[i] = __ldg(p.x + b);
    s_y[i] = __ldg(p.y + b);
    s_n0[i] = __ldg(p.planes + 4 * b + 0);
    s_n1[i] = __ldg(p.planes + 4 * b + 1);
    s_n2[i] = __ldg(p.planes + 4 * b + 2);
    s_w[i] = __ldg(p.planes + 4 * b + 3);
    s_sref[i] = __ldg(p.sum_ref + b);
    s_srr[i] = __ldg(p.sum_rr + b);
    float inv = p.inv_wsum;
    bool empty = false;
    if (p.wsum != nullptr) {
      inverse_weight_sum(__ldg(p.wsum + b), &inv, &empty);
    }
    s_inv[i] = inv;
    s_empty[i] = empty ? 1.f : 0.f;
  }
  const int64_t base = b0 * T;
  for (int i = tid; i < npix * T; i += kThreads) {
    const int q = i / T;
    stage_tap<kPixelOffsets, kWeighted>(p.tap_val, p.tap_w, p.tap_dx,
                                        p.tap_dy, base + i,
                                        q * tp + (i - q * T), s_val, s_tw,
                                        s_dx, s_dy);
  }
  if (!kPixelOffsets) {
    for (int i = tid; i < T; i += kThreads) {
      s_dx[i] = __ldg(p.tap_dx + i);
      s_dy[i] = __ldg(p.tap_dy + i);
    }
  }
  __syncthreads();

  // ---- this warp's (group, view): the plane homography, the window's NCC --
  const int64_t pair = pair0 + (tid >> 5);
  if (pair >= pair_end) return;
  const int view = static_cast<int>(pair % S);
  const int q = static_cast<int>(pair / S - g0) * kGroup + (tid & 31);
  if (q >= npix) return;
  const float* c = s_cam + view * kCamStride;
  const float* r = s_cam + S * kCamStride;
  float h[3][3];
  plane_homography(c, r, s_n0[q], s_n1[q], s_n2[q], s_w[q], h);
  PixelWindow win;
  win.dx = s_dx + (kPixelOffsets ? q * tp : 0);
  win.dy = s_dy + (kPixelOffsets ? q * tp : 0);
  win.val = s_val + q * tp;
  win.tw = s_tw + q * tp;
  win.sum_ref = s_sref[q];
  win.sum_rr = s_srr[q];
  win.inv = s_inv[q];
  win.empty = s_empty[q] != 0.f;
  const Q* tab = static_cast<const Q*>(p.quads) +
                 static_cast<int64_t>(view) * p.quad_h * p.width * 4;
  p.out[static_cast<int64_t>(view) * p.num_pix + b0 + q] =
      window_ncc<Q, kWeighted, kTaps>(tab, h, s_x[q], s_y[q], T, win,
                                      p.width, p.quad_h, p.img_w, p.img_h);
}

// ---- the stage form: the initial cost's strong NCC of a pixel range ------

struct StageParams {
  const void* quads;       // (S, quad_h * width, 4) u8 or f32
  const float* cams;       // (S + 1, cam_stride): K2's 16 columns first
  int cam_stride;
  const float* planes;     // (H * W, 4) the state's planes map
  WindowSource win;        // the reference image, SA ids, the square
  float* out;              // cost-out mode: pixel pix0 + b's costs in
  int64_t view_stride;     //   column b; out's strides: a view's, a
  int64_t pixel_stride;    //   pixel's
  const uint8_t* valid;    // selection mode: the (H * W,) validity map,
  float* cost_out;         //   the state's new (H * W,) cost map and
  uint8_t* sel_out;        //   (H * W, S) selections, by raster index
  int top_k;
  int64_t pix0;            // the range's first pixel (raster index)
  int64_t num_pix;
  int num_views;
  int num_taps;
  int quad_h;
  float img_w;             // real (unpadded) bounds of the centre test
  float img_h;
};

// G, a block's 32-pixel groups at S views: the block owns all S views of
// its G * 32 pixels. G = 4 below 16 views, 2 from 16: at 5 and 10 views
// the 4 S pairs keep the 8 warps busy and a block's shared memory (a
// window of values, and under SA of weights, a pixel) still lets 4 blocks
// share an SM, as the registers do; at 32 views G = 4 would hold 3 blocks
// an SM and G = 8 at 5 views 2 (PERF.md says how G was chosen). At most
// 8: the epilogue runs a thread a pixel.
__host__ __device__ inline int stage_groups(int num_views) {
  return num_views >= 16 ? 2 : 4;
}

// per-pixel arrays of the stage form: K2's ten, whether the pixel's window
// is the SA star and (the selection mode) whether the pixel is valid
constexpr int kStagePixelArrays = kPixelArrays + 2;

// The stage form's shared memory, offsets in floats: the cameras, the
// per-pixel arrays, the windows' values (SA: and weights, a row of T | 1
// a pixel), the square's offsets (SA: and the star's, shared by every
// pixel whose window is one), and in the selection mode the block's (S,
// G 32) costs; its (G 32, S) selection bytes take the window values' place
// (16-byte aligned) once the pairs are done, where they fit.
struct StageLayout {
  int x, val, tw, dx, sdx, cost, sel, total;
};

__host__ __device__ inline StageLayout stage_layout(int num_views,
                                                    int num_taps, bool sa,
                                                    bool select) {
  const int pix = kGroup * stage_groups(num_views);
  const int rows = pix * window_stride(num_taps);
  StageLayout l;
  l.x = (num_views + 1) * kCamStride;
  l.val = l.x + kStagePixelArrays * pix;
  l.tw = l.val + rows;
  l.dx = l.tw + (sa ? rows : 0);
  l.sdx = l.dx + 2 * num_taps;
  l.cost = l.sdx + (sa ? 2 * num_taps : 0);
  l.total = l.cost + (select ? num_views * pix : 0);
  // the selection bytes reuse the windows' values once the pairs are done,
  // where they fit (S <= 4 (T | 1)), else follow the costs
  l.sel = -1;
  if (select && 4 * window_stride(num_taps) < num_views) {
    l.sel = (l.total + 3) & ~3;
    l.total = l.sel + (pix * num_views + 3) / 4;
  }
  return l;
}

// A block owns all S views of G whole 32-pixel groups (`stage_groups`):
// it builds each pixel's window once (window_common.cuh's `stage_window`,
// a warp a window, the square's or the star's offsets from the block's
// tables; the sums in tap order by one thread a pixel,
// `staged_window_sums`); then its 8 warps loop over the block's G S
// (group, view) pairs, view fastest, each pair one view of 32 consecutive
// pixels, a lane a pixel (ncc_common.cuh's tap loop): a slow group (NaN
// planes' division paths, taps far apart) spreads over every warp. Each
// pixel's (x, y) comes from its raster index, its plane from the state's
// map, its validity is staged with them. kSelect: each pair's costs go to
// the block's (S, G 32) array in shared memory; then one thread a pixel
// runs select_common.cuh's selection on its S costs and validity, writes
// the pixel's cost-map entry and stages its S selection bytes, and the
// block writes its pixels' selections, one contiguous range of the map, as
// 16-byte words. Else (the tile route's cost-out mode) each pair writes its
// costs into ``out``. (Giving a group's views to its own warps, with a
// barrier a group so that its epilogue overlaps the other groups' pairs,
// and handing pairs to warps as they come free were both slower at 600x800
// under SA: PERF.md.)
template <typename Q, bool kSA, bool kMain, bool kSelect>
__global__ void __launch_bounds__(kThreads)
ncc_stage_kernel(const StageParams p) {
  extern __shared__ float smem[];
  const int S = p.num_views;
  const int T = kMain ? kMainTaps : p.num_taps;
  const int tp = window_stride(T);
  const int pix = kGroup * stage_groups(S);
  const int width = p.win.width;
  const StageLayout L = stage_layout(S, T, kSA, kSelect);
  float* s_cam = smem;
  float* s_x = smem + L.x;
  float* s_y = s_x + pix;
  float* s_n0 = s_y + pix;
  float* s_n1 = s_n0 + pix;
  float* s_n2 = s_n1 + pix;
  float* s_w = s_n2 + pix;
  float* s_sref = s_w + pix;
  float* s_srr = s_sref + pix;
  float* s_inv = s_srr + pix;
  float* s_empty = s_inv + pix;
  float* s_star = s_empty + pix;
  float* s_valid = s_star + pix;
  float* s_val = smem + L.val;
  float* s_tw = smem + L.tw;
  float* s_dx = smem + L.dx;       // the square's offsets
  float* s_dy = s_dx + T;
  float* s_sdx = smem + L.sdx;     // SA: the star's
  float* s_sdy = s_sdx + T;
  float* s_cost = smem + L.cost;

  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * pix;
  const int64_t left = p.num_pix - b0;
  const int npix = left < pix ? static_cast<int>(left) : pix;

  // ---- the cameras, the pixels and their planes, the offset tables -------
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int i = tid; i < (S + 1) * kCamStride; i += kThreads) {
    const int v = i / kCamStride;
    s_cam[i] = __ldg(p.cams + v * p.cam_stride + (i - v * kCamStride));
  }
  for (int i = tid; i < npix; i += kThreads) {
    const int64_t f = p.pix0 + b0 + i;
    const int64_t row = f / width;
    s_x[i] = static_cast<float>(f - row * width);
    s_y[i] = static_cast<float>(row);
    s_n0[i] = __ldg(p.planes + 4 * f + 0);
    s_n1[i] = __ldg(p.planes + 4 * f + 1);
    s_n2[i] = __ldg(p.planes + 4 * f + 2);
    s_w[i] = __ldg(p.planes + 4 * f + 3);
    if (kSelect) s_valid[i] = p.valid[f] != 0 ? 1.f : 0.f;
  }
  for (int i = tid; i < T; i += kThreads) {
    int dx, dy;
    square_offsets<kMain>(p.win, i, &dx, &dy);
    s_dx[i] = static_cast<float>(dx);
    s_dy[i] = static_cast<float>(dy);
    if (kSA) {
      const int q = i / kQuadTaps, k = i - q * kQuadTaps;
      s_sdx[i] = static_cast<float>(star_sign_x(q) *
                                    (2 * star_index(kStarIx, k) + 1));
      s_sdy[i] = static_cast<float>(star_sign_y(q) *
                                    (2 * star_index(kStarIy, k) + 1));
    }
  }
  // ---- each pixel's window once, a warp a window; its sums a thread a
  // pixel ------------------------------------------------------------------
  for (int q = warp; q < npix; q += kWarps) {
    const int64_t f = p.pix0 + b0 + q;
    const int yi = static_cast<int>(f / width);
    const int xi = static_cast<int>(f - static_cast<int64_t>(yi) * width);
    bool star = false;
    const int ws = stage_window<kSA, kMain, false, false>(
        p.win, xi, yi, T, lane, s_val + q * tp, s_tw + q * tp, nullptr,
        nullptr, &star);
    if (lane == 0) {
      float inv = p.win.inv_wsum;
      bool empty = false;
      if (kSA) inverse_weight_sum(static_cast<float>(ws), &inv, &empty);
      s_inv[q] = inv;
      s_empty[q] = empty ? 1.f : 0.f;
      s_star[q] = star ? 1.f : 0.f;
    }
  }
  __syncthreads();
  for (int q = tid; q < npix; q += kThreads) {
    staged_window_sums(s_val + q * tp, T, &s_sref[q], &s_srr[q]);
  }
  __syncthreads();

  // ---- the block's (group, view) pairs, view fastest, a warp a pair: the
  // plane homography, the NCC ----------------------------------------------
  const int groups = (npix + kGroup - 1) / kGroup;
  const float* r = s_cam + S * kCamStride;
  for (int pair = warp; pair < groups * S; pair += kWarps) {
    const int g = pair / S;
    const int view = pair - g * S;
    const int q = g * kGroup + lane;
    if (q >= npix) continue;
    const float* c = s_cam + view * kCamStride;
    float h[3][3];
    plane_homography(c, r, s_n0[q], s_n1[q], s_n2[q], s_w[q], h);
    PixelWindow win;
    const bool star = kSA && s_star[q] != 0.f;
    win.dx = star ? s_sdx : s_dx;
    win.dy = star ? s_sdy : s_dy;
    win.val = s_val + q * tp;
    win.tw = s_tw + q * tp;
    win.sum_ref = s_sref[q];
    win.sum_rr = s_srr[q];
    win.inv = s_inv[q];
    win.empty = s_empty[q] != 0.f;
    const Q* tab = static_cast<const Q*>(p.quads) +
                   static_cast<int64_t>(view) * p.quad_h * width * 4;
    const float cost = window_ncc<Q, kSA, kMain ? kMainTaps : 0>(
        tab, h, s_x[q], s_y[q], T, win, width, p.quad_h, p.img_w, p.img_h);
    if (kSelect) {
      s_cost[view * pix + q] = cost;
    } else {
      p.out[view * p.view_stride + (b0 + q) * p.pixel_stride] = cost;
    }
  }
  if (!kSelect) return;

  // ---- the epilogue: each pixel's selection, a thread a pixel; the
  // block's selections --------------------------------------------------------
  __syncthreads();
  uint8_t* s_sel = reinterpret_cast<uint8_t*>(smem + (L.sel < 0 ? L.val
                                                              : L.sel));
  if (tid < npix) {
    uint32_t bits;
    p.cost_out[p.pix0 + b0 + tid] = select_top_k<0>(
        [&](int s) { return s_cost[s * pix + tid]; }, S, p.top_k,
        s_valid[tid] != 0.f, &bits);
    selection_bytes(bits, S, s_sel + tid * S);
  }
  __syncthreads();
  store_selections(s_sel, p.sel_out + (p.pix0 + b0) * S, npix * S, tid,
                   kThreads);
}

using StageKernel = void (*)(const StageParams);

template <typename Q, bool kSA, bool kSelect>
StageKernel pick_stage_window(bool main_window) {
  return main_window ? ncc_stage_kernel<Q, kSA, true, kSelect>
                     : ncc_stage_kernel<Q, kSA, false, kSelect>;
}

template <bool kSelect>
StageKernel pick_stage_form(bool quads_u8, bool sa, bool main_window) {
  if (quads_u8) {
    return sa ? pick_stage_window<uint8_t, true, kSelect>(main_window)
              : pick_stage_window<uint8_t, false, kSelect>(main_window);
  }
  return sa ? pick_stage_window<float, true, kSelect>(main_window)
            : pick_stage_window<float, false, kSelect>(main_window);
}

// the stage form's instantiation for a table type, SA, the main path's
// square (radius 5, increment 2) or another, and the selection mode or the
// cost-out mode
StageKernel pick_stage(bool quads_u8, bool sa, bool main_window,
                       bool select) {
  return select ? pick_stage_form<true>(quads_u8, sa, main_window)
                : pick_stage_form<false>(quads_u8, sa, main_window);
}

bool is_main_window(int radius, int increment) {
  return radius == kMainRadius && increment == kMainIncrement;
}

using Kernel = void (*)(const Params);

template <typename Q, bool kPixelOffsets, bool kWeighted>
Kernel pick_taps(int num_taps) {
  return num_taps == kMainTaps
             ? ncc_strong_kernel<Q, kPixelOffsets, kWeighted, kMainTaps>
             : ncc_strong_kernel<Q, kPixelOffsets, kWeighted, 0>;
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

// its shared memory, with the attribute set where it passes 48 KB
template <typename K>
cudaError_t prepare(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// Plain C interface for ctypes. Every pointer is a device pointer (tap_w
// and wsum may be null); the function returns cudaGetLastError() after its
// launch (0 = cudaSuccess), or the error of the shared-memory attribute.
extern "C" {

int apde_ncc_max_views() { return kMaxViews; }

long long apde_ncc_smem_bytes(int num_views, int num_taps, int pixel_offsets,
                              int weighted) {
  return static_cast<long long>(
      smem_floats(num_views, num_taps, pixel_offsets != 0, weighted != 0) *
      sizeof(float));
}

// The instantiation's registers, local memory (spills) and resident blocks
// an SM (the CUDA runtime's occupancy calculator) at S views; returns the
// first error.
int apde_ncc_kernel_info(int quads_u8, int pixel_offsets, int weighted,
                         int num_taps, int num_views, int* regs,
                         int* local_bytes, int* blocks_per_sm) {
  const Kernel kernel =
      pick(quads_u8 != 0, pixel_offsets != 0, weighted != 0, num_taps);
  const size_t bytes =
      smem_floats(num_views, num_taps, pixel_offsets != 0, weighted != 0) *
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

int apde_ncc_strong(const void* quads, int quads_u8, const void* cams,
                    const void* x, const void* y, const void* planes,
                    const void* tap_dx, const void* tap_dy, int pixel_offsets,
                    const void* tap_val, const void* tap_w,
                    const void* sum_ref, const void* sum_rr, const void* wsum,
                    float inv_wsum, void* out, int64_t num_pix, int num_views,
                    int num_taps, int width, int quad_h, int img_w, int img_h,
                    void* stream) {
  if (num_pix <= 0) return static_cast<int>(cudaGetLastError());
  if (num_views < 1 || num_views > kMaxViews || num_taps < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.quads = quads;
  p.cams = static_cast<const float*>(cams);
  p.x = static_cast<const float*>(x);
  p.y = static_cast<const float*>(y);
  p.planes = static_cast<const float*>(planes);
  p.tap_dx = static_cast<const float*>(tap_dx);
  p.tap_dy = static_cast<const float*>(tap_dy);
  p.tap_val = static_cast<const float*>(tap_val);
  p.tap_w = static_cast<const float*>(tap_w);
  p.sum_ref = static_cast<const float*>(sum_ref);
  p.sum_rr = static_cast<const float*>(sum_rr);
  p.wsum = static_cast<const float*>(wsum);
  p.inv_wsum = inv_wsum;
  p.out = static_cast<float*>(out);
  p.num_pix = num_pix;
  p.num_views = num_views;
  p.num_taps = num_taps;
  p.width = width;
  p.quad_h = quad_h;
  p.img_w = static_cast<float>(img_w);
  p.img_h = static_cast<float>(img_h);
  const bool weighted = p.tap_w != nullptr;
  const Kernel kernel =
      pick(quads_u8 != 0, pixel_offsets != 0, weighted, num_taps);
  const size_t bytes =
      smem_floats(num_views, num_taps, pixel_offsets != 0, weighted) *
      sizeof(float);
  const cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t pairs = (num_pix + kGroup - 1) / kGroup * num_views;
  const unsigned int grid =
      static_cast<unsigned int>((pairs + kWarps - 1) / kWarps);
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// G, the stage form's 32-pixel groups a block at S views (`stage_groups`).
int apde_ncc_stage_groups(int num_views) { return stage_groups(num_views); }

// The stage form's shared memory a block at S views (the square of
// (radius, increment); SA; the selection mode).
long long apde_ncc_stage_smem_bytes(int num_views, int radius, int increment,
                                    int sa, int select) {
  const int n = axis_taps(radius, increment);
  return static_cast<long long>(
      stage_layout(num_views, n * n, sa != 0, select != 0).total *
      sizeof(float));
}

// The stage form's registers, local memory (spills) and resident blocks an
// SM at S views (the square of (radius, increment), the selection mode or
// the cost-out mode); returns the first error.
int apde_ncc_stage_kernel_info(int quads_u8, int sa, int radius,
                               int increment, int select, int num_views,
                               int* regs, int* local_bytes,
                               int* blocks_per_sm) {
  const StageKernel kernel =
      pick_stage(quads_u8 != 0, sa != 0, is_main_window(radius, increment),
                 select != 0);
  const int n = axis_taps(radius, increment);
  const size_t bytes =
      stage_layout(num_views, n * n, sa != 0, select != 0).total *
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

// The stage form on pixels pix0 .. pix0 + num_pix - 1 (raster indices of
// the (ref_h, width) image): their planes from ``planes`` (ref_h * width,
// 4), their windows from ``ref`` and, under SA, the segment ids ``sa``
// (null: the square). With ``cost_out`` null (the cost-out mode) the S
// costs of pixel pix0 + b go to out + s * view_stride + b * pixel_stride;
// else (the selection mode) pixel f's selection of its top_k views,
// with its validity valid[f], goes to cost_out[f] and sel_out[f * S + s].
// A block takes G = `stage_groups`(S) 32-pixel groups.
int apde_ncc_stage(const void* quads, int quads_u8, const void* cams,
                   int cam_stride, const void* planes, const void* ref,
                   int ref_h, const void* sa, int radius, int increment,
                   float inv_wsum, void* out, int64_t view_stride,
                   int64_t pixel_stride, const void* valid, void* cost_out,
                   void* sel_out, int top_k, int64_t pix0,
                   int64_t num_pix, int num_views, int width, int quad_h,
                   int img_w, int img_h, void* stream) {
  if (num_pix <= 0) return static_cast<int>(cudaGetLastError());
  const int n = radius >= 0 && increment >= 1 ? axis_taps(radius, increment)
                                              : 0;
  const bool select = cost_out != nullptr;
  if (num_views < 1 || num_views > kMaxViews || n < 1 || cam_stride < 16 ||
      (sa != nullptr && n * n != kStarTaps) ||
      (select && (valid == nullptr || sel_out == nullptr || top_k < 0)) ||
      (!select && out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  StageParams p;
  p.quads = quads;
  p.cams = static_cast<const float*>(cams);
  p.cam_stride = cam_stride;
  p.planes = static_cast<const float*>(planes);
  p.win.ref = static_cast<const float*>(ref);
  p.win.sa = static_cast<const int*>(sa);
  p.win.ref_h = ref_h;
  p.win.width = width;
  p.win.img_w = img_w;
  p.win.img_h = img_h;
  p.win.radius = radius;
  p.win.increment = increment;
  p.win.axis_n = n;
  p.win.inv_wsum = inv_wsum;
  p.out = static_cast<float*>(out);
  p.view_stride = view_stride;
  p.pixel_stride = pixel_stride;
  p.valid = static_cast<const uint8_t*>(valid);
  p.cost_out = static_cast<float*>(cost_out);
  p.sel_out = static_cast<uint8_t*>(sel_out);
  p.top_k = top_k;
  p.pix0 = pix0;
  p.num_pix = num_pix;
  p.num_views = num_views;
  p.num_taps = n * n;
  p.quad_h = quad_h;
  p.img_w = static_cast<float>(img_w);
  p.img_h = static_cast<float>(img_h);
  const bool with_sa = sa != nullptr;
  const StageKernel kernel = pick_stage(
      quads_u8 != 0, with_sa, is_main_window(radius, increment), select);
  const size_t bytes =
      stage_layout(num_views, n * n, with_sa, select).total *
      sizeof(float);
  const cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t pix = static_cast<int64_t>(kGroup) * stage_groups(num_views);
  const unsigned int grid =
      static_cast<unsigned int>((num_pix + pix - 1) / pix);
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
