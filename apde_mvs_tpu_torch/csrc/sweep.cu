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
// geometric cost of `cost.geom_cost` (depth from the plane, back-projection
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
// Arithmetic equals the plain PyTorch version (ops/cuda/sweep.py,
// `sweep_plain`) bit for bit: every operation is rounded on its own, in the
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
// tensor core work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ncc_common.cuh"

namespace {

using namespace apde;

// a view's row of K5's camera table: K2's 16 columns, then the view's own
// R (9, row-major), t (3), K (9, row-major), world centre c (3) for the
// geometric cost; row S is the reference's
constexpr int kSweepCamStride = 40;
constexpr int kGeomCols = 16;
constexpr float kGeomCostMax = 3.f;   // cost.GEOM_COST_MAX
constexpr int kWarps = 4;             // a block's warps, a pixel each
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* quads;         // (S, quad_h * width, 4) u8 or f32
  const float* cams;         // (S + 1, 40)
  const float* src_depths;   // (S, depth_h, depth_w) or null (no geom)
  int depth_h;
  int depth_w;
  float geom_factor;
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
  float depth_min;
  float depth_max;
  int refine;                // 1: column 0 is the current depth, unmasked
  int num_probes;            // output columns: 61 classify, 12 refine
  int first_disp;            // disparity offset of the first swept probe
  float* out;                // (B, num_probes)
  int64_t num_pix;
  int num_views;
  int num_taps;
  int width;
  int quad_h;
  float img_w;               // real (unpadded) bounds of the centre test
  float img_h;
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

// K4: cost.geom_cost of one (pixel, view) for the plane (n, w). ``gr`` and
// ``gs`` are the reference's and the view's geometric columns (R, t, K, c).
__device__ __forceinline__ float geom_cost(const float* gr, const float* gs,
                                           const float* __restrict__ dmap,
                                           int dh, int dw, float x, float y,
                                           float n0, float n1, float n2,
                                           float w) {
  const float* Kr = gr + 12;
  // geometry.depth_from_plane
  const float fx = Kr[0], fy = Kr[4], cx = Kr[2], cy = Kr[5];
  const float denom =
      add(add(mul(sub(x, cx), n0), mul(mul(dvd(fx, fy), sub(y, cy)), n1)),
          mul(fx, n2));
  const float depth = dvd(mul(-w, fx), denom);
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


template <typename Q, bool kPixelOffsets, bool kWeighted, int kTaps>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const Params p) {
  extern __shared__ float smem[];
  const int S = p.num_views;
  const int T = kTaps > 0 ? kTaps : p.num_taps;
  const int P = p.num_probes;
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
    s_cam[i] = __ldg(p.cams + i);
  }
  if (!kPixelOffsets) {
    for (int i = threadIdx.x; i < T; i += kThreads) {
      s_off[i] = __ldg(p.tap_dx + i);
      s_off[T + i] = __ldg(p.tap_dy + i);
    }
  }
  __syncthreads();

  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (b >= p.num_pix) return;
  const float* r = s_cam + S * kSweepCamStride;
  const float fx_r = r[12], fy_r = r[13], cx_r = r[14], cy_r = r[15];
  const Q* __restrict__ quads = static_cast<const Q*>(p.quads);
  const int64_t view_elems =
      static_cast<int64_t>(p.quad_h) * p.width * 4;   // a view's table
  // the lanes: G groups of L lanes (L the power of two >= P, at most 32);
  // lane j of a group runs probes j, j + L, ...; the groups take the
  // pixel's weighted views in turn
  int L = 2;
  while (L < P && L < 32) L <<= 1;
  const int G = 32 / L;
  const int g = lane / L;
  const int j = lane % L;
  const int passes = (P + L - 1) / L;

  // ---- the pixel: scalars, weighted views, window ------------------------
  const float x = __ldg(p.x + b);
  const float y = __ldg(p.y + b);
  const float n0 = __ldg(p.planes + 4 * b + 0);
  const float n1 = __ldg(p.planes + 4 * b + 1);
  const float n2 = __ldg(p.planes + 4 * b + 2);
  const float depth = __ldg(p.planes + 4 * b + 3);
  const float disp = __ldg(p.disp + b);
  const float fb = mul(fx_r, __ldg(p.base_line + b));
  const float wnorm = __ldg(p.wnorm + b);
  const float my_vw = lane < S ? __ldg(p.vw + b * S + lane) : 0.f;
  // bit s: view s weighs != 0; none where wnorm <= 0 (COST_MAX anyway)
  const unsigned views =
      __ballot_sync(kFull, my_vw != 0.f) & (wnorm > 0.f ? kFull : 0u);
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

  for (int pass = 0; pass < passes; ++pass) {
    const int k = j + L * pass;
    // the probe depth (filters.probe_depths) and its bounds
    float pd = depth, lo = -INFINITY, hi = INFINITY;
    if (!(p.refine && k == 0)) {
      const float d =
          add(disp, static_cast<float>(p.first_disp + k - p.refine));
      pd = dvd(fb, d != 0.f ? d : 1e-20f);
      lo = p.depth_min;
      hi = p.depth_max;
    }
    // the plane through it: w = -((n0 X + n1 Y) + n2 Z) of the
    // back-projected point (geometry.plane_dist_to_origin)
    const float X = dvd(mul(pd, sub(x, cx_r)), fx_r);
    const float Y = dvd(mul(pd, sub(y, cy_r)), fy_r);
    const float w = -add(add(mul(n0, X), mul(n1, Y)), mul(n2, pd));

    // the weighted views in order, G a round: group g takes the g-th
    float acc = 0.f;
    unsigned rest = views;
    while (rest != 0u) {
      int mine = -1, count = 0;
      for (; count < G && rest != 0u; ++count) {
        if (count == g) mine = __ffs(rest) - 1;
        rest &= rest - 1;
      }
      const float weight = __shfl_sync(kFull, my_vw, mine < 0 ? 0 : mine);
      float term = 0.f;
      if (mine >= 0 && k < P) {
        const float* c = s_cam + mine * kSweepCamStride;
        float h[3][3];
        plane_homography(c, r, n0, n1, n2, w, h);
        float cv = window_ncc<Q, kWeighted, kTaps>(
            quads + mine * view_elems, h, x, y, T, win, p.width, p.quad_h,
            p.img_w, p.img_h);
        if (p.src_depths != nullptr) {
          const float* dmap = p.src_depths +
                              static_cast<int64_t>(mine) * p.depth_h *
                                  p.depth_w;
          cv = add(cv, mul(p.geom_factor,
                           geom_cost(r + kGeomCols, c + kGeomCols, dmap,
                                     p.depth_h, p.depth_w, x, y, n0, n1,
                                     n2, w)));
        }
        term = mul(weight, cv);
      }
      // the round's terms in view order: group 0's view comes first
      for (int i = 0; i < count; ++i) {
        acc = add(acc, G == 1 ? term : __shfl_sync(kFull, term, i * L + j));
      }
    }
    if (g == 0 && k < P) {
      float cost = dvd(acc, clamp_min_keep_nan(wnorm, 1e-20f));
      cost = wnorm > 0.f ? cost : kCostMax;
      cost = (pd >= lo && pd <= hi) ? cost : kCostMax;
      if (!p.refine) cost = cost > kCostMax ? kCostMax : cost;
      p.out[b * P + k] = cost;
    }
  }
}

using Kernel = void (*)(const Params);

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

// its shared memory, with the attribute set where it passes 48 KB
cudaError_t prepare(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
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
      num_probes < 1 + (refine != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.quads = quads;
  p.cams = static_cast<const float*>(cams);
  p.src_depths = static_cast<const float*>(src_depths);
  p.depth_h = depth_h;
  p.depth_w = depth_w;
  p.geom_factor = geom_factor;
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
  p.depth_min = depth_min;
  p.depth_max = depth_max;
  p.refine = refine != 0;
  p.num_probes = num_probes;
  p.first_disp = first_disp;
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
  const unsigned int grid =
      static_cast<unsigned int>((num_pix + kWarps - 1) / kWarps);
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
