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
// Layout: K2's. A block holds 32 pixels (the lanes) and S source views (the
// warps). The block stages its pixels' window (tap values; for an SA window
// the per-pixel offsets and weights) and reference sums in shared memory
// once for all probes; each thread keeps its pixel's scalars and its view's
// weight in registers. Per probe each thread writes weight * cost to an
// (S, 32) shared array, and after one barrier warp 0 sums the pixel's row in
// view order; the array is double-buffered by probe parity, so one barrier a
// probe suffices. The curve collects in shared memory and is stored
// coalesced at the end. A view whose weight is 0 adds exactly +0 to the
// sum (its cost is finite and >= 0, and the sum starts at +0), so its
// thread skips the probe's taps: the result is unchanged bit for bit.
//
// Arithmetic equals the plain PyTorch version (ops/cuda/sweep.py,
// `sweep_plain`) bit for bit: every operation is rounded on its own, in the
// order of the torch ops there (ncc_common.cuh says how).
//
// Bound: operations. Per (pixel, view, probe) K2's 38 f32 operations a tap
// and ~90 a pair, ~90 more for the geometric cost and 2 for the weighting;
// per (pixel, probe) ~15 for the probe depth and plane. At S = 10,
// B = 65,536, 61 probes, 36 taps that is ~60 GFLOP (~0.9 ms at the H100's
// 67 TFLOP/s of plain f32); the inputs and the curve are ~30 MB. The u8
// quad tables (19.2 MB at 600x800x10) and the f32 source depth maps
// (19.2 MB) together fit the 50 MB L2; f32 quad tables (76.8 MB) do not. No
// matrix product, so no tensor core work.

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
// per-pixel arrays in shared memory: sum_ref, sum_rr, 1 / wsum, wsum <= 0
constexpr int kPixelArrays = 4;

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

__host__ __device__ inline size_t smem_floats(int num_views, int num_taps,
                                              bool pixel_offsets,
                                              bool weighted,
                                              int num_probes) {
  const size_t rows = static_cast<size_t>(kLanes) * window_stride(num_taps);
  size_t n = static_cast<size_t>(num_views + 1) * kSweepCamStride +
             kPixelArrays * kLanes + rows;
  n += pixel_offsets ? 2 * rows : 2 * static_cast<size_t>(num_taps);
  if (weighted) n += rows;
  n += 2 * static_cast<size_t>(num_views) * kLanes;            // the terms
  n += static_cast<size_t>(kLanes) * (num_probes | 1);         // the curve
  return n;
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

template <typename Q, bool kPixelOffsets, bool kWeighted>
__global__ void __launch_bounds__(kLanes * kMaxViews)
sweep_kernel(const Params p) {
  extern __shared__ float smem[];
  const int S = p.num_views;
  const int T = p.num_taps;
  const int P = p.num_probes;
  const int tp = window_stride(T);
  const int op = P | 1;
  float* s_cam = smem;
  float* s_sref = s_cam + (S + 1) * kSweepCamStride;
  float* s_srr = s_sref + kLanes;
  float* s_inv = s_srr + kLanes;
  float* s_empty = s_inv + kLanes;
  float* s_val = s_sref + kPixelArrays * kLanes;
  float* s_dx = s_val + kLanes * tp;
  float* s_dy = s_dx + (kPixelOffsets ? kLanes * tp : T);
  float* s_tw = s_dy + (kPixelOffsets ? kLanes * tp : T);
  float* s_term = s_tw + (kWeighted ? kLanes * tp : 0);
  float* s_out = s_term + 2 * S * kLanes;

  const int lane = threadIdx.x;
  const int view = threadIdx.y;
  const int tid = view * kLanes + lane;
  const int nthreads = kLanes * S;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kLanes;
  const int npix = static_cast<int>(
      p.num_pix - b0 < kLanes ? p.num_pix - b0 : kLanes);
  const bool active = lane < npix;

  // ---- stage the block's cameras and window in shared memory --------------
  for (int i = tid; i < (S + 1) * kSweepCamStride; i += nthreads) {
    s_cam[i] = __ldg(p.cams + i);
  }
  if (tid < npix) {
    const int64_t b = b0 + tid;
    s_sref[tid] = __ldg(p.sum_ref + b);
    s_srr[tid] = __ldg(p.sum_rr + b);
    float inv = p.inv_wsum;
    bool empty = false;
    if (p.wsum != nullptr) {
      inverse_weight_sum(__ldg(p.wsum + b), &inv, &empty);
    }
    s_inv[tid] = inv;
    s_empty[tid] = empty ? 1.f : 0.f;
  }
  const int64_t base = b0 * T;
  for (int i = tid; i < npix * T; i += nthreads) {
    const int q = i / T;
    const int at = q * tp + (i - q * T);
    s_val[at] = __ldg(p.tap_val + base + i);
    if (kPixelOffsets) {
      s_dx[at] = __ldg(p.tap_dx + base + i);
      s_dy[at] = __ldg(p.tap_dy + base + i);
    }
    if (kWeighted) s_tw[at] = __ldg(p.tap_w + base + i);
  }
  if (!kPixelOffsets) {
    for (int i = tid; i < T; i += nthreads) {
      s_dx[i] = __ldg(p.tap_dx + i);
      s_dy[i] = __ldg(p.tap_dy + i);
    }
  }

  // ---- the pixel's scalars and this view's weight, in registers -----------
  const int64_t b = b0 + (active ? lane : 0);
  const float x = __ldg(p.x + b);
  const float y = __ldg(p.y + b);
  const float n0 = __ldg(p.planes + 4 * b + 0);
  const float n1 = __ldg(p.planes + 4 * b + 1);
  const float n2 = __ldg(p.planes + 4 * b + 2);
  const float depth = __ldg(p.planes + 4 * b + 3);
  const float disp = __ldg(p.disp + b);
  const float fb = mul(p.cams[S * kSweepCamStride + 12],
                       __ldg(p.base_line + b));
  const float weight = active ? __ldg(p.vw + b * S + view) : 0.f;
  const float wnorm = __ldg(p.wnorm + b);
  __syncthreads();

  const float* c = s_cam + view * kSweepCamStride;
  const float* r = s_cam + S * kSweepCamStride;
  const float fx_r = r[12], fy_r = r[13], cx_r = r[14], cy_r = r[15];
  PixelWindow win;
  win.dx = s_dx + (kPixelOffsets ? lane * tp : 0);
  win.dy = s_dy + (kPixelOffsets ? lane * tp : 0);
  win.val = s_val + lane * tp;
  win.tw = s_tw + lane * tp;
  win.sum_ref = s_sref[lane];
  win.sum_rr = s_srr[lane];
  win.inv = s_inv[lane];
  win.empty = s_empty[lane] != 0.f;
  const Q* __restrict__ tab = static_cast<const Q*>(p.quads);
  const int64_t view_row0 =
      static_cast<int64_t>(view) * p.quad_h * static_cast<int64_t>(p.width);
  const float* dmap =
      p.src_depths == nullptr
          ? nullptr
          : p.src_depths + static_cast<int64_t>(view) * p.depth_h * p.depth_w;

  for (int k = 0; k < P; ++k) {
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

    float term = 0.f;
    if (weight != 0.f) {
      float h[3][3];
      plane_homography(c, r, n0, n1, n2, w, h);
      float cv = window_ncc<Q, kWeighted>(tab, view_row0, h, x, y, T, win,
                                          p.width, p.quad_h, p.img_w,
                                          p.img_h);
      if (p.src_depths != nullptr) {
        cv = add(cv, mul(p.geom_factor,
                         geom_cost(r + kGeomCols, c + kGeomCols, dmap,
                                   p.depth_h, p.depth_w, x, y, n0, n1, n2,
                                   w)));
      }
      term = mul(weight, cv);
    }
    float* part = s_term + (k & 1) * S * kLanes;
    part[view * kLanes + lane] = term;
    __syncthreads();
    if (view == 0 && active) {
      float acc = 0.f;
      for (int s = 0; s < S; ++s) acc = add(acc, part[s * kLanes + lane]);
      float cost = dvd(acc, clamp_min_keep_nan(wnorm, 1e-20f));
      cost = wnorm > 0.f ? cost : kCostMax;
      cost = (pd >= lo && pd <= hi) ? cost : kCostMax;
      if (!p.refine) cost = cost > kCostMax ? kCostMax : cost;
      s_out[lane * op + k] = cost;
    }
  }
  __syncthreads();
  for (int i = tid; i < npix * P; i += nthreads) {
    const int q = i / P;
    p.out[b0 * P + i] = s_out[q * op + (i - q * P)];
  }
}

template <typename Q, bool kPixelOffsets, bool kWeighted>
int launch(const Params& p, void* stream) {
  const size_t bytes = smem_floats(p.num_views, p.num_taps, kPixelOffsets,
                                   kWeighted, p.num_probes) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sweep_kernel<Q, kPixelOffsets, kWeighted>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 block(kLanes, p.num_views);
  const unsigned int grid =
      static_cast<unsigned int>((p.num_pix + kLanes - 1) / kLanes);
  sweep_kernel<Q, kPixelOffsets, kWeighted>
      <<<grid, block, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename Q>
int launch_window(const Params& p, bool pixel_offsets, void* stream) {
  const bool weighted = p.tap_w != nullptr;
  if (pixel_offsets) {
    return weighted ? launch<Q, true, true>(p, stream)
                    : launch<Q, true, false>(p, stream);
  }
  return weighted ? launch<Q, false, true>(p, stream)
                  : launch<Q, false, false>(p, stream);
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
                                int weighted, int num_probes) {
  return static_cast<long long>(
      smem_floats(num_views, num_taps, pixel_offsets != 0, weighted != 0,
                  num_probes) *
      sizeof(float));
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
  return quads_u8 ? launch_window<uint8_t>(p, pixel_offsets != 0, stream)
                  : launch_window<float>(p, pixel_offsets != 0, stream);
}

}  // extern "C"
