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
// Layout: one thread per (pixel, source view). A block holds 32 pixels (the
// lanes) and S source views (the warps, S <= 32), so the lanes of a warp
// run over 32 consecutive pixels of one view: the (S, B) store is
// coalesced, and neighbouring lanes' taps land on neighbouring texels of
// one quad table. The block first stages, in shared memory, the per-view
// camera constants, its pixels' coordinates, planes and reference sums,
// and their window (tap values; for an SA window also the per-pixel
// offsets and weights). The S threads of a pixel read them there, not S
// times from device memory. Window rows are padded to an odd stride, so
// the 32 lanes reading tap t of their own pixels hit 32 distinct banks.
//
// Arithmetic equals the plain PyTorch version (ops/cuda/ncc.py,
// `ncc_strong_plain`) bit for bit. Every product, sum, quotient and square
// root is rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn / __fsqrt_rn: no FMA contraction), in the order torch
// evaluates `geometry.homography`, `geometry.warp`, K1's lerp and
// `cost.ncc_from_sums`. The three window sums start at 0 and take the taps
// in order t = 0 .. T-1 in one thread, compensated (Kahan: four rounded
// operations a term), as the plain version does with four elementwise ops
// a tap. One running f32 sum over the 36 taps drifts past the 1e-4
// parity tests with the JAX package; four interleaved partial sums pass
// them but differ from the torch-op composition K2 replaced by more than
// 1e-4 at the strong shape. The compensation is this kernel's choice, not
// the function's work. The per-view R_rel / t_rel come in precomputed
// (`geometry.relative_pose`, the same torch ops for both versions).
//
// NaN: a plane with w = 0 (or NaN / inf components) warps to NaN
// coordinates. The clamp is written with comparisons, which keep NaN
// (fminf / fmaxf would drop it and return a finite, wrong sample); the
// row index goes through __float2int_rz (NaN -> 0) and an integer clamp,
// so no coordinate reads outside its table. The NaN sample makes the sums
// and the cost NaN, and a non-finite cost is COST_MAX.
//
// Bound: operations. The function needs 38 f32 operations a tap (offsets
// 2, warp 12 and 2 divisions, sample 17, products 2, sums 3; an SA tap 2
// products more) and ~90 a (pixel, view) pair for the homography and the
// NCC, against ~36 bytes of window a pixel-tap read once; the
// compensation adds 9 a tap on top. At S = 10, B = 240,000, T = 36 that
// is ~3.5 GFLOP (~0.052 ms at the H100's 67 TFLOP/s of plain f32) against
// ~71 MB (~0.02 ms at 3.35 TB/s). The u8 quad tables (19.2 MB at 600x800x10)
// stay in the 50 MB L2. No matrix product, so no tensor core work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;        // pixels of a block, one per lane
constexpr int kMaxViews = 32;     // source views, one warp each
// a view's row of the camera table: R_rel (9, row-major), t_rel (3), fx,
// fy, cx, cy
constexpr int kCamStride = 16;
// per-pixel arrays in shared memory: x, y, the plane (4), sum_ref,
// sum_rr, 1 / wsum, wsum <= 0
constexpr int kPixelArrays = 10;
constexpr float kCostMax = 2.f;   // cost.COST_MAX
constexpr float kMinVar = 1e-5f;  // cost.MIN_VAR, compared in float32

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

__host__ __device__ inline int window_stride(int num_taps) {
  return num_taps | 1;
}

__host__ __device__ inline size_t smem_floats(int num_views, int num_taps,
                                              bool pixel_offsets,
                                              bool weighted) {
  const size_t rows = static_cast<size_t>(kLanes) * window_stride(num_taps);
  size_t n = static_cast<size_t>(num_views + 1) * kCamStride +
             kPixelArrays * kLanes + rows;
  n += pixel_offsets ? 2 * rows : 2 * static_cast<size_t>(num_taps);
  if (weighted) n += rows;
  return n;
}

template <typename Q, bool kPixelOffsets, bool kWeighted>
__global__ void __launch_bounds__(kLanes * kMaxViews)
ncc_strong_kernel(const Params p) {
  extern __shared__ float smem[];
  const int S = p.num_views;
  const int T = p.num_taps;
  const int tp = window_stride(T);
  float* s_cam = smem;
  float* s_pix = s_cam + (S + 1) * kCamStride;
  float* s_x = s_pix;
  float* s_y = s_x + kLanes;
  float* s_n0 = s_y + kLanes;
  float* s_n1 = s_n0 + kLanes;
  float* s_n2 = s_n1 + kLanes;
  float* s_w = s_n2 + kLanes;
  float* s_sref = s_w + kLanes;
  float* s_srr = s_sref + kLanes;
  float* s_inv = s_srr + kLanes;
  float* s_empty = s_inv + kLanes;
  float* s_val = s_pix + kPixelArrays * kLanes;
  float* s_dx = s_val + kLanes * tp;
  float* s_dy = s_dx + (kPixelOffsets ? kLanes * tp : T);
  float* s_tw = s_dy + (kPixelOffsets ? kLanes * tp : T);

  const int lane = threadIdx.x;
  const int view = threadIdx.y;
  const int tid = view * kLanes + lane;
  const int nthreads = kLanes * S;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kLanes;
  const int npix = static_cast<int>(
      p.num_pix - b0 < kLanes ? p.num_pix - b0 : kLanes);

  // ---- stage the block's inputs in shared memory --------------------------
  for (int i = tid; i < (S + 1) * kCamStride; i += nthreads) {
    s_cam[i] = __ldg(p.cams + i);
  }
  if (tid < npix) {
    const int64_t b = b0 + tid;
    s_x[tid] = __ldg(p.x + b);
    s_y[tid] = __ldg(p.y + b);
    s_n0[tid] = __ldg(p.planes + 4 * b + 0);
    s_n1[tid] = __ldg(p.planes + 4 * b + 1);
    s_n2[tid] = __ldg(p.planes + 4 * b + 2);
    s_w[tid] = __ldg(p.planes + 4 * b + 3);
    s_sref[tid] = __ldg(p.sum_ref + b);
    s_srr[tid] = __ldg(p.sum_rr + b);
    float inv = p.inv_wsum;
    float empty = 0.f;
    if (p.wsum != nullptr) {
      // torch.where(wsum <= 0, 0, 1 / clamp(wsum, min=1e-20))
      const float ws = __ldg(p.wsum + b);
      empty = ws <= 0.f ? 1.f : 0.f;
      inv = ws <= 0.f ? 0.f : dvd(1.f, clamp_min_keep_nan(ws, 1e-20f));
    }
    s_inv[tid] = inv;
    s_empty[tid] = empty;
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
  __syncthreads();
  if (lane >= npix) return;

  // ---- the plane homography (geometry.homography) -------------------------
  const float* c = s_cam + view * kCamStride;
  const float* r = s_cam + S * kCamStride;
  const float x = s_x[lane];
  const float y = s_y[lane];
  const float w = s_w[lane];
  const float nw[3] = {dvd(s_n0[lane], w), dvd(s_n1[lane], w),
                       dvd(s_n2[lane], w)};
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
  float h[3][3];  // K_src (...)
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    h[0][j] = add(mul(fx_s, mk[0][j]), mul(cx_s, mk[2][j]));
    h[1][j] = add(mul(fy_s, mk[1][j]), mul(cy_s, mk[2][j]));
    h[2][j] = mk[2][j];
  }

  // ---- the centre's out-of-image test against the real bounds -------------
  const float pz = row_dot(h[2][0], h[2][1], h[2][2], x, y);
  const float cx = dvd(row_dot(h[0][0], h[0][1], h[0][2], x, y), pz);
  const float cy = dvd(row_dot(h[1][0], h[1][1], h[1][2], x, y), pz);
  const bool oob = cx < 0.f || cx >= p.img_w || cy < 0.f || cy >= p.img_h;

  // ---- the window: warp, sample, sums in tap order ------------------------
  const Q* __restrict__ tab = static_cast<const Q*>(p.quads);
  const int64_t view_row0 =
      static_cast<int64_t>(view) * p.quad_h * static_cast<int64_t>(p.width);
  const float* val = s_val + lane * tp;
  const float* dxs = s_dx + (kPixelOffsets ? lane * tp : 0);
  const float* dys = s_dy + (kPixelOffsets ? lane * tp : 0);
  const float* tws = s_tw + lane * tp;
  float s_src = 0.f, s_ss = 0.f, s_rs = 0.f;
  float c_src = 0.f, c_ss = 0.f, c_rs = 0.f;
  for (int t = 0; t < T; ++t) {
    const float tx = add(x, dxs[t]);
    const float ty = add(y, dys[t]);
    const float tz = row_dot(h[2][0], h[2][1], h[2][2], tx, ty);
    const float wx = dvd(row_dot(h[0][0], h[0][1], h[0][2], tx, ty), tz);
    const float wy = dvd(row_dot(h[1][0], h[1][1], h[1][2], tx, ty), tz);
    const float sv = sample(tab, view_row0, wx, wy, p.width, p.quad_h);
    if (kWeighted) {
      const float tw = tws[t];
      const float wsv = mul(tw, sv);
      kahan_add(s_src, c_src, wsv);
      kahan_add(s_ss, c_ss, mul(wsv, sv));
      kahan_add(s_rs, c_rs, mul(mul(tw, val[t]), sv));
    } else {
      kahan_add(s_src, c_src, sv);
      kahan_add(s_ss, c_ss, mul(sv, sv));
      kahan_add(s_rs, c_rs, mul(val[t], sv));
    }
  }

  // ---- cost.ncc_from_sums -------------------------------------------------
  const float inv = s_inv[lane];
  const float m_ref = mul(s_sref[lane], inv);
  const float m_rr = mul(s_srr[lane], inv);
  const float m_src = mul(s_src, inv);
  const float m_ss = mul(s_ss, inv);
  const float m_rs = mul(s_rs, inv);
  const float var_ref = sub(m_rr, mul(m_ref, m_ref));
  const float var_src = sub(m_ss, mul(m_src, m_src));
  const float covar = sub(m_rs, mul(m_ref, m_src));
  const float denom =
      __fsqrt_rn(clamp_min_keep_nan(mul(var_ref, var_src), 1e-30f));
  const float cost =
      clamp_keep_nan(sub(1.f, dvd(covar, denom)), 0.f, kCostMax);
  const bool degenerate = var_ref < kMinVar || var_src < kMinVar ||
                          !isfinite(cost) || s_empty[lane] != 0.f;
  p.out[static_cast<int64_t>(view) * p.num_pix + b0 + lane] =
      (oob || degenerate) ? kCostMax : cost;
}

template <typename Q, bool kPixelOffsets, bool kWeighted>
int launch(const Params& p, void* stream) {
  const size_t bytes = smem_floats(p.num_views, p.num_taps, kPixelOffsets,
                                   kWeighted) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ncc_strong_kernel<Q, kPixelOffsets, kWeighted>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 block(kLanes, p.num_views);
  const unsigned int grid =
      static_cast<unsigned int>((p.num_pix + kLanes - 1) / kLanes);
  ncc_strong_kernel<Q, kPixelOffsets, kWeighted>
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
  return quads_u8 ? launch_window<uint8_t>(p, pixel_offsets != 0, stream)
                  : launch_window<float>(p, pixel_offsets != 0, stream);
}

}  // extern "C"
