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

#include "ncc_common.cuh"

namespace {

using namespace apde;

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
  __syncthreads();
  if (lane >= npix) return;

  // ---- the plane homography, then the window's NCC ----------------------
  const float* c = s_cam + view * kCamStride;
  const float* r = s_cam + S * kCamStride;
  float h[3][3];
  plane_homography(c, r, s_n0[lane], s_n1[lane], s_n2[lane], s_w[lane], h);
  PixelWindow win;
  win.dx = s_dx + (kPixelOffsets ? lane * tp : 0);
  win.dy = s_dy + (kPixelOffsets ? lane * tp : 0);
  win.val = s_val + lane * tp;
  win.tw = s_tw + lane * tp;
  win.sum_ref = s_sref[lane];
  win.sum_rr = s_srr[lane];
  win.inv = s_inv[lane];
  win.empty = s_empty[lane] != 0.f;
  const int64_t view_row0 =
      static_cast<int64_t>(view) * p.quad_h * static_cast<int64_t>(p.width);
  p.out[static_cast<int64_t>(view) * p.num_pix + b0 + lane] =
      window_ncc<Q, kWeighted>(static_cast<const Q*>(p.quads), view_row0, h,
                               s_x[lane], s_y[lane], T, win, p.width,
                               p.quad_h, p.img_w, p.img_h);
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
