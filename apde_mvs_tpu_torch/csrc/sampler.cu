// K1 — bilinear sampler with edge clamp, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel apde_mvs_tpu/ops/pallas/sampler.py
// (`_sampler_kernel`, entry `sample_blocks`), which sampled through two
// hat-weight contractions over a VMEM window because the TPU has no fast
// gather. On Hopper a gather is cheap, so the kernel is the plain
// definition: one thread per sample, clamp, floor, one row load, lerp.
//
// Two table forms, one launch each:
//  - packed: S quad tables (S, N, 4) of u8 or f32 in the pack_bilinear
//    layout [v00, v01, v10, v11], N = height * width, and coordinates
//    (S, M); sample i of view s reads one 4-byte (u8) or 16-byte (f32) row
//    of table s. This is the main-path form: one launch covers all source
//    views of one plane hypothesis.
//  - image: one (H, W) f32 image and coordinates of any shape (M); four
//    scalar loads per sample with the right/down neighbours clamped.
//
// Arithmetic equals the plain PyTorch version (apde_mvs_tpu_torch/ops/cuda/
// sampler.py) bit for bit: every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn block FMA contraction), in the order
// top = v00*(1-fx) + v01*fx; bot = v10*(1-fx) + v11*fx;
// out = top*(1-fy) + bot*fy.
//
// NaN: a NaN coordinate must give a NaN sample, as jnp.clip / torch.clamp
// propagate it (fminf/fmaxf would drop it and return a finite, wrong
// sample). The float clamp is written with comparisons, which keep NaN;
// the row index is computed with __float2int_rz (NaN -> 0) and then clamped
// as an integer, so no coordinate can read outside the table.
//
// Bound: the coordinates in (8 bytes) and the sample out (4 bytes) stream
// through once; the quad tables (a few MB at 600x800x10) stay in the 50 MB
// L2. Memory-bound: 12 bytes per sample over 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float clamp_keep_nan(float v, float hi) {
  return v < 0.f ? 0.f : (v > hi ? hi : v);
}

__device__ __forceinline__ int clamp_int(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__device__ __forceinline__ float lerp4(float v00, float v01, float v10,
                                       float v11, float fx, float fy) {
  const float gx = __fsub_rn(1.f, fx);
  const float gy = __fsub_rn(1.f, fy);
  const float top = __fadd_rn(__fmul_rn(v00, gx), __fmul_rn(v01, fx));
  const float bot = __fadd_rn(__fmul_rn(v10, gx), __fmul_rn(v11, fx));
  return __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
sample_packed_kernel(const T* __restrict__ quads, const float* __restrict__ xs,
                     const float* __restrict__ ys, float* __restrict__ out,
                     int64_t per_view, int64_t total, int width, int height) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (i >= total) return;
  const int64_t view = i / per_view;
  const float x = clamp_keep_nan(xs[i], width - 1.f);
  const float y = clamp_keep_nan(ys[i], height - 1.f);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const int xi = clamp_int(__float2int_rz(x0), width - 1);
  const int yi = clamp_int(__float2int_rz(y0), height - 1);
  const int64_t row = (view * height + yi) * static_cast<int64_t>(width) + xi;
  const float4 v = load_row(quads, row);
  out[i] = lerp4(v.x, v.y, v.z, v.w, __fsub_rn(x, x0), __fsub_rn(y, y0));
}

__global__ void __launch_bounds__(kThreads)
sample_image_kernel(const float* __restrict__ img, const float* __restrict__ xs,
                    const float* __restrict__ ys, float* __restrict__ out,
                    int64_t total, int width, int height) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (i >= total) return;
  const float x = clamp_keep_nan(xs[i], width - 1.f);
  const float y = clamp_keep_nan(ys[i], height - 1.f);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const int xi = clamp_int(__float2int_rz(x0), width - 1);
  const int yi = clamp_int(__float2int_rz(y0), height - 1);
  const int x1 = min(xi + 1, width - 1);
  const int y1 = min(yi + 1, height - 1);
  const int64_t r0 = static_cast<int64_t>(yi) * width;
  const int64_t r1 = static_cast<int64_t>(y1) * width;
  out[i] = lerp4(__ldg(img + r0 + xi), __ldg(img + r0 + x1),
                 __ldg(img + r1 + xi), __ldg(img + r1 + x1),
                 __fsub_rn(x, x0), __fsub_rn(y, y0));
}

// Does nothing on K1's grid: its time is the fixed cost of a launch of
// that many blocks, the floor under K1's own time at small sizes.
__global__ void __launch_bounds__(kThreads) empty_kernel() {}

inline unsigned int blocks_for(int64_t total) {
  return static_cast<unsigned int>((total + kThreads - 1) / kThreads);
}

template <typename T>
int launch_packed(const void* quads, const void* xs, const void* ys, void* out,
                  int64_t per_view, int64_t total, int width, int height,
                  void* stream) {
  if (total > 0) {
    sample_packed_kernel<T><<<blocks_for(total), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(quads), static_cast<const float*>(xs),
        static_cast<const float*>(ys), static_cast<float*>(out), per_view,
        total, width, height);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Every pointer is a device pointer; every
// function returns cudaGetLastError() after its launch (0 = cudaSuccess).
extern "C" {

int apde_sample_packed_u8(const void* quads, const void* xs, const void* ys,
                          void* out, int64_t per_view, int64_t total,
                          int width, int height, void* stream) {
  return launch_packed<uint8_t>(quads, xs, ys, out, per_view, total, width,
                                height, stream);
}

int apde_sample_packed_f32(const void* quads, const void* xs, const void* ys,
                           void* out, int64_t per_view, int64_t total,
                           int width, int height, void* stream) {
  return launch_packed<float>(quads, xs, ys, out, per_view, total, width,
                              height, stream);
}

int apde_sample_image_f32(const void* img, const void* xs, const void* ys,
                          void* out, int64_t total, int width, int height,
                          void* stream) {
  if (total > 0) {
    sample_image_kernel<<<blocks_for(total), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(img), static_cast<const float*>(xs),
        static_cast<const float*>(ys), static_cast<float*>(out), total, width,
        height);
  }
  return static_cast<int>(cudaGetLastError());
}

int apde_sample_empty(int64_t total, void* stream) {
  if (total > 0) {
    empty_kernel<<<blocks_for(total), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>();
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
