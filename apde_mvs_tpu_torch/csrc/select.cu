// K11 — the initial cost's top-k view selection, hand-written for Hopper
// (sm_90a).
//
// Replaces the view selection the JAX package leaves to XLA
// (apde_mvs_tpu/ops/cost.py:430, `initial_cost_and_selection`; the CUDA
// reference is ComputeMultiViewInitialCostandSelectedViews, APD.cu:723-774)
// and the state update around it (apde_mvs_tpu/ops/init.py:85-90). The port
// ran it as torch ops over the whole image: a `torch.sort` of the (H W, S)
// costs, a gather and about ten elementwise ops, then two `where`s into the
// state. Here one launch reads each pixel's S costs and writes the state's
// new cost map and selections.
//
// Per pixel, in the order of the plain version (ops/cuda/select.py,
// `select_plain`, which is `cost.initial_cost_and_selection`):
//  - k = min(#{cost < COST_MAX}, top_k) (NaN is not below);
//  - the k smallest costs in ascending order (torch.sort puts NaN last, so
//    they are the k smallest of those below COST_MAX), their sum from +0 in
//    that order, the mean as a true division by k, COST_MAX where k = 0;
//  - the threshold, the k-th smallest; a view is selected where its cost
//    is <= the threshold and k > 0 (ties select extra views);
//  - the state: the mean where the pixel is valid, else 1e9; the
//    selections and the pixel's validity.
// Equal costs are added one after another, so the sum does not depend on
// the order the sort gives them; a -0 and a +0 add alike to a sum that
// starts at +0.
//
// Layout: one thread a pixel. The S costs come a view at a time from an
// (S, n) array (view-major: the lanes of a warp read consecutive pixels,
// coalesced) or an (n, S) one (the tile route's gather), as its strides say;
// they stay in registers (S <= 32, the loops unrolled over 32 with the
// views past S masked). The k smallest are found a distinct value at a time:
// the least cost above the last one taken, and how many views share it.
//
// Bound: bytes. At 600x800 and S = 10 the launch reads the 19.2 MB of
// costs and the 0.48 MB validity map and writes the 1.92 MB cost map and
// 4.8 MB of selections: 26.4 MB, 0.0079 ms at 3.35 TB/s; its ~1,000
// operations a pixel are ~0.007 ms at 67 TFLOP/s.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ncc_common.cuh"

namespace {

using namespace apde;

constexpr int kThreads = 256;
constexpr float kInvalidCost = 1e9f;   // an invalid pixel's cost

struct Params {
  const float* costs;      // pixel i's view s at s * view_stride +
  int64_t view_stride;     //   i * pixel_stride
  int64_t pixel_stride;
  const uint8_t* valid;    // (n,) bool
  float* cost_out;         // (n,)
  uint8_t* sel_out;        // (n, S) bool
  int64_t num_pix;
  int num_views;
  int top_k;
};

__global__ void __launch_bounds__(kThreads) topk_select_kernel(const Params p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= p.num_pix) return;
  const int S = p.num_views;
  float c[kMaxViews];
  int below = 0;
#pragma unroll
  for (int s = 0; s < kMaxViews; ++s) {
    c[s] = s < S ? __ldg(p.costs + s * p.view_stride + i * p.pixel_stride)
                 : kCostMax;
    below += (s < S && c[s] < kCostMax) ? 1 : 0;
  }
  const int k = below < p.top_k ? below : p.top_k;
  // the k smallest, a distinct value at a time: each is below COST_MAX
  float sum = 0.f, thresh = 0.f;
  int taken = 0;
  bool first = true;
  while (taken < k) {
    float least = kCostMax;
#pragma unroll
    for (int s = 0; s < kMaxViews; ++s) {
      const bool above = first || c[s] > thresh;
      if (s < S && above && c[s] < least) least = c[s];
    }
    int same = 0;
#pragma unroll
    for (int s = 0; s < kMaxViews; ++s) {
      same += (s < S && c[s] == least) ? 1 : 0;
    }
    const int take = same < k - taken ? same : k - taken;
    for (int j = 0; j < take; ++j) sum = add(sum, least);
    taken += take;
    thresh = least;
    first = false;
  }
  const bool valid = p.valid[i] != 0;
  const float mean = k > 0 ? dvd(sum, static_cast<float>(k)) : kCostMax;
  p.cost_out[i] = valid ? mean : kInvalidCost;
  uint8_t* sel = p.sel_out + i * S;
#pragma unroll
  for (int s = 0; s < kMaxViews; ++s) {
    if (s < S) sel[s] = (valid && k > 0 && c[s] <= thresh) ? 1 : 0;
  }
}

}  // namespace

// Plain C interface for ctypes. Every pointer is a device pointer; the
// function returns cudaGetLastError() after its launch (0 = cudaSuccess).
extern "C" {

int apde_select_max_views() { return kMaxViews; }

// The kernel's registers, local memory (spills) and resident blocks an SM;
// returns the first error.
int apde_select_kernel_info(int* regs, int* local_bytes, int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, topk_select_kernel);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, topk_select_kernel, kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}

// K11 over num_pix pixels: pixel i's S costs at costs + s * view_stride +
// i * pixel_stride, its validity valid[i]; writes cost_out[i] and
// sel_out[i * S + s].
int apde_select(const void* costs, int64_t view_stride, int64_t pixel_stride,
                const void* valid, void* cost_out, void* sel_out,
                int64_t num_pix, int num_views, int top_k, void* stream) {
  if (num_pix <= 0) return static_cast<int>(cudaGetLastError());
  if (num_views < 1 || num_views > kMaxViews || top_k < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.costs = static_cast<const float*>(costs);
  p.view_stride = view_stride;
  p.pixel_stride = pixel_stride;
  p.valid = static_cast<const uint8_t*>(valid);
  p.cost_out = static_cast<float*>(cost_out);
  p.sel_out = static_cast<uint8_t*>(sel_out);
  p.num_pix = num_pix;
  p.num_views = num_views;
  p.top_k = top_k;
  const unsigned int grid =
      static_cast<unsigned int>((num_pix + kThreads - 1) / kThreads);
  topk_select_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
