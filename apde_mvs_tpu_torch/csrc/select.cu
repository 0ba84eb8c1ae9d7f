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
// Per pixel, the selection of select_common.cuh (`select_top_k`), which
// K2's stage form and K6's re-score form run in their epilogues on the
// serial and view-parallel routes: since then K11 runs only on the tile
// route, over the whole image's gathered costs.
//
// Layout: one thread a pixel. The S costs come a view at a time from an
// (S, n) array (view-major: the lanes of a warp read consecutive pixels,
// coalesced) or an (n, S) one (the tile route's gather), as its strides say;
// they stay in registers, the loops unrolled over the least of 8, 16 and 32
// that holds S (the views past S masked). The block's selections are
// staged in shared memory as its pixels' bytes in the map's order and
// written as 16-byte words (`store_selections`), where one thread a pixel
// would store S bytes at stride S.
//
// Bound: bytes. At 600x800 and S = 10 the launch reads the 19.2 MB of
// costs and the 0.48 MB validity map and writes the 1.92 MB cost map and
// 4.8 MB of selections: 26.4 MB, 0.0079 ms at 3.35 TB/s; its ~1,000
// operations a pixel are ~0.007 ms at 67 TFLOP/s.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ncc_common.cuh"
#include "select_common.cuh"

namespace {

using namespace apde;

constexpr int kThreads = 256;

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

// kN: the loops' bound, the least of 8, 16, 32 that holds S
template <int kN>
__global__ void __launch_bounds__(kThreads) topk_select_kernel(const Params p) {
  __shared__ __align__(16) uint8_t s_sel[kThreads * kN];
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int tid = threadIdx.x;
  const int64_t i = b0 + tid;
  const int S = p.num_views;
  if (i < p.num_pix) {
    float c[kN];
#pragma unroll
    for (int s = 0; s < kN; ++s) {
      c[s] = s < S ? __ldg(p.costs + s * p.view_stride + i * p.pixel_stride)
                   : kCostMax;
    }
    uint32_t bits;
    p.cost_out[i] = select_top_k<kN>([&](int s) { return c[s]; }, S,
                                     p.top_k, p.valid[i] != 0, &bits);
    selection_bytes(bits, S, s_sel + tid * S);
  }
  __syncthreads();
  const int64_t left = p.num_pix - b0;
  const int npix = left < kThreads ? static_cast<int>(left) : kThreads;
  store_selections(s_sel, p.sel_out + b0 * S, npix * S, tid, kThreads);
}

using Kernel = void (*)(const Params);

// the instantiation for S views
Kernel pick(int num_views) {
  return num_views <= 8 ? topk_select_kernel<8>
         : num_views <= 16 ? topk_select_kernel<16>
                           : topk_select_kernel<32>;
}

}  // namespace

// Plain C interface for ctypes. Every pointer is a device pointer; the
// function returns cudaGetLastError() after its launch (0 = cudaSuccess).
extern "C" {

int apde_select_max_views() { return kMaxViews; }

// The instantiation's registers, local memory (spills) and resident blocks
// an SM at S views; returns the first error.
int apde_select_kernel_info(int num_views, int* regs, int* local_bytes,
                            int* blocks_per_sm) {
  const Kernel kernel = pick(num_views);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm,
                                                        kernel, kThreads, 0);
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
  const Kernel kernel = pick(num_views);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
