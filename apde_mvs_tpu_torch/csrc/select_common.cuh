// The initial cost's top-k view selection of one pixel, shared by K11
// (select.cu, the tile route's selection over gathered costs), K2's stage
// form (ncc.cu, the epilogue of the launch that makes the image's costs)
// and K6's re-score form (weak.cu, the epilogue of the launch that
// re-scores the weak list), so that the three cannot drift apart and each
// equals the plain version (ops/cuda/select.py, `select_rows_plain`, which
// is `cost.initial_cost_and_selection` and the state update) bit for bit.
//
// Per pixel, in the plain version's order:
//  - k = min(#{cost < COST_MAX}, top_k) (NaN is not below);
//  - the k smallest costs in ascending order (torch.sort puts NaN last, so
//    they are the k smallest of those below COST_MAX), their sum from +0 in
//    that order, the mean as a true division by k, COST_MAX where k = 0;
//  - the threshold, the k-th smallest; a view is selected where its cost
//    is <= the threshold and k > 0 (ties select extra views);
//  - the state: the mean where the pixel is valid, else 1e9; the
//    selections and the pixel's validity.
// The k smallest are taken a distinct value at a time (the least cost above
// the last one taken, and how many views share it), so equal costs are
// added one after another and the sum does not depend on the order a sort
// gives them; a -0 and a +0 add alike to a sum that starts at +0.
//
// `store_selections` writes a block's selections, staged in shared memory
// as one byte a (pixel, view) in the (n, S) map's order, as 16-byte words:
// a block's pixels are consecutive, so their bytes are one range of the
// map.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "ncc_common.cuh"

namespace apde {

constexpr float kInvalidCost = 1e9f;   // an invalid pixel's cost

// The selection of one pixel from its S costs, ``cost_at(s)`` for view s.
// kN is the loops' compile-time bound (>= S, the views past S masked: the
// loops unroll and an array of costs stays in registers), or 0: the loops
// run to S at run time. Returns the state's cost; bit s of ``*selected`` is
// view s's selection.
template <int kN, typename CostAt>
__device__ __forceinline__ float select_top_k(CostAt cost_at, int S,
                                              int top_k, bool valid,
                                              uint32_t* selected) {
  const int n = kN > 0 ? kN : S;
  int below = 0;
#pragma unroll
  for (int s = 0; s < n; ++s) {
    below += ((kN == 0 || s < S) && cost_at(s) < kCostMax) ? 1 : 0;
  }
  const int k = below < top_k ? below : top_k;
  // the k smallest, a distinct value at a time: each is below COST_MAX
  float sum = 0.f, thresh = 0.f;
  int taken = 0;
  bool first = true;
  while (taken < k) {
    float least = kCostMax;
#pragma unroll
    for (int s = 0; s < n; ++s) {
      const float c = cost_at(s);
      const bool above = first || c > thresh;
      if ((kN == 0 || s < S) && above && c < least) least = c;
    }
    int same = 0;
#pragma unroll
    for (int s = 0; s < n; ++s) {
      same += ((kN == 0 || s < S) && cost_at(s) == least) ? 1 : 0;
    }
    const int take = same < k - taken ? same : k - taken;
    for (int j = 0; j < take; ++j) sum = add(sum, least);
    taken += take;
    thresh = least;
    first = false;
  }
  const float mean = k > 0 ? dvd(sum, static_cast<float>(k)) : kCostMax;
  uint32_t bits = 0u;
  if (valid && k > 0) {
#pragma unroll
    for (int s = 0; s < n; ++s) {
      if ((kN == 0 || s < S) && cost_at(s) <= thresh) bits |= 1u << s;
    }
  }
  *selected = bits;
  return valid ? mean : kInvalidCost;
}

// A pixel's selection bits as S bytes of 0 / 1 at ``out``.
__device__ __forceinline__ void selection_bytes(uint32_t bits, int S,
                                                uint8_t* out) {
  for (int s = 0; s < S; ++s) out[s] = static_cast<uint8_t>((bits >> s) & 1u);
}

// A block's staged selections, ``nbytes`` bytes at ``staged`` (shared
// memory, 16-byte aligned), copied to ``dst``: as 16-byte words where
// ``dst`` is 16-byte aligned, the tail a byte at a time; every thread of
// the block takes part (after a __syncthreads that follows the staging).
__device__ __forceinline__ void store_selections(const uint8_t* staged,
                                                 uint8_t* dst, int nbytes,
                                                 int tid, int threads) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15u) == 0u) {
    const int words = nbytes >> 4;
    const uint4* src = reinterpret_cast<const uint4*>(staged);
    uint4* to = reinterpret_cast<uint4*>(dst);
    for (int i = tid; i < words; i += threads) to[i] = src[i];
    done = words << 4;
  }
  for (int i = done + tid; i < nbytes; i += threads) dst[i] = staged[i];
}

}  // namespace apde
