// A pixel's reference window built in the kernel from the reference image
// and the SA segment ids, shared by K3 (strong.cu, the strong sweep's colour
// update), K5 (sweep.cu, the disparity sweeps of DepthToWeak and
// LocalRefine) and K2's stage form (ncc.cu, the initial cost), so that no
// per-pixel window goes through device memory and the three cannot drift
// apart.
//
// The window is `cost.precompute_ref_window`'s: the square taps of (radius,
// increment), dy outer, or, under SA where the pixel's segment id is not 0,
// the 36-tap star (4 quadrants x 9 taps), each quadrant cut at its first
// in-image tap that leaves the segment, out-of-image taps weighing 0
// without cutting (the weights are one 36-bit mask); the values fetched
// with the indices clamped to the image array; sum_ref, sum_rr and the
// weight sum in tap order (the plain version's order:
// `ops/cuda/strong.py` `window_plain`).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "ncc_common.cuh"

namespace apde {

// the main path's square window, cost.square_taps(5, 2): offsets
// -5, -3, .., 5 on each axis, 6 x 6 taps
constexpr int kMainRadius = 5;
constexpr int kMainIncrement = 2;
constexpr int kAxis = 6;
// the SA star (cost.star_taps): quadrant q's signs, then 9 taps whose
// offsets index {1, 3, 5}, two bits a tap
constexpr int kQuadTaps = 9;
constexpr uint32_t kStarIx = 0x26904u;   // 0 1 0 0 1 2 2 1 2
constexpr uint32_t kStarIy = 0x29190u;   // 0 0 1 2 1 0 1 2 2
constexpr int kStarTaps = 4 * kQuadTaps;
constexpr unsigned kWindowLanes = 0xffffffffu;

__host__ __device__ constexpr int star_index(uint32_t table, int k) {
  return static_cast<int>((table >> (2 * k)) & 3u);
}
__host__ __device__ constexpr int star_sign_x(int q) {
  return (q & 1) ? -1 : 1;              // quadrants (1, 1), (-1, -1), (1, -1),
}
__host__ __device__ constexpr int star_sign_y(int q) {
  return (q == 1 || q == 2) ? -1 : 1;   // (-1, 1)
}

// taps an axis of the square of (radius, increment): cost.square_taps
__host__ __device__ inline int axis_taps(int radius, int increment) {
  return 2 * radius / increment + 1;
}

// cost.precompute_ref_window's `fetch` of a segment id: 0 outside the array
__device__ __forceinline__ int segment_at(const int* __restrict__ sa, int x,
                                          int y, int w, int h) {
  return (x >= 0 && x < w && y >= 0 && y < h)
             ? __ldg(sa + static_cast<int64_t>(y) * w + x)
             : 0;
}

// The star's weights from its taps' in-image and leaving-the-segment
// bits: each quadrant's taps up to its first in-image tap that leaves the
// segment (exclusive), out-of-image taps 0.
__device__ __forceinline__ uint64_t star_weights(uint64_t in_image,
                                                 uint64_t leaves) {
  uint64_t keep = in_image;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t brk =
        static_cast<uint32_t>(leaves >> (kQuadTaps * q)) & 0x1ffu;
    if (brk != 0u) {
      const uint64_t cut = (0x1ffull << (__ffs(brk) - 1)) & 0x1ffull;
      keep &= ~(cut << (kQuadTaps * q));
    }
  }
  return keep;
}

// Where a window's taps come from: the reference image (ref_h, width), the
// SA segment ids of the same shape (null: no SA), the real (unpadded)
// bounds of the star's in-image test, and the square's (radius, increment)
// with its taps an axis and its float32 1 / T.
struct WindowSource {
  const float* ref;
  const int* sa;
  int ref_h;
  int width;
  int img_w;
  int img_h;
  int radius;
  int increment;
  int axis_n;
  float inv_wsum;
};

// The square's offsets of tap t (kMain: the main path's constants)
template <bool kMain>
__device__ __forceinline__ void square_offsets(const WindowSource& src, int t,
                                               int* dx, int* dy) {
  const int n = kMain ? kAxis : src.axis_n;
  const int inc = kMain ? kMainIncrement : src.increment;
  const int rad = kMain ? kMainRadius : src.radius;
  const int iy = t / n;
  *dx = inc * (t - iy * n) - rad;
  *dy = inc * iy - rad;
}

// Stages pixel (xi, yi)'s window of T taps in a warp's slice of shared
// memory, every lane of the warp taking part: the tap values (SA: the
// weight-value products) in ``w_val``; under SA the weights in ``w_tw``
// and the offsets in ``w_dx`` / ``w_dy``; the square's offsets there too
// where ``kSquareOffsets``. SA mixes the star only with 36-tap squares
// (the wrappers check): two taps a lane, every load issued before any
// depends on another (the centre's segment id, each star tap's, both
// windows' values). Returns the window's weight sum (T but for a star),
// the same on every lane; the writes are not yet synchronised.
template <bool kSA, bool kMain, bool kSquareOffsets>
__device__ __forceinline__ int stage_window(
    const WindowSource& src, int xi, int yi, int T, int lane, float* w_val,
    float* w_tw, float* w_dx, float* w_dy) {
  // cost.precompute_ref_window's clamped_fetch of the reference image
  auto ref_value = [&](int dx, int dy) {
    return __ldg(src.ref +
                 static_cast<int64_t>(clamp_int(yi + dy, src.ref_h - 1)) *
                     src.width +
                 clamp_int(xi + dx, src.width - 1));
  };
  int weight_sum = T;
  if constexpr (kSA) {
    const int centre = segment_at(src.sa, xi, yi, src.width, src.ref_h);
    int sx[2], sy[2], qx[2], qy[2], seg[2];
    float star_v[2], square_v[2];
    bool inb[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = 32 * half + lane;
      const int q = t / kQuadTaps, k = t - q * kQuadTaps;
      sx[half] = star_sign_x(q) * (2 * star_index(kStarIx, k) + 1);
      sy[half] = star_sign_y(q) * (2 * star_index(kStarIy, k) + 1);
      square_offsets<kMain>(src, t, &qx[half], &qy[half]);
      const int tx = xi + sx[half], ty = yi + sy[half];
      inb[half] = t < kStarTaps && tx >= 0 && tx < src.img_w && ty >= 0 &&
                  ty < src.img_h;
      seg[half] =
          inb[half] ? segment_at(src.sa, tx, ty, src.width, src.ref_h) : 0;
      star_v[half] = t < kStarTaps ? ref_value(sx[half], sy[half]) : 0.f;
      square_v[half] = t < kStarTaps ? ref_value(qx[half], qy[half]) : 0.f;
    }
    // the star where the pixel lies in a segment (its id > 0): each
    // quadrant cut at its first in-image tap that leaves the segment,
    // out-of-image taps 0
    const bool star = centre > 0;
    uint64_t in_image = 0ull, leaves = 0ull;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const bool brk = inb[half] && seg[half] != centre;
      in_image |= static_cast<uint64_t>(__ballot_sync(kWindowLanes,
                                                      inb[half]))
                  << (32 * half);
      leaves |= static_cast<uint64_t>(__ballot_sync(kWindowLanes, brk))
                << (32 * half);
    }
    const uint64_t keep = star_weights(in_image, leaves);
    if (star) weight_sum = __popcll(keep);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = 32 * half + lane;
      if (t < kStarTaps) {
        const float w = (!star || ((keep >> t) & 1ull)) ? 1.f : 0.f;
        w_val[t] = mul(w, star ? star_v[half] : square_v[half]);
        w_tw[t] = w;
        w_dx[t] = static_cast<float>(star ? sx[half] : qx[half]);
        w_dy[t] = static_cast<float>(star ? sy[half] : qy[half]);
      }
    }
  } else {
    for (int t = lane; t < T; t += 32) {
      int dx, dy;
      square_offsets<kMain>(src, t, &dx, &dy);
      w_val[t] = ref_value(dx, dy);
      if (kSquareOffsets) {
        w_dx[t] = static_cast<float>(dx);
        w_dy[t] = static_cast<float>(dy);
      }
    }
  }
  return weight_sum;
}

// A staged window's sum_ref and sum_rr in tap order in one thread: the
// terms w v and (w v) v, where (w v) v = (w v) (w v) for a weight of 0
// or 1. K2's stage form sums a block's windows so, a thread a pixel;
// `build_window` splits the two sums over lanes 0 and 1 (one chain a lane:
// taking both on lane 0 made K3 2-3% slower, PERF.md §6).
__device__ __forceinline__ void staged_window_sums(const float* w_val, int T,
                                                   float* sum_ref,
                                                   float* sum_rr) {
  float sr = 0.f, srr = 0.f;
  for (int t = 0; t < T; ++t) {
    const float wv = w_val[t];
    sr = add(sr, wv);
    srr = add(srr, mul(wv, wv));
  }
  *sum_ref = sr;
  *sum_rr = srr;
}

// Builds pixel (xi, yi)'s window of T taps in a warp's slice of shared
// memory (`stage_window`). Returns the window as a thread reads it, its
// sums in tap order (lanes 0 and 1 add `staged_window_sums`' terms).
template <bool kSA, bool kMain, bool kSquareOffsets>
__device__ __forceinline__ PixelWindow build_window(
    const WindowSource& src, int xi, int yi, int T, int lane, float* w_val,
    float* w_tw, float* w_dx, float* w_dy) {
  const int weight_sum = stage_window<kSA, kMain, kSquareOffsets>(
      src, xi, yi, T, lane, w_val, w_tw, w_dx, w_dy);
  __syncwarp();
  // sum_ref and sum_rr in tap order, lanes 0 and 1
  float part = 0.f;
  if (lane < 2) {
    for (int t = 0; t < T; ++t) {
      const float wv = w_val[t];
      part = add(part, lane == 0 ? wv : mul(wv, wv));
    }
  }
  PixelWindow win;
  win.dx = w_dx;
  win.dy = w_dy;
  win.val = w_val;
  win.tw = w_tw;
  win.sum_ref = __shfl_sync(kWindowLanes, part, 0);
  win.sum_rr = __shfl_sync(kWindowLanes, part, 1);
  win.inv = src.inv_wsum;
  win.empty = false;
  if (kSA) {
    inverse_weight_sum(static_cast<float>(weight_sum), &win.inv, &win.empty);
  }
  return win;
}

}  // namespace apde
