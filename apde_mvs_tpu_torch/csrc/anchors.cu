// K8, K9 and K10 — the APD setup of a pass, hand-written for Hopper
// (sm_90a): anchor generation, the fit-plane RANSAC and the nearest-strong
// jump flooding.
//
// They replace what the JAX package leaves to XLA (XLA-compiled jnp, no
// Pallas), in apde_mvs_tpu/ops/anchors.py:
//  - K10 `nearest_strong_jfa` (:44-99; the reference's brute-force
//    FindNearestStrongPoint, APD.cu:2434-2484);
//  - K8 `gen_anchors` (:191-373; the reference's GenAnchors,
//    APD.cu:1857-2082);
//  - K9 `ransac_fit_planes` (:386-467; the reference's
//    RANSACToGetFitPlane, APD.cu:2486-2598).
// The port first ran them as torch ops: K10 as 12 steps x 8 neighbours x
// ~25 ops, K8 as every probe of every weak pixel (2,432 columns a pixel at
// rotate_time 4) and a 50-iteration loop of ~60 ops, K9 as a 50-iteration
// loop of ~40 ops: ~11,000 small launches an APD pass, each issued by the
// host. Here K10 is 96 launches (one a sub-pass), K8 one a chunk of weak
// pixels and K9 one a call.
//
// Every float operation is rounded on its own (ncc_common.cuh's mul / add
// / sub / dvd, __fsqrt_rn; no FMA contraction), in the order of the plain
// versions in ops/anchors.py, and every comparison is the plain version's,
// so each kernel equals its plain version bit for bit.
//
// K10 (`jfa_step`): a thread a pixel. Inside one step the plain version
// relaxes the 8 neighbours in turn, each against the map the previous
// neighbours have already rewritten everywhere, so a pixel cannot replay
// the chain alone: each (step, neighbour) is a sub-pass of its own, one
// launch reading one map and writing the other (ping-pong), the (dy, dx)
// order and the extra step of 1 kept. A candidate is taken where it is a
// strong pixel (x >= 0) with confidence >= the pixel's and nearer, or as
// near with higher confidence than the current best; (-1, -1) fills
// outside the image. The first sub-pass reads the initial map (each strong
// pixel itself, else (-1, -1)) straight from the state; the last maps
// strong pixels to themselves. Integer work and exact float compares.
// Bound: bytes for the map's single read and write, operations (about 20
// a pixel a sub-pass) for the flooding: a few us of the card's time
// against 96 launches.
//
// K9 (`fit_planes`): a thread a weak pixel, its 8 anchors' camera-frame
// points in registers, the 50 iterations in a loop: three ranks from the
// draws, the n-th valid anchors, the point-in-triangle test, the plane,
// the cost as the distances of the other valid anchors summed in slot
// order; the strictly lower cost is taken, so the first minimum wins.
// Then the flip toward the camera against the view direction, whose length
// is taken in float64 and rounded once. Bound: bytes (the 50 draws of a
// pixel, 600 B, dominate).
//
// K8 (`gen_anchors`): a warp a weak pixel, a lane a direction (D =
// 8 rotate_time <= 32). Each lane walks its direction's probes in the flat
// order of the plain version (radius-major, then jitter) and stops at the
// first accepted one, reading the jitter draws only up to it; a radius
// whose un-jittered test point has left the image ends the walk (every
// later radius's test point lies farther out, so no later probe can be
// accepted). Hit counts and
// RANSAC inlier counts are warp ballots, the n-th valid hit the n-th set
// bit of the hits' ballot, the triplet's points shuffled from their lanes;
// the best support plane is the one with the most inliers (at least 6,
// more than the best's, starting at 3), ties to the nearer centre, the
// first iteration kept on a tie. The anchors are the 8 smallest of
// `dist - is_abc` over the inliers, ties to the lower direction (a stable
// argsort's order), each lane's rank counted against the others by
// shuffles. Bound: bytes (the RANSAC draws, the probes' jitter draws and
// the nearest-strong texels they read, each once) against operations (the
// probes and the 50 iterations over D lanes); the warp's lanes run in lock
// step, so a pixel costs its longest walk.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "geom_common.cuh"
#include "ncc_common.cuh"
#include "ransac_common.cuh"

namespace {

using namespace apde;

constexpr int kSlots = 8;           // ANCHOR_NUM - 1 anchors besides self
constexpr int kMaxDirections = 32;  // a warp's lanes
constexpr unsigned kFull = 0xffffffffu;
constexpr int kJfaThreads = 256;
constexpr int kFitThreads = 128;
constexpr int kGenWarps = 4;
constexpr int kGenThreads = kGenWarps * 32;

// core.sampling.fetch of channel ``channel`` of an f32 (H, W, stride) map
// at (x, y): 0 outside the map
__device__ __forceinline__ float fetch_f(const float* __restrict__ map,
                                         int stride, int channel, int h,
                                         int w, int x, int y) {
  if (x < 0 || y < 0 || x >= w || y >= h) return 0.f;
  return __ldg(map + (static_cast<int64_t>(y) * w + x) * stride + channel);
}

__device__ __forceinline__ int clamp0(int v) { return v < 0 ? 0 : v; }

// ---------------------------------------------------------------------------
// K10: one (step, neighbour) sub-pass of the jump flooding
// ---------------------------------------------------------------------------

// the initial map at (x, y): the pixel itself where it is ``strong`` (the
// STRONG code) and valid
__device__ __forceinline__ int2 initial(const int* __restrict__ weak,
                                        const uint8_t* __restrict__ valid,
                                        int strong, int64_t p, int x, int y) {
  return (__ldg(weak + p) == strong && __ldg(valid + p) != 0)
             ? make_int2(x, y)
             : make_int2(-1, -1);
}

__global__ void __launch_bounds__(kJfaThreads)
    jfa_step(const int2* __restrict__ in, int2* __restrict__ out,
             const int* __restrict__ weak, const float* __restrict__ conf,
             const uint8_t* __restrict__ valid, int strong, int h, int w,
             int ox, int oy, int last) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kJfaThreads +
                    threadIdx.x;
  if (p >= static_cast<int64_t>(h) * w) return;
  const int x = static_cast<int>(p % w);
  const int y = static_cast<int>(p / w);
  const int2 b = in ? in[p] : initial(weak, valid, strong, p, x, y);
  const int nx = x + ox, ny = y + oy;
  int2 c = make_int2(-1, -1);
  if (nx >= 0 && nx < w && ny >= 0 && ny < h) {
    const int64_t q = static_cast<int64_t>(ny) * w + nx;
    c = in ? in[q] : initial(weak, valid, strong, q, nx, ny);
  }
  const float own = __ldg(conf + p);
  const float c_conf = fetch_f(conf, 1, 0, h, w, clamp0(c.x), clamp0(c.y));
  const bool cand_ok = c.x >= 0 && c_conf >= own;
  const int d_cand = (c.x - x) * (c.x - x) + (c.y - y) * (c.y - y);
  const float b_conf = fetch_f(conf, 1, 0, h, w, clamp0(b.x), clamp0(b.y));
  const int d_best = b.x >= 0 ? (b.x - x) * (b.x - x) + (b.y - y) * (b.y - y)
                              : 0x7fffffff;
  const bool better =
      cand_ok && (d_cand < d_best || (d_cand == d_best && c_conf > b_conf));
  int2 r = better ? c : b;
  if (last && __ldg(weak + p) == strong && __ldg(valid + p) != 0) {
    r = make_int2(x, y);
  }
  out[p] = r;
}

// ---------------------------------------------------------------------------
// K9: the fit-plane RANSAC, a thread a weak pixel
// ---------------------------------------------------------------------------

struct FitParams {
  const float* planes;     // (H, W, 4) camera-frame planes
  int h, w;
  const int* wx;           // (N,)
  const int* wy;
  const int* anchors;      // (N, 9, 2); slot 0 the pixel
  const int* triplets;     // (iters, N, 3) rows ``trip_stride`` apart
  int64_t trip_stride;
  int iters;               // RANSAC iterations
  int n;
  float fx, fy, cx, cy;
  float* out;              // (N, 4)
};

// |v| rounded once: sqrt((v0^2 + v1^2) + v2^2) in float64 (each square
// exact), then to float32
__device__ __forceinline__ float length_f64(const float v[3]) {
  const double a = v[0], b = v[1], c = v[2];
  return __double2float_rn(__dsqrt_rn(
      __dadd_rn(__dadd_rn(__dmul_rn(a, a), __dmul_rn(b, b)),
                __dmul_rn(c, c))));
}

__device__ __forceinline__ float4 fetch_plane(const float* __restrict__ pl,
                                              int h, int w, int x, int y) {
  if (x < 0 || y < 0 || x >= w || y >= h) return make_float4(0, 0, 0, 0);
  return __ldg(reinterpret_cast<const float4*>(pl) +
               static_cast<int64_t>(y) * w + x);
}

__global__ void __launch_bounds__(kFitThreads) fit_planes(FitParams p) {
  const int i = blockIdx.x * kFitThreads + threadIdx.x;
  if (i >= p.n) return;
  const float xf = static_cast<float>(p.wx[i]);
  const float yf = static_cast<float>(p.wy[i]);
  float ax[kSlots], ay[kSlots], pts[kSlots][3];
  uint32_t exists = 0;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int2 a = reinterpret_cast<const int2*>(p.anchors)[
        static_cast<int64_t>(i) * (kSlots + 1) + 1 + k];
    if (a.x >= 0 && a.y >= 0) exists |= 1u << k;
    ax[k] = static_cast<float>(a.x);
    ay[k] = static_cast<float>(a.y);
    const float4 pl =
        fetch_plane(p.planes, p.h, p.w, clamp0(a.x), clamp0(a.y));
    const float depth = plane_depth(p.fx, p.fy, p.cx, p.cy, ax[k], ay[k],
                                    pl.x, pl.y, pl.z, pl.w);
    backproject(p.fx, p.fy, p.cx, p.cy, ax[k], ay[k], depth, pts[k]);
  }
  const int count = __popc(exists);
  const bool enough = count >= 3;
  const int cmax = count < 1 ? 1 : count;

  float best_cost = INFINITY;
  float best[4] = {0.f, 0.f, 0.f, 0.f};
  bool has = false;
  const int* t = p.triplets + static_cast<int64_t>(i) * 3;
  for (int it = 0; it < p.iters; ++it, t += p.trip_stride) {
    const int a = nth_valid(exists, py_mod(t[0], cmax));
    const int b = nth_valid(exists, py_mod(t[1], cmax));
    const int c = nth_valid(exists, py_mod(t[2], cmax));
    const bool distinct = a != b && b != c && a != c;
    const bool tri = point_in_triangle(ax[a], ay[a], ax[b], ay[b], ax[c],
                                       ay[c], xf, yf);
    float plane[4];
    const bool degen = plane_from_triplet(pts[a], pts[b], pts[c], plane);
    // the other valid anchors' distances, summed in slot order
    float cost = 0.f;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const bool other = ((exists >> k) & 1u) && k != a && k != b && k != c;
      const float term = other ? plane_dist(pts[k], plane) : 0.f;
      cost = k == 0 ? term : add(cost, term);
    }
    if (distinct && tri && !degen && enough && cost < best_cost) {
#pragma unroll
      for (int k = 0; k < 4; ++k) best[k] = plane[k];
      best_cost = cost;
      has = true;
    }
  }

  // flip toward the camera (reference: APD.cu:2582-2594)
  const float4 own = fetch_plane(p.planes, p.h, p.w, p.wx[i], p.wy[i]);
  const float depth = plane_depth(p.fx, p.fy, p.cx, p.cy, xf, yf, own.x,
                                  own.y, own.z, own.w);
  float vd[3];
  backproject(p.fx, p.fy, p.cx, p.cy, xf, yf, depth, vd);
  const float len = length_f64(vd);
#pragma unroll
  for (int k = 0; k < 3; ++k) vd[k] = dvd(vd[k], len);
  const bool flip = dot3(best, vd) > 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  if (has) {
    o = flip ? make_float4(-best[0], -best[1], -best[2], -best[3])
             : make_float4(best[0], best[1], best[2], best[3]);
  }
  reinterpret_cast<float4*>(p.out)[i] = o;
}

// ---------------------------------------------------------------------------
// K8: anchor generation, a warp a weak pixel, a lane a direction
// ---------------------------------------------------------------------------

struct GenParams {
  const int2* ns;          // (H, W, 2) nearest-strong map
  const float* planes;     // (H, W, 4): the depth at channel 3
  int h, w;                // the maps' shape
  int img_h, img_w;        // the image's, which bounds the probes
  const int* wx;           // (N,)
  const int* wy;
  const int* shift_x;      // (N, D * Rn * J)
  const int* shift_y;
  const int* triplets;     // (iters, N, 3) rows ``trip_stride`` apart
  int64_t trip_stride;
  int iters;               // RANSAC iterations
  int margin;              // probes keep this far from the image's edges
  const float* dirs;       // (D, 2) unit directions
  const float* radii;      // (Rn,)
  int n, d, rn, j;
  float fx, fy, cx, cy;
  float cone_cos;          // the cone's cosine, rounded to float32
  float thr;               // the RANSAC threshold
  float depth_diff;        // depth_max - depth_min in float32
  int* anchors;            // (N, 9, 2)
  uint8_t* reliable;       // (N,) bool
  int* hit_count;          // (N,)
};

__global__ void __launch_bounds__(kGenThreads) gen_anchors(GenParams p) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kGenWarps + (threadIdx.x >> 5);
  if (i >= p.n) return;   // uniform over the warp
  const int wxi = p.wx[i], wyi = p.wy[i];
  const float xf = static_cast<float>(wxi);
  const float yf = static_cast<float>(wyi);
  const bool active = lane < p.d;

  // the probe walk: the first accepted probe of this lane's direction
  bool found = false;
  int hx = -1, hy = -1;
  float dirx = 0.f, diry = 0.f;
  if (active) {
    dirx = __ldg(p.dirs + 2 * lane);
    diry = __ldg(p.dirs + 2 * lane + 1);
    const int64_t row = static_cast<int64_t>(i) * p.d * p.rn * p.j +
                        static_cast<int64_t>(lane) * p.rn * p.j;
    const float wf = static_cast<float>(p.img_w);
    const float hf = static_cast<float>(p.img_h);
    const float dx20 = mul(dirx, 20.f), dy20 = mul(diry, 20.f);
    for (int r = 0; r < p.rn && !found; ++r) {
      const float rad = __ldg(p.radii + r);
      const float tx = add(xf, mul(dirx, rad));
      const float ty = add(yf, mul(diry, rad));
      // the radii rise and rounding is monotone: no later test point
      // returns to the image
      if (!(tx >= 0.f && ty >= 0.f && tx < wf && ty < hf)) break;
      for (int jj = 0; jj < p.j; ++jj) {
        const int64_t f = row + static_cast<int64_t>(r) * p.j + jj;
        const float pdx = add(dx20, static_cast<float>(__ldg(p.shift_x + f)));
        const float pdy = add(dy20, static_cast<float>(__ldg(p.shift_y + f)));
        const float pn = clamp_min_keep_nan(
            __fsqrt_rn(add(mul(pdx, pdx), mul(pdy, pdy))), 1e-20f);
        const int px = static_cast<int>(add(xf, mul(dvd(pdx, pn), rad)));
        const int py = static_cast<int>(add(yf, mul(dvd(pdy, pn), rad)));
        if (px < p.margin || py < p.margin || px >= p.img_w - p.margin ||
            py >= p.img_h - p.margin) {
          continue;
        }
        int2 s = make_int2(0, 0);   // fetch's fill past the map
        if (px < p.w && py < p.h) {
          s = p.ns[static_cast<int64_t>(py) * p.w + px];
        }
        if (s.x < 0 || s.y < 0) continue;
        // the angular cone against the origin direction
        const float vx = sub(static_cast<float>(s.x), xf);
        const float vy = sub(static_cast<float>(s.y), yf);
        const float vn = clamp_min_keep_nan(
            __fsqrt_rn(add(mul(vx, vx), mul(vy, vy))), 1e-20f);
        if (dvd(add(mul(vx, dirx), mul(vy, diry)), vn) > p.cone_cos) {
          found = true;
          hx = s.x;
          hy = s.y;
          break;
        }
      }
    }
  }
  const uint32_t hits = __ballot_sync(kFull, found);
  const int count = __popc(hits);

  // camera-frame points of the hits, and of the pixel, at the stored depth
  const float hxf = static_cast<float>(hx), hyf = static_cast<float>(hy);
  float pt[3], centre[3];
  backproject(p.fx, p.fy, p.cx, p.cy, hxf, hyf,
              fetch_f(p.planes, 4, 3, p.h, p.w, clamp0(hx), clamp0(hy)), pt);
  backproject(p.fx, p.fy, p.cx, p.cy, xf, yf,
              fetch_f(p.planes, 4, 3, p.h, p.w, wxi, wyi), centre);

  // RANSAC for a support plane through >= 6 hits whose triangle holds p
  int best_count = 3;
  float best_cdist = INFINITY;
  float best[4] = {0.f, 0.f, 0.f, 0.f};
  int abc[3] = {-1, -1, -1};
  bool has = false;
  const int cmax = count < 1 ? 1 : count;
  const int* t = p.triplets + static_cast<int64_t>(i) * 3;
  for (int it = 0; it < p.iters; ++it, t += p.trip_stride) {
    const int a = nth_valid(hits, py_mod(__ldg(t), cmax));
    const int b = nth_valid(hits, py_mod(__ldg(t + 1), cmax));
    const int c = nth_valid(hits, py_mod(__ldg(t + 2), cmax));
    const bool distinct = a != b && b != c && a != c;
    float A[3], B[3], C[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      A[k] = __shfl_sync(kFull, pt[k], a);
      B[k] = __shfl_sync(kFull, pt[k], b);
      C[k] = __shfl_sync(kFull, pt[k], c);
    }
    const bool tri = point_in_triangle(
        __shfl_sync(kFull, hxf, a), __shfl_sync(kFull, hyf, a),
        __shfl_sync(kFull, hxf, b), __shfl_sync(kFull, hyf, b),
        __shfl_sync(kFull, hxf, c), __shfl_sync(kFull, hyf, c), xf, yf);
    float plane[4];
    const bool degen = plane_from_triplet(A, B, C, plane);
    const bool inlier =
        found && dvd(plane_dist(pt, plane), p.depth_diff) < p.thr;
    const int n_in = __popc(__ballot_sync(kFull, inlier));
    const bool usable = distinct && tri && !degen && n_in >= 6;
    const float cdist = plane_dist(centre, plane);
    if (usable && (n_in > best_count ||
                   (n_in == best_count && cdist < best_cdist))) {
#pragma unroll
      for (int k = 0; k < 4; ++k) best[k] = plane[k];
      best_cdist = cdist;
      best_count = n_in;
      abc[0] = a;
      abc[1] = b;
      abc[2] = c;
      has = true;
    }
  }

  // rank the hits by plane distance (the triangle's members boosted by
  // -1), keep the 8 smallest, ties to the lower direction
  const float dist = plane_dist(pt, best);
  const bool is_inlier = found && dvd(dist, p.depth_diff) < p.thr;
  const bool is_abc = lane == abc[0] || lane == abc[1] || lane == abc[2];
  const float weight = is_inlier ? sub(dist, is_abc ? 1.f : 0.f) : INFINITY;
  int rank = 0;
  for (int k = 0; k < p.d; ++k) {
    const float other = __shfl_sync(kFull, weight, k);
    rank += other < weight || (other == weight && k < lane);
  }
  const bool reliable = count > 3 && has;
  int2* out = reinterpret_cast<int2*>(p.anchors) +
              static_cast<int64_t>(i) * (kSlots + 1);
  if (active && rank < kSlots) {
    out[1 + rank] = (reliable && isfinite(weight)) ? make_int2(hx, hy)
                                                   : make_int2(-1, -1);
  }
  if (lane == 0) {
    out[0] = make_int2(wxi, wyi);
    p.reliable[i] = reliable ? 1 : 0;
    p.hit_count[i] = count;
  }
}

}  // namespace

extern "C" {

int apde_anchor_max_directions() { return kMaxDirections; }

int apde_anchor_slots() { return kSlots; }

// A kernel's registers, local memory (spills) and resident blocks an SM
// (which: 0 K10, 1 K9, 2 K8); returns the first error.
int apde_anchor_kernel_info(int which, int* regs, int* local_bytes,
                            int* blocks_per_sm) {
  const void* kernel = which == 0   ? (const void*)jfa_step
                       : which == 1 ? (const void*)fit_planes
                                    : (const void*)gen_anchors;
  const int threads =
      which == 0 ? kJfaThreads : (which == 1 ? kFitThreads : kGenThreads);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                        threads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}

// K10: the n_steps x 8 sub-passes, ping-pong between ``scratch`` and
// ``out`` so that the last lands in ``out`` (both (H, W, 2) int32).
// ``steps`` is a host array; ``strong`` the STRONG code of ``weak``.
int apde_jfa(const void* weak, const void* conf, const void* valid,
             int strong, int h, int w, const int* steps, int n_steps,
             void* out, void* scratch, void* stream) {
  if (h < 0 || w < 0 || n_steps < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t pixels = static_cast<int64_t>(h) * w;
  if (pixels == 0) return static_cast<int>(cudaGetLastError());
  const unsigned int grid =
      static_cast<unsigned int>((pixels + kJfaThreads - 1) / kJfaThreads);
  const int total = 8 * n_steps;
  int2* bufs[2] = {static_cast<int2*>(out), static_cast<int2*>(scratch)};
  const int2* in = nullptr;
  int k = 0;
  for (int s = 0; s < n_steps; ++s) {
    for (int dy = -1; dy <= 1; ++dy) {
      for (int dx = -1; dx <= 1; ++dx) {
        if (dx == 0 && dy == 0) continue;
        // the sub-passes left after this one decide its buffer: the last
        // (0 left) writes ``out``
        int2* dst = bufs[(total - 1 - k) & 1];
        jfa_step<<<grid, kJfaThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            in, dst, static_cast<const int*>(weak),
            static_cast<const float*>(conf),
            static_cast<const uint8_t*>(valid), strong, h, w, dx * steps[s],
            dy * steps[s], k == total - 1);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
        in = dst;
        ++k;
      }
    }
  }
  return 0;
}

// K9: the fit planes of N weak pixels over ``iters`` RANSAC iterations.
int apde_fit_planes(const void* planes, int h, int w, const void* wx,
                    const void* wy, const void* anchors, const void* triplets,
                    int64_t trip_stride, int iters, int n, float fx, float fy,
                    float cx, float cy, void* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  FitParams p;
  p.planes = static_cast<const float*>(planes);
  p.h = h;
  p.w = w;
  p.wx = static_cast<const int*>(wx);
  p.wy = static_cast<const int*>(wy);
  p.anchors = static_cast<const int*>(anchors);
  p.triplets = static_cast<const int*>(triplets);
  p.trip_stride = trip_stride;
  p.iters = iters;
  p.n = n;
  p.fx = fx;
  p.fy = fy;
  p.cx = cx;
  p.cy = cy;
  p.out = static_cast<float*>(out);
  const unsigned int grid =
      static_cast<unsigned int>((n + kFitThreads - 1) / kFitThreads);
  fit_planes<<<grid, kFitThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// K8: the anchors of N weak pixels over D directions (D <= 32), probes
// ``margin`` from the edges, ``iters`` RANSAC iterations.
int apde_gen_anchors(const void* ns, const void* planes, int h, int w,
                     int img_h, int img_w, const void* wx, const void* wy,
                     const void* shift_x, const void* shift_y,
                     const void* triplets, int64_t trip_stride, int iters,
                     int margin, const void* dirs, const void* radii,
                     int n, int d, int rn, int j, float fx, float fy,
                     float cx, float cy, float cone_cos, float thr,
                     float depth_diff, void* anchors, void* reliable,
                     void* hit_count, void* stream) {
  if (d < kSlots || d > kMaxDirections || rn < 1 || j < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  GenParams p;
  p.ns = static_cast<const int2*>(ns);
  p.planes = static_cast<const float*>(planes);
  p.h = h;
  p.w = w;
  p.img_h = img_h;
  p.img_w = img_w;
  p.wx = static_cast<const int*>(wx);
  p.wy = static_cast<const int*>(wy);
  p.shift_x = static_cast<const int*>(shift_x);
  p.shift_y = static_cast<const int*>(shift_y);
  p.triplets = static_cast<const int*>(triplets);
  p.trip_stride = trip_stride;
  p.iters = iters;
  p.margin = margin;
  p.dirs = static_cast<const float*>(dirs);
  p.radii = static_cast<const float*>(radii);
  p.n = n;
  p.d = d;
  p.rn = rn;
  p.j = j;
  p.fx = fx;
  p.fy = fy;
  p.cx = cx;
  p.cy = cy;
  p.cone_cos = cone_cos;
  p.thr = thr;
  p.depth_diff = depth_diff;
  p.anchors = static_cast<int*>(anchors);
  p.reliable = static_cast<uint8_t*>(reliable);
  p.hit_count = static_cast<int*>(hit_count);
  const unsigned int grid =
      static_cast<unsigned int>((n + kGenWarps - 1) / kGenWarps);
  gen_anchors<<<grid, kGenThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
