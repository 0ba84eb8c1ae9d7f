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
// host. Here K10 is one cooperative launch a call, K8 one a chunk of weak
// pixels and K9 one a call.
//
// Every float operation is rounded on its own (ncc_common.cuh's mul / add
// / sub / dvd, __fsqrt_rn; no FMA contraction), in the order of the plain
// versions in ops/anchors.py, and every comparison is the plain version's,
// so each kernel equals its plain version bit for bit.
//
// K10 (`jfa_phases`): inside one step the plain version relaxes the 8
// neighbours in turn, each against the map the previous neighbours have
// already rewritten everywhere, so a pixel cannot replay its chain alone.
// The design keeps every sub-pass's read of the previous map in one launch
// a call, where the host issued 96 launches at 600x800 before:
//  - the live sub-passes only (`jfa_schedule`, ops/anchors.py): one in
//    which no neighbour lies in the map returns its input;
//  - folding: at fold f, pixel (x, y) is residue (x mod f, y mod f) and
//    folded point (x div f, y div f); a step that is a multiple of f
//    relaxes each residue's sub-grid against itself, apart from every
//    other residue. The phases (`jfa_phases`, ops/cuda/anchors.py): runs
//    of long steps folded by their smallest while the folded map fits one
//    tile whole (512..32 at 600x800: 40 sub-passes in one phase), each
//    other step above 1 alone, folded by itself, then the two steps of 1
//    (the short-range tail) together at fold 1;
//  - a phase runs tile by tile in shared memory: a block loads its tile's
//    footprint, the tile plus a halo of the phase's whole reach on each
//    side (3 x the sum of its folded steps), or the residues' whole folded
//    extents where they fit (no halo: a neighbour past them is outside the
//    map), then runs the phase's sub-passes in order, each reading one
//    buffer and writing the other, and writes its tile. A map entry is the
//    strong pixel's coordinates as int16 halves and its confidence, so a
//    relaxation reads nothing outside shared memory; cells outside the map
//    hold (-1, -1) and a NaN confidence, which takes no candidate, so
//    every cell relaxes every sub-pass and the halo's, outside the region
//    still valid, compute what no valid cell reads;
//  - the phases run as one cooperative launch, a grid sync between phases
//    (ping-pong between two maps of entries; the last phase writes the (H,
//    W, 2) map with the strong pixels rewritten).
// A candidate is taken where it is a strong pixel (x >= 0) with confidence
// >= the pixel's and nearer, or as near with higher confidence than the
// current best. Integer work and exact float compares. Bound: operations
// (about 20 a pixel a live sub-pass); the halos, the folded extents'
// rounding and the idle threads of a footprint narrower than the block
// add work, a grid sync a phase.
//
// K9 (`fit_planes`): a warp a weak pixel, a lane a RANSAC iteration (lanes
// 0..31, then the rest): lanes 0-7 compute the 8 anchors' camera-frame
// points and each rank's anchor slot (_nth_valid) once and share them
// through shared memory; each lane takes its iteration's three ranks from
// the draws (the remainder by a multiplier set up once a pixel), their
// slots, the point-in-triangle test, the plane, the cost as the distances
// of the other valid anchors summed in slot order. The plain version takes
// the strictly lower cost from +inf in iteration order, so the fit is the
// least (cost, iteration) over the usable iterations whose cost is below
// +inf (NaN and +inf never taken, the first of equal costs kept): a
// butterfly over the lanes, then against the earlier rounds' best. A
// block's pixels are consecutive, so an iteration's draws for them are one
// contiguous run: the block stages up to 64 iterations' runs in shared
// memory. Then the flip toward the camera against the view direction,
// whose length is taken in float64 and rounded once. Bound: bytes (the
// draws, 12 B an iteration a pixel, dominate).
//
// K8 (`gen_anchors`): a warp a weak pixel, its D = 8 rotate_time <= 32
// directions each given L = 32 / D lanes (a lane a direction would leave
// half the warp idle at D = 16, pay a chain of dependent loads a probe, and
// run the RANSAC's 50 dependent iterations a pixel one after another).
//  - The walk: lane g of a direction's group takes radii g, g + L, ...; a
//    step tests L radii at once, each radius's 4 jitter draws loaded as one
//    vector a step ahead and its 4 probes' nearest-strong texels loaded
//    together, and the group keeps the lowest radius that accepted a probe
//    (the first in jitter order) or left the image: the plain version's
//    first accepted probe in its flat order (radius-major, then jitter),
//    with its early end at a radius whose un-jittered test point has left
//    the image (every later one lies farther out). The draws must be 4 a
//    radius (JITTER_SAMPLES) in 16-byte aligned rows; others are refused.
//  - The hits: lane d holds direction d's; hit counts are ballots.
//  - The RANSAC, only where 6 hits or more make a plane usable: a lane an
//    iteration, 32 at a time, the hits compacted (lane k holds the k-th), so
//    a draw's rank picks its hit by a shuffle (_nth_valid) and each lane
//    counts its plane's inliers over the hits; then every lane takes the
//    usable iterations in iteration order: the most inliers (at least 6,
//    more than the best's, starting at 3), ties to the nearer centre, the
//    first iteration kept on a tie.
//  - The ranking: the 8 smallest of `dist - is_abc` over the inliers, ties
//    to the lower direction (a stable argsort's order), each lane's rank
//    counted against the others by shuffles.
// Bound: bytes (the RANSAC draws, the probes' jitter draws and the
// nearest-strong texels they read, each once) against operations (the
// probes and the 50 iterations over the hits).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <math.h>
#include <stdint.h>

#include "geom_common.cuh"
#include "ncc_common.cuh"
#include "ransac_common.cuh"

namespace {

using namespace apde;
namespace cg = cooperative_groups;

constexpr int kSlots = 8;           // ANCHOR_NUM - 1 anchors besides self
constexpr int kMaxDirections = 32;  // a warp's lanes
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGenWarps = 4;
constexpr int kGenThreads = kGenWarps * 32;
constexpr int kJitter = 4;          // JITTER_SAMPLES: a radius's draws

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
// K10: the jump flooding, phases of sub-passes run tile by tile
// ---------------------------------------------------------------------------

constexpr int kJfaThreads = 512;
constexpr int kJfaX = 128;       // a tile's footprint columns at most
constexpr int kJfaMaxSteps = 17;              // powers of two to 2^15, then 1
constexpr int kJfaMaxSub = 8 * kJfaMaxSteps;  // sub-passes
constexpr int kJfaMaxSide = 32767;            // int16 coordinates
constexpr int kJfaRows = 32;       // a tile's footprint rows at most

// A phase's tiles along one axis, in folded units (a unit is ``fold``
// pixels): 2^c_log2 consecutive residues a tile, ``t`` output points of
// each, ``lo`` / ``hi`` halo points before / after them (0 where the tile
// takes a residue's whole folded extent).
struct JfaAxis {
  int c_log2, lo, hi, t;
  int tiles;    // tiles over the folded extent
  int groups;   // residue groups: ceil(fold / 2^c_log2)
  int span;     // lo + t + hi
};

struct JfaPhase {
  int fold;          // the common step of its sub-passes
  int first, count;  // its sub-passes in JfaParams::ox / oy
  JfaAxis x, y;
  int items;         // tiles: x.groups * x.tiles * y.groups * y.tiles
};

struct JfaParams {
  const int* weak;
  const float* conf;
  const uint8_t* valid;
  int strong, h, w;
  int2* buf[2];      // (H * W) entries: phase k writes buf[k & 1]
  int2* out;         // (H, W, 2): the last phase's
  int n_phases;
  JfaPhase ph[kJfaMaxSteps];
  signed char ox[kJfaMaxSub], oy[kJfaMaxSub];   // offsets, folded units
};

// A map entry: the strong pixel (x, y) as int16 halves of .x ((-1, -1) is
// -1) and its confidence's bits in .y, so a relaxation reads no
// confidence from the global map
__device__ __forceinline__ int jfa_pack(int x, int y) {
  return static_cast<int>((static_cast<unsigned>(x) & 0xffffu) |
                          (static_cast<unsigned>(y) << 16));
}
__device__ __forceinline__ int jfa_x(int v) {
  return static_cast<int>(static_cast<unsigned>(v) << 16) >> 16;
}
__device__ __forceinline__ int jfa_y(int v) { return v >> 16; }

// the initial map at pixel q = (x, y): itself where it is ``strong`` (the
// STRONG code) and valid
__device__ __forceinline__ int2 jfa_initial(const JfaParams& p, int64_t q,
                                            int x, int y) {
  return (__ldg(p.weak + q) == p.strong && __ldg(p.valid + q) != 0)
             ? make_int2(jfa_pack(x, y), __float_as_int(__ldg(p.conf + q)))
             : make_int2(-1, 0);
}

// one relaxation of pixel (x, y) (confidence ``own``) holding ``b`` against
// the neighbour's ``c``: `jfa_step`'s rule
__device__ __forceinline__ int2 jfa_relax(int2 b, int2 c, int x, int y,
                                          float own) {
  const int cx = jfa_x(c.x);
  if (cx < 0) return b;
  const float c_conf = __int_as_float(c.y);
  if (!(c_conf >= own)) return b;
  const int bx = jfa_x(b.x);
  if (bx < 0) return c;   // no best yet: any candidate is nearer
  const int cy = jfa_y(c.x), by = jfa_y(b.x);
  const int d_cand = (cx - x) * (cx - x) + (cy - y) * (cy - y);
  const int d_best = (bx - x) * (bx - x) + (by - y) * (by - y);
  if (d_cand < d_best) return c;
  if (d_cand == d_best && c_conf > __int_as_float(b.y)) return c;
  return b;
}

// A block's threads over a tile's footprint, per phase: thread t the
// column t mod fx (residue column mod 2^x.c_log2, folded point column div
// 2^x.c_log2) and the rows t div fx, + kJfaThreads div fx, ... (rows
// likewise over the y axis's residues and points). Shared memory: two
// buffers of entries, the one a sub-pass reads its neighbours from and
// the one it writes, and the cells' own confidences. A cell outside the
// map holds (-1, -1) and a NaN confidence, which accepts no candidate, so
// every cell relaxes every sub-pass: those outside the shrinking valid
// region compute what no valid cell reads.
__global__ void __launch_bounds__(kJfaThreads, 2)
    jfa_phases(const __grid_constant__ JfaParams p) {
  extern __shared__ int2 jfa_sm[];
  for (int k = 0; k < p.n_phases; ++k) {
    if (k > 0) cg::this_grid().sync();
    const JfaPhase& ph = p.ph[k];
    const int2* in = k == 0 ? nullptr : p.buf[(k - 1) & 1];
    int2* dst = p.buf[k & 1];
    const bool last = k == p.n_phases - 1;
    const int fold = ph.fold;
    const int cxl = ph.x.c_log2, cyl = ph.y.c_log2;
    const int cym = (1 << cyl) - 1;
    const int fx = ph.x.span << cxl;       // footprint width, <= kJfaX
    const int rows = ph.y.span << cyl;     // footprint rows, <= kJfaRows
    const int row_step = kJfaThreads / fx;
    const int tx = threadIdx.x % fx;
    const int ty = threadIdx.x / fx;       // rows ty, ty + row_step, ...
    const bool col = ty < row_step;
    const int rcx = tx & ((1 << cxl) - 1);
    const int u = tx >> cxl;
    int2* const A0 = jfa_sm;
    int2* const B0 = jfa_sm + fx * rows;
    float* const own = reinterpret_cast<float*>(jfa_sm + 2 * fx * rows);
    for (int item = blockIdx.x; item < ph.items; item += gridDim.x) {
      int r = item;
      const int tile_x = r % ph.x.tiles;
      r /= ph.x.tiles;
      const int gx = r % ph.x.groups;
      r /= ph.x.groups;
      const int tile_y = r % ph.y.tiles;
      const int gy = r / ph.y.tiles;
      const int rx = (gx << cxl) + rcx;
      const int fi = tile_x * ph.x.t - ph.x.lo + u;
      const int x = rx + fi * fold;
      const bool x_in = col && rx < fold && fi >= 0 && x < p.w;
      const int ry0 = gy << cyl;
      const int fj0 = tile_y * ph.y.t - ph.y.lo;
      int2* A = A0;
      int2* B = B0;
      if (col) {
        for (int row = ty; row < rows; row += row_step) {
          const int ry = ry0 + (row & cym);
          const int fj = fj0 + (row >> cyl);
          const int y = ry + fj * fold;
          int2 v = make_int2(-1, 0);
          float o = __int_as_float(0x7fc00000);   // NaN: outside the map
          if (x_in && ry < fold && fj >= 0 && y < p.h) {
            const int64_t q = static_cast<int64_t>(y) * p.w + x;
            v = in ? __ldcg(in + q) : jfa_initial(p, q, x, y);
            o = __ldg(p.conf + q);
          }
          A[row * fx + tx] = v;
          own[row * fx + tx] = o;
        }
      }
      __syncthreads();
      for (int s = ph.first; s < ph.first + ph.count; ++s) {
        const int dx = p.ox[s], dy = p.oy[s];
        if (col) {
          const bool n_col = u + dx >= 0 && u + dx < ph.x.span;
          const int noff = dy * (1 << cyl) * fx + dx * (1 << cxl);
          for (int row = ty; row < rows; row += row_step) {
            const int v = row >> cyl;
            const int y = ry0 + (row & cym) + (fj0 + v) * fold;
            const int idx = row * fx + tx;
            const int2 c = (n_col && v + dy >= 0 && v + dy < ph.y.span)
                               ? A[idx + noff]
                               : make_int2(-1, 0);
            B[idx] = jfa_relax(A[idx], c, x, y, own[idx]);
          }
        }
        __syncthreads();
        int2* t = A;
        A = B;
        B = t;
      }
      // the tile's output points
      if (x_in && u >= ph.x.lo && u < ph.x.lo + ph.x.t) {
        for (int row = ty; row < rows; row += row_step) {
          const int v = row >> cyl;
          const int ry = ry0 + (row & cym);
          const int y = ry + (fj0 + v) * fold;
          if (v < ph.y.lo || v >= ph.y.lo + ph.y.t || ry >= fold ||
              fj0 + v < 0 || y >= p.h) {
            continue;
          }
          const int64_t q = static_cast<int64_t>(y) * p.w + x;
          const int2 val = A[row * fx + tx];
          if (last) {
            const bool self =
                __ldg(p.weak + q) == p.strong && __ldg(p.valid + q) != 0;
            p.out[q] = self ? make_int2(x, y)
                            : make_int2(jfa_x(val.x), jfa_y(val.x));
          } else {
            __stcg(dst + q, val);
          }
        }
      }
      __syncthreads();   // before the next tile's load
    }
  }
}

// shared memory of a phase's tile: two buffers of entries and the own
// confidences
static size_t jfa_smem(const JfaPhase& ph) {
  const size_t cells = static_cast<size_t>(ph.x.span << ph.x.c_log2) *
                       (ph.y.span << ph.y.c_log2);
  return cells * (2 * sizeof(int2) + sizeof(float));
}

// A phase's tiles along one axis of ``extent`` pixels: a residue's whole
// folded extent where it fits ``budget`` cells (as many residues as fit,
// a power of two), else one residue a tile with the phase's halo.
static bool jfa_axis(int fold, int extent, int lo, int hi, int budget,
                     JfaAxis* a) {
  const int n = (extent + fold - 1) / fold;
  if (n <= budget) {
    int c = 0;
    while ((2 << c) <= fold && (2 << c) * n <= budget) ++c;
    a->c_log2 = c;
    a->lo = a->hi = 0;
    a->t = n;
    a->tiles = 1;
  } else {
    if (budget <= lo + hi) return false;
    a->c_log2 = 0;
    a->lo = lo;
    a->hi = hi;
    a->t = budget - lo - hi;
    a->tiles = (n + a->t - 1) / a->t;
  }
  a->groups = (fold + (1 << a->c_log2) - 1) >> a->c_log2;
  a->span = a->lo + a->t + a->hi;
  return true;
}

// ---------------------------------------------------------------------------
// K9: the fit-plane RANSAC, a warp a weak pixel, a lane an iteration
// ---------------------------------------------------------------------------

constexpr int kFitWarps = 16;                 // weak pixels a block
constexpr int kFitThreads = kFitWarps * 32;
constexpr int kFitRow = 3 * kFitWarps + 1;    // a staged iteration, padded
constexpr int kFitStaged = 64;                // iterations staged at once

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

__global__ void __launch_bounds__(kFitThreads, 3) fit_planes(FitParams p) {
  __shared__ int draws[kFitStaged * kFitRow];   // the block's draws
  __shared__ float pts[kFitWarps][kSlots][3];
  __shared__ float axy[kFitWarps][2][kSlots];
  __shared__ int slot_of[kFitWarps][kSlots];   // a rank's anchor slot
  const int lane = threadIdx.x & 31;
  const int wi = threadIdx.x >> 5;
  const int i0 = blockIdx.x * kFitWarps;
  const int np = min(kFitWarps, p.n - i0);   // the block's pixels
  const int i = i0 + wi;
  const bool pixel = wi < np;                // uniform over the warp
  float xf = 0.f, yf = 0.f;
  float4 own = make_float4(0.f, 0.f, 0.f, 0.f);
  uint32_t exists = 0;
  if (pixel) {
    const int wxi = p.wx[i], wyi = p.wy[i];
    xf = static_cast<float>(wxi);
    yf = static_cast<float>(wyi);
    if (lane == 0) own = fetch_plane(p.planes, p.h, p.w, wxi, wyi);
    // the anchors' camera-frame points, lane k < 8 slot k's
    bool have = false;
    if (lane < kSlots) {
      const int2 a = reinterpret_cast<const int2*>(p.anchors)[
          static_cast<int64_t>(i) * (kSlots + 1) + 1 + lane];
      have = a.x >= 0 && a.y >= 0;
      const float ax = static_cast<float>(a.x);
      const float ay = static_cast<float>(a.y);
      const float4 pl =
          fetch_plane(p.planes, p.h, p.w, clamp0(a.x), clamp0(a.y));
      const float depth = plane_depth(p.fx, p.fy, p.cx, p.cy, ax, ay, pl.x,
                                      pl.y, pl.z, pl.w);
      backproject(p.fx, p.fy, p.cx, p.cy, ax, ay, depth, pts[wi][lane]);
      axy[wi][0][lane] = ax;
      axy[wi][1][lane] = ay;
    }
    exists = __ballot_sync(kFull, have);
    // _nth_valid of every rank a draw can give (below max(count, 1))
    if (lane < kSlots) slot_of[wi][lane] = nth_valid<kSlots>(exists, lane);
    __syncwarp();
  }
  const int count = __popc(exists);
  const bool enough = count >= 3;
  const int cmax = count < 1 ? 1 : count;
  const Remainder rem(cmax);
  const float* ax = axy[wi][0];
  const float* ay = axy[wi][1];
  const int* slot = slot_of[wi];

  float best_cost = INFINITY;
  float best[4] = {0.f, 0.f, 0.f, 0.f};
  bool has = false;
  for (int s0 = 0; s0 < p.iters; s0 += kFitStaged) {
    // up to kFitStaged iterations' draws of the block's pixels: an
    // iteration's are one contiguous run of np x 3
    const int sn = min(kFitStaged, p.iters - s0);
    const int run = 3 * np;
    __syncthreads();
    for (int e = threadIdx.x; e < sn * run; e += kFitThreads) {
      const int it = e / run;
      const int j = e - it * run;
      draws[it * kFitRow + j] = __ldg(
          p.triplets + static_cast<int64_t>(s0 + it) * p.trip_stride +
          static_cast<int64_t>(i0) * 3 + j);
    }
    __syncthreads();
    if (!pixel) continue;
    for (int r0 = 0; r0 < sn; r0 += 32) {
      const bool live = r0 + lane < sn;
      int t0 = 0, t1 = 0, t2 = 0;
      if (live) {
        const int* t = draws + (r0 + lane) * kFitRow + 3 * wi;
        t0 = t[0];
        t1 = t[1];
        t2 = t[2];
      }
      const int a = slot[rem(t0)];
      const int b = slot[rem(t1)];
      const int c = slot[rem(t2)];
      float plane[4];
      const bool ok = pick_plane(a, b, c, ax[a], ay[a], ax[b], ay[b], ax[c],
                                 ay[c], xf, yf, pts[wi][a], pts[wi][b],
                                 pts[wi][c], plane);
      // the other valid anchors' distances, summed in slot order
      float cost = 0.f;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const bool other =
            ((exists >> k) & 1u) && k != a && k != b && k != c;
        const float term = other ? plane_dist(pts[wi][k], plane) : 0.f;
        cost = k == 0 ? term : add(cost, term);
      }
      // the least (cost, iteration) over the usable iterations below +inf
      float key = (live && ok && enough && cost < INFINITY) ? cost : INFINITY;
      int src = lane;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float k2 = __shfl_xor_sync(kFull, key, off);
        const int s2 = __shfl_xor_sync(kFull, src, off);
        if (k2 < key || (k2 == key && s2 < src)) {
          key = k2;
          src = s2;
        }
      }
      float pl[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) pl[k] = __shfl_sync(kFull, plane[k], src);
      if (key < best_cost) {   // an earlier round keeps an equal cost
#pragma unroll
        for (int k = 0; k < 4; ++k) best[k] = pl[k];
        best_cost = key;
        has = true;
      }
    }
  }
  if (!pixel || lane != 0) return;

  // flip toward the camera (reference: APD.cu:2582-2594)
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
  int n, d, rn;
  float fx, fy, cx, cy;
  float cone_cos;          // the cone's cosine, rounded to float32
  float thr;               // the RANSAC threshold
  float depth_diff;        // depth_max - depth_min in float32
  int* anchors;            // (N, 9, 2)
  uint8_t* reliable;       // (N,) bool
  int* hit_count;          // (N,)
};

// One probe of the walk (`probe_table`'s arithmetic): the offset of jitter
// draw (sx, sy) from the direction's 20-pixel step, its length clamped at
// 1e-20, the probe at ``rad`` along it truncated toward zero; whether it
// keeps ``margin`` from the image's edges.
__device__ __forceinline__ bool probe_at(const GenParams& p, float xf,
                                         float yf, float dx20, float dy20,
                                         float rad, int sx, int sy, int* px,
                                         int* py) {
  const float pdx = add(dx20, static_cast<float>(sx));
  const float pdy = add(dy20, static_cast<float>(sy));
  const float pn = clamp_min_keep_nan(
      __fsqrt_rn(add(mul(pdx, pdx), mul(pdy, pdy))), 1e-20f);
  *px = static_cast<int>(add(xf, mul(dvd(pdx, pn), rad)));
  *py = static_cast<int>(add(yf, mul(dvd(pdy, pn), rad)));
  return !(*px < p.margin || *py < p.margin || *px >= p.img_w - p.margin ||
           *py >= p.img_h - p.margin);
}

// the nearest-strong texel a probe snaps to: fetch's (0, 0) past the map
__device__ __forceinline__ int2 snap(const GenParams& p, int px, int py) {
  return (px < p.w && py < p.h)
             ? p.ns[static_cast<int64_t>(py) * p.w + px]
             : make_int2(0, 0);
}

// whether the snapped strong pixel s lies in the direction's angular cone
__device__ __forceinline__ bool in_cone(const GenParams& p, int2 s, float xf,
                                        float yf, float dirx, float diry) {
  if (s.x < 0 || s.y < 0) return false;
  const float vx = sub(static_cast<float>(s.x), xf);
  const float vy = sub(static_cast<float>(s.y), yf);
  const float vn = clamp_min_keep_nan(
      __fsqrt_rn(add(mul(vx, vx), mul(vy, vy))), 1e-20f);
  return dvd(add(mul(vx, dirx), mul(vy, diry)), vn) > p.cone_cos;
}

// kPart, for timing only (``part`` of `apde_gen_anchors`; the main path
// runs 0): 1 stops after the probe walk, 2 after the RANSAC, each writing
// what it computed so that none of it is left out.
template <int kPart>
__global__ void __launch_bounds__(kGenThreads) gen_anchors(GenParams p) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kGenWarps + (threadIdx.x >> 5);
  if (i >= p.n) return;   // uniform over the warp
  const int wxi = p.wx[i], wyi = p.wy[i];
  const float xf = static_cast<float>(wxi);
  const float yf = static_cast<float>(wyi);
  const int D = p.d;

  // ---- the probe walk: L = 32 / D lanes a direction, lane ``in_group``
  // of a direction's group taking radii in_group, in_group + L, ...
  const int L = kMaxDirections / D;
  const int dir = lane / L;
  const int in_group = lane - dir * L;
  const unsigned group = ((L == 32 ? kFull : (1u << L) - 1u)) << (dir * L);
  bool done = dir >= D;   // lanes past the directions walk nothing
  bool found = false;
  int hx = -1, hy = -1;
  float dirx = 0.f, diry = 0.f;
  int64_t row = 0;
  if (!done) {
    dirx = __ldg(p.dirs + 2 * dir);
    diry = __ldg(p.dirs + 2 * dir + 1);
    row = (static_cast<int64_t>(i) * D + dir) * p.rn * kJitter;
  }
  const float wf = static_cast<float>(p.img_w);
  const float hf = static_cast<float>(p.img_h);
  const float dx20 = mul(dirx, 20.f), dy20 = mul(diry, 20.f);
  int4 nx4 = make_int4(0, 0, 0, 0), ny4 = nx4;
  if (!done && in_group < p.rn) {
    nx4 = __ldg(reinterpret_cast<const int4*>(p.shift_x + row) + in_group);
    ny4 = __ldg(reinterpret_cast<const int4*>(p.shift_y + row) + in_group);
  }
  for (int r0 = 0; !__all_sync(kFull, done); r0 += L) {
    const int r = r0 + in_group;
    bool got = false, out = false;
    int2 s_got = make_int2(-1, -1);
    int4 cx4 = nx4, cy4 = ny4;
    if (!done && r + L < p.rn) {   // the next step's draws
      nx4 = __ldg(reinterpret_cast<const int4*>(p.shift_x + row) + r + L);
      ny4 = __ldg(reinterpret_cast<const int4*>(p.shift_y + row) + r + L);
    }
    if (!done) {
      // a radius past the schedule, or whose un-jittered test point has
      // left the image, ends the walk: the radii rise and rounding is
      // monotone, so no later test point returns to the image
      const float rad = r < p.rn ? __ldg(p.radii + r) : 0.f;
      const float tx = add(xf, mul(dirx, rad));
      const float ty = add(yf, mul(diry, rad));
      out = r >= p.rn || !(tx >= 0.f && ty >= 0.f && tx < wf && ty < hf);
      if (!out) {
        // the radius's 4 probes, their texels loaded together, then the
        // first accepted in jitter order
        const int sxs[4] = {cx4.x, cx4.y, cx4.z, cx4.w};
        const int sys[4] = {cy4.x, cy4.y, cy4.z, cy4.w};
        int2 s[4];
        bool keep[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          int px, py;
          keep[jj] = probe_at(p, xf, yf, dx20, dy20, rad, sxs[jj], sys[jj],
                              &px, &py);
          s[jj] = keep[jj] ? snap(p, px, py) : make_int2(-1, -1);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if (!got && keep[jj] && in_cone(p, s[jj], xf, yf, dirx, diry)) {
            got = true;
            s_got = s[jj];
          }
        }
      }
    }
    // the group's lowest radius that accepted a probe or ended the walk
    // decides, as the walk one radius at a time would
    const unsigned g_got = __ballot_sync(kFull, got) & group;
    const unsigned g_end = (__ballot_sync(kFull, out) & group) | g_got;
    const int first = g_end ? __ffs(g_end) - 1 : lane;
    const int sx_w = __shfl_sync(kFull, s_got.x, first);
    const int sy_w = __shfl_sync(kFull, s_got.y, first);
    if (!done && ((g_got >> first) & 1u)) {
      found = true;
      hx = sx_w;
      hy = sy_w;
    }
    done = done || g_end != 0u;
  }

  // ---- the hits: lane d < D holds direction d's --------------------------
  {
    const int src = lane < D ? lane * L : lane;
    found = __shfl_sync(kFull, found, src) && lane < D;
    hx = __shfl_sync(kFull, hx, src);
    hy = __shfl_sync(kFull, hy, src);
  }
  const uint32_t hits = __ballot_sync(kFull, found);
  const int count = __popc(hits);
  if constexpr (kPart == 1) {
    if (lane < D) {
      reinterpret_cast<int2*>(p.anchors)[static_cast<int64_t>(i) *
                                         (kSlots + 1) + lane % 9] =
          make_int2(hx, hy);
    }
    if (lane == 0) p.hit_count[i] = count;
    return;
  }

  // camera-frame points of the hits, and of the pixel, at the stored depth
  const float hxf = static_cast<float>(hx), hyf = static_cast<float>(hy);
  float pt[3], centre[3];
  backproject(p.fx, p.fy, p.cx, p.cy, hxf, hyf,
              fetch_f(p.planes, 4, 3, p.h, p.w, clamp0(hx), clamp0(hy)), pt);
  backproject(p.fx, p.fy, p.cx, p.cy, xf, yf,
              fetch_f(p.planes, 4, 3, p.h, p.w, wxi, wyi), centre);

  // ---- RANSAC for a support plane through >= 6 hits whose triangle holds
  // the pixel: a lane an iteration, 32 at a time, each counting its
  // plane's inliers over the hits; then every lane takes the usable
  // iterations' results in iteration order. The hits are compacted (lane k
  // < count holds the k-th, direction ``hit_dir``), so a draw's rank picks
  // its hit as _nth_valid does. Fewer than 6 hits leave no iteration
  // usable: skipped.
  int best_count = 3;
  float best_cdist = INFINITY;
  float best[4] = {0.f, 0.f, 0.f, 0.f};
  int abc[3] = {-1, -1, -1};
  bool has = false;
  if (count >= 6) {
    int hit_dir = 0;
    if (lane < count) {
      uint32_t m = hits;
      for (int k = 0; k < lane; ++k) m &= m - 1u;
      hit_dir = __ffs(m) - 1;
    }
    float hp[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) hp[k] = __shfl_sync(kFull, pt[k], hit_dir);
    const float hpx = __shfl_sync(kFull, hxf, hit_dir);
    const float hpy = __shfl_sync(kFull, hyf, hit_dir);
    const int* t = p.triplets + static_cast<int64_t>(i) * 3;
    for (int it0 = 0; it0 < p.iters; it0 += 32) {
      const int it = it0 + lane;
      const bool live = it < p.iters;
      int t0 = 0, t1 = 0, t2 = 0;
      if (live) {
        const int* tc = t + it * p.trip_stride;
        t0 = __ldg(tc);
        t1 = __ldg(tc + 1);
        t2 = __ldg(tc + 2);
      }
      const int a = py_mod(t0, count);
      const int b = py_mod(t1, count);
      const int c = py_mod(t2, count);
      float A[3], B[3], Cp[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        A[k] = __shfl_sync(kFull, hp[k], a);
        B[k] = __shfl_sync(kFull, hp[k], b);
        Cp[k] = __shfl_sync(kFull, hp[k], c);
      }
      float plane[4];
      const bool ok = pick_plane(
          a, b, c, __shfl_sync(kFull, hpx, a), __shfl_sync(kFull, hpy, a),
          __shfl_sync(kFull, hpx, b), __shfl_sync(kFull, hpy, b),
          __shfl_sync(kFull, hpx, c), __shfl_sync(kFull, hpy, c), xf, yf, A,
          B, Cp, plane);
      int n_in = 0;
      for (int k = 0; k < count; ++k) {
        const float q[3] = {__shfl_sync(kFull, hp[0], k),
                            __shfl_sync(kFull, hp[1], k),
                            __shfl_sync(kFull, hp[2], k)};
        n_in += dvd(plane_dist(q, plane), p.depth_diff) < p.thr ? 1 : 0;
      }
      const bool usable = live && ok && n_in >= 6;
      const float cdist = plane_dist(centre, plane);
      for (uint32_t u = __ballot_sync(kFull, usable); u != 0u; u &= u - 1u) {
        const int from = __ffs(u) - 1;
        const int n = __shfl_sync(kFull, n_in, from);
        const float cd = __shfl_sync(kFull, cdist, from);
        float pl[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) pl[k] = __shfl_sync(kFull, plane[k], from);
        const int ka = __shfl_sync(kFull, a, from);
        const int kb = __shfl_sync(kFull, b, from);
        const int kc = __shfl_sync(kFull, c, from);
        if (n > best_count || (n == best_count && cd < best_cdist)) {
#pragma unroll
          for (int k = 0; k < 4; ++k) best[k] = pl[k];
          best_cdist = cd;
          best_count = n;
          abc[0] = ka;
          abc[1] = kb;
          abc[2] = kc;
          has = true;
        }
      }
    }
    // the triangle's ranks as directions
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int d = __shfl_sync(kFull, hit_dir, abc[k] < 0 ? 0 : abc[k]);
      abc[k] = abc[k] < 0 ? -1 : d;
    }
  }
  if constexpr (kPart == 2) {
    if (lane < 4) {
      reinterpret_cast<float*>(p.anchors)[static_cast<int64_t>(i) * 18 +
                                          lane] = best[lane];
    }
    if (lane < 3) {
      p.anchors[static_cast<int64_t>(i) * 18 + 4 + lane] = abc[lane];
    }
    if (lane == 0) {
      p.hit_count[i] = best_count;
      p.reliable[i] = has ? 1 : 0;
    }
    return;
  }

  // ---- rank the hits by plane distance (the triangle's members boosted by
  // -1), keep the 8 smallest, ties to the lower direction
  const float dist = plane_dist(pt, best);
  const bool is_inlier = found && dvd(dist, p.depth_diff) < p.thr;
  const bool is_abc = lane == abc[0] || lane == abc[1] || lane == abc[2];
  const float weight = is_inlier ? sub(dist, is_abc ? 1.f : 0.f) : INFINITY;
  int rank = 0;
  for (int k = 0; k < D; ++k) {
    const float other = __shfl_sync(kFull, weight, k);
    rank += other < weight || (other == weight && k < lane);
  }
  const bool reliable = count > 3 && has;
  int2* out = reinterpret_cast<int2*>(p.anchors) +
              static_cast<int64_t>(i) * (kSlots + 1);
  if (lane < D && rank < kSlots) {
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

int apde_jfa_tile_cols() { return kJfaX; }

int apde_jfa_tile_rows() { return kJfaRows; }

// A kernel's registers, local memory (spills) and resident blocks an SM
// (which: 0 K10, with a whole tile's shared memory; 1 K9, 2 K8); returns
// the first error.
int apde_anchor_kernel_info(int which, int* regs, int* local_bytes,
                            int* blocks_per_sm) {
  const void* kernel = which == 0   ? (const void*)jfa_phases
                       : which == 1 ? (const void*)fit_planes
                                    : (const void*)gen_anchors<0>;
  const int threads =
      which == 0 ? kJfaThreads : (which == 1 ? kFitThreads : kGenThreads);
  const size_t smem =
      which == 0 ? (2 * sizeof(int2) + sizeof(float)) * kJfaX * kJfaRows
                 : 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess && smem > 0) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                        threads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}

// K10 over the live sub-passes (steps[i], dx[i], dy[i]), i < n_sub, in
// the phases (folds[k], firsts[k], counts[k]), k < n_phases: each phase's
// sub-passes consecutive, each step a multiple of its fold, its reach
// inside a tile's kJfaX x kJfaRows footprint, all in one cooperative
// launch. ``scratch`` holds the two maps of entries ((2, H, W, 2) int32),
// ``out`` the result. A map side above 32,767, a phase that does not fit
// its tiles or a refused launch returns an error, and nothing is launched.
int apde_jfa(const void* weak, const void* conf, const void* valid,
             int strong, int h, int w, const int* steps, const int* dx,
             const int* dy, int n_sub, const int* folds, const int* firsts,
             const int* counts, int n_phases, void* out, void* scratch,
             void* stream) {
  if (h < 0 || w < 0 || h > kJfaMaxSide || w > kJfaMaxSide || n_sub < 0 ||
      n_sub > kJfaMaxSub || n_phases < 1 || n_phases > kJfaMaxSteps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<int64_t>(h) * w == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  JfaParams p;
  p.weak = static_cast<const int*>(weak);
  p.conf = static_cast<const float*>(conf);
  p.valid = static_cast<const uint8_t*>(valid);
  p.strong = strong;
  p.h = h;
  p.w = w;
  p.buf[0] = static_cast<int2*>(scratch);
  p.buf[1] = static_cast<int2*>(scratch) + static_cast<int64_t>(h) * w;
  p.out = static_cast<int2*>(out);
  p.n_phases = n_phases;
  size_t smem = 0;
  int items = 0, next = 0;
  for (int k = 0; k < n_phases; ++k) {
    JfaPhase& ph = p.ph[k];
    ph.fold = folds[k];
    ph.first = firsts[k];
    ph.count = counts[k];
    if (ph.fold < 1 || ph.first != next || ph.count < 0 ||
        ph.first + ph.count > n_sub) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    next += ph.count;
    int lo_x = 0, hi_x = 0, lo_y = 0, hi_y = 0;
    for (int s = ph.first; s < ph.first + ph.count; ++s) {
      if (steps[s] < 1 || steps[s] % ph.fold != 0 || dx[s] < -1 ||
          dx[s] > 1 || dy[s] < -1 || dy[s] > 1) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      const int unit = steps[s] / ph.fold;
      if (unit > 127) return static_cast<int>(cudaErrorInvalidValue);
      p.ox[s] = static_cast<signed char>(dx[s] * unit);
      p.oy[s] = static_cast<signed char>(dy[s] * unit);
      lo_x += std::max(0, -dx[s] * unit);
      hi_x += std::max(0, dx[s] * unit);
      lo_y += std::max(0, -dy[s] * unit);
      hi_y += std::max(0, dy[s] * unit);
    }
    if (!jfa_axis(ph.fold, w, lo_x, hi_x, kJfaX, &ph.x) ||
        !jfa_axis(ph.fold, h, lo_y, hi_y, kJfaRows, &ph.y)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int64_t n_items = static_cast<int64_t>(ph.x.groups) * ph.x.tiles *
                            ph.y.groups * ph.y.tiles;
    if (n_items > (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
    ph.items = static_cast<int>(n_items);
    items = std::max(items, ph.items);
    smem = std::max(smem, jfa_smem(ph));
  }
  if (next != n_sub) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      jfa_phases, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // resident blocks of the card: asked once a (device, shared memory)
  static int cached_dev = -1, cached_blocks = 0;
  static size_t cached_smem = 0;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev != cached_dev || smem != cached_smem)) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, jfa_phases, kJfaThreads, smem);
    }
    if (err == cudaSuccess) {
      cached_dev = dev;
      cached_smem = smem;
      cached_blocks = per_sm * sms;
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cached_blocks < 1) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  const int grid = std::min(items, cached_blocks);
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(jfa_phases),
                                    dim3(grid), dim3(kJfaThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K9: the fit planes of N weak pixels over ``iters`` RANSAC iterations.
int apde_fit_planes(const void* planes, int h, int w, const void* wx,
                    const void* wy, const void* anchors, const void* triplets,
                    int64_t trip_stride, int iters, int n, float fx, float fy,
                    float cx, float cy, void* out, void* stream) {
  if (iters < 0) return static_cast<int>(cudaErrorInvalidValue);
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
      static_cast<unsigned int>((n + kFitWarps - 1) / kFitWarps);
  fit_planes<<<grid, kFitThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// K8: the anchors of N weak pixels over D directions (D <= 32), probes
// ``margin`` from the edges, ``iters`` RANSAC iterations; j jitter draws a
// radius (4 only, the rows 16-byte aligned: else cudaErrorInvalidValue,
// nothing launched). ``part`` is 0 on
// the main path; 1 and 2 run the timing-only forms that end after the
// probe walk and after the RANSAC (the kernel's kPart).
int apde_gen_anchors(const void* ns, const void* planes, int h, int w,
                     int img_h, int img_w, const void* wx, const void* wy,
                     const void* shift_x, const void* shift_y,
                     const void* triplets, int64_t trip_stride, int iters,
                     int margin, const void* dirs, const void* radii,
                     int n, int d, int rn, int j, float fx, float fy,
                     float cx, float cy, float cone_cos, float thr,
                     float depth_diff, void* anchors, void* reliable,
                     void* hit_count, int part, void* stream) {
  if (part < 0 || part > 2) return static_cast<int>(cudaErrorInvalidValue);
  // a radius's 4 draws are read as one aligned vector
  if (d < kSlots || d > kMaxDirections || rn < 1 || j != kJitter ||
      reinterpret_cast<uintptr_t>(shift_x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(shift_y) % 16 != 0) {
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using Gen = void (*)(GenParams);
  const Gen forms[3] = {gen_anchors<0>, gen_anchors<1>, gen_anchors<2>};
  forms[part]<<<grid, kGenThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
