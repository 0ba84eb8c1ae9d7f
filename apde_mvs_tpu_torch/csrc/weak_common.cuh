// A weak pixel's reference side and its deformable (anchor-based) NCC,
// shared by K6 (weak.cu: P planes a launch, and the initial cost's
// re-score) and K7 (weak_sweep.cu, the weak sweep's chunk update), so they
// cannot drift apart. The reference side has two builders on one per-tap
// code (`ref_tap`: the clamped fetch and the SA tap weight;
// `anchor_valid`; `tap_order_sum`): K7's `build_weak_ref`, one pixel a
// warp, and K6's re-score form's `build_weak_refs`, a block's pixels at
// once, which builds only what `deformable_cost` reads.
//
// `build_weak_ref` builds the reference side in a warp's slice of shared
// memory from the reference image, the SA segment ids and the state's
// selections (`ops/cuda/weak.py`, `weak_ref_plain`): the centre window, the
// square taps of (strong_radius, strong_increment), dy outer, under SA
// each tap weighing 1 where the pixel is in no segment (id <= 0) or the
// tap's id is the pixel's (no star, no truncation: APD.cu:523-541); the 8
// anchors' sparse windows around each anchor clamped at 0, weighed against
// the weak pixel's segment; values by a clamped fetch, segment ids 0
// outside the array; sum_ref, sum_rr and the weight sums in tap order; the
// anchors' ``exists`` (x, y >= 0) and ``valid`` (exists and, under SA, the
// anchor's id is the pixel's or the pixel is in no segment) masks and
// their selected views.
//
// `deformable_cost` is the NCC of one (weak pixel, plane, view) pair: the
// centre's out-of-image test, the centre window's NCC, each of the 8
// anchors' sparse window NCC where it counts, the focal softmax over the
// anchors that count and the 0.25 / 0.75 blend (`ops/cuda/weak.py`,
// `weak_plain`; the JAX package's `deformable.ncc_weak`,
// apde_mvs_tpu/ops/deformable.py:124-198; the CUDA reference
// APD.cu:448-593). Every operation is rounded on its own, in the order of
// the plain version's torch ops (ncc_common.cuh says how); the exponential
// is expf, as torch.exp's.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ncc_common.cuh"

namespace apde {

constexpr int kAnchors = 8;           // deformable anchors 1..8
constexpr int kMainAnchorTaps = 9;    // cost.square_taps(5, 5)

// A weak pixel's anchors as a warp reads them from its slice of shared
// memory: the sparse window's offsets (shared by every anchor), each
// anchor's tap values (weighted: each tap's weight times its value) and
// weights, its coordinates, sums, 1 / weight sum and selected views, and
// which anchors are valid and have a positive weight sum.
struct WeakAnchors {
  const float* dx;          // (T',)
  const float* dy;
  const float* val;         // (8, T')
  const float* tw;          // (8, T'); read when weighted
  const float* x;           // (8,)
  const float* y;
  const float* sum_ref;     // (8,)
  const float* sum_rr;
  const float* inv;
  const unsigned* sel;      // (8,) bit s: the anchor selected view s
  unsigned valid;           // bit a: anchor a is valid
  unsigned positive;        // bit a: its weight sum is > 0
};

// the fetch of a segment id: 0 outside the array
__device__ __forceinline__ int segment_id(const int* __restrict__ sa, int x,
                                          int y, int w, int h) {
  return (x >= 0 && x < w && y >= 0 && y < h)
             ? __ldg(sa + static_cast<int64_t>(y) * w + x)
             : 0;
}

// Where a weak pixel's reference side comes from: the reference image
// (ref_h, width), the SA segment ids of the same shape (null: no SA), the
// state's (grid_h, grid_w, S) bool selections.
struct WeakRefSource {
  const float* ref;
  const int* sa;
  int ref_h;
  int width;
  const uint8_t* selected;
  int grid_h;
  int grid_w;
  int num_views;
};

// ---- the per-tap code of both builders ------------------------------------

// the clamped fetch of the reference image
__device__ __forceinline__ float ref_value(const WeakRefSource& src, int tx,
                                           int ty) {
  return __ldg(src.ref +
               static_cast<int64_t>(clamp_int(ty, src.ref_h - 1)) *
                   src.width +
               clamp_int(tx, src.width - 1));
}

// a tap's SA weight against the pixel's segment ``seg``: 1 where the pixel
// is in none (id <= 0) or the tap's id is the pixel's
__device__ __forceinline__ float tap_weight(const WeakRefSource& src,
                                            int seg, int tx, int ty) {
  return (seg <= 0 ||
          segment_id(src.sa, tx, ty, src.width, src.ref_h) == seg)
             ? 1.f
             : 0.f;
}

// A reference tap as it is staged: its value (kSA: the weight-value
// product) and its weight (kSA only).
struct RefTap {
  float val;
  float tw;
};

template <bool kSA>
__device__ __forceinline__ RefTap ref_tap(const WeakRefSource& src, int seg,
                                          int tx, int ty) {
  const float v = ref_value(src, tx, ty);
  if (kSA) {
    const float wt = tap_weight(src, seg, tx, ty);
    return {mul(wt, v), wt};
  }
  return {v, 1.f};
}

// an anchor's validity: it exists and, under SA, the pixel is in no
// segment or the anchor's (clamped) position is in the pixel's
template <bool kSA>
__device__ __forceinline__ bool anchor_valid(const WeakRefSource& src,
                                             int seg, bool exists, int axc,
                                             int ayc) {
  return exists &&
         (!kSA || seg <= 0 ||
          segment_id(src.sa, axc, ayc, src.width, src.ref_h) == seg);
}

// One of a window's sums in tap order from +0 over its ``n`` staged taps
// (kN > 0: n = kN, unrolled): ``what`` 0 sum_ref (the staged values), 1
// sum_rr (their squares), 2 the weight sum (kSA's weights, else 1 a tap).
template <bool kSA, int kN>
__device__ __forceinline__ float tap_order_sum(const float* val,
                                               const float* tw, int n,
                                               int what) {
  auto term = [&](int t) {
    const float wv = val[t];
    return what == 0 ? wv : (what == 1 ? mul(wv, wv) : (kSA ? tw[t] : 1.f));
  };
  float part = 0.f;
  if constexpr (kN > 0) {
#pragma unroll
    for (int t = 0; t < kN; ++t) part = add(part, term(t));
  } else {
    for (int t = 0; t < n; ++t) part = add(part, term(t));
  }
  return part;
}

// A pixel's slice of shared memory for its reference side: the centre's
// and the anchors' tap values (SA: the weight-value products) and weights
// (SA only), the anchors' x, y, sum_ref, sum_rr and 1 / wsum, their
// selected views and clamped coordinates (a word each).
struct WeakRefSlice {
  float* cval;     // (T,)
  float* ctw;      // (T,)
  float* aval;     // (8, T')
  float* atw;      // (8, T')
  float* ax;       // (8,)
  float* ay;
  float* asr;
  float* asrr;
  float* ainv;
  unsigned* sel;   // (8,) bit s: the anchor selected view s
  int* acx;        // (8,)
  int* acy;
};

// floats of a `WeakRefSlice` (kSA: with the weights)
__host__ __device__ inline int weak_ref_floats(int num_taps,
                                               int num_anchor_taps, bool sa) {
  return (num_taps + kAnchors * num_anchor_taps) * (sa ? 2 : 1) +
         5 * kAnchors + 3 * kAnchors;
}

// the `WeakRefSlice` laid out from ``base``
template <bool kSA>
__device__ __forceinline__ WeakRefSlice weak_ref_slice(float* base, int T,
                                                       int TA) {
  WeakRefSlice w;
  w.cval = base;
  w.aval = base + T;
  w.ctw = w.aval + kAnchors * TA;          // kSA only
  w.atw = w.ctw + T;
  w.ax = base + (T + kAnchors * TA) * (kSA ? 2 : 1);
  w.ay = w.ax + kAnchors;
  w.asr = w.ay + kAnchors;
  w.asrr = w.asr + kAnchors;
  w.ainv = w.asrr + kAnchors;
  w.sel = reinterpret_cast<unsigned*>(w.ainv + kAnchors);
  w.acx = reinterpret_cast<int*>(w.sel + kAnchors);
  w.acy = w.acx + kAnchors;
  return w;
}

// A built reference side: the centre window and the anchors as
// `deformable_cost` reads them, which anchors exist, and on which lanes
// the caller's ``mark`` returned true.
struct WeakRef {
  PixelWindow cwin;
  WeakAnchors an;
  unsigned exists;   // bit a: anchor a exists
  unsigned marked;   // bit l: lane l's mark
};

// Builds weak pixel (xi, yi)'s reference side in its slice ``w``, every
// lane of the warp taking part; ``anchors`` are the pixel's 9 (x, y) int32
// anchors (anchor 0 the pixel itself), ``cdx`` / ``cdy`` and ``adx`` /
// ``ady`` the two windows' offsets (T and T' taps). ``mark(lane, exists,
// axc, ayc)`` runs on every lane once the anchors are read (lane a < 8
// with anchor a + 1's existence and clamped coordinates, the other lanes
// with false, 0, 0): K7 reads each anchor's state and plane there. The
// sums in tap order: lanes 0-7 an anchor's sum_ref, 8-15 its sum_rr,
// 16-23 its weight sum, lanes 24, 25, 26 the centre's three.
template <bool kSA, typename Mark>
__device__ __forceinline__ WeakRef build_weak_ref(
    const WeakRefSource& src, int xi, int yi, const int* __restrict__ anchors,
    int T, int TA, const float* cdx, const float* cdy, const float* adx,
    const float* ady, const WeakRefSlice& w, int lane, Mark mark) {
  constexpr unsigned kLanes = 0xffffffffu;
  const int S = src.num_views;
  const int gw = src.grid_w, gh = src.grid_h;
  // the pixel's segment, against which its taps weigh
  const int seg = kSA ? segment_id(src.sa, xi, yi, src.width, src.ref_h) : 0;
  for (int t = lane; t < T; t += 32) {
    const RefTap tap = ref_tap<kSA>(src, seg, xi + static_cast<int>(cdx[t]),
                                    yi + static_cast<int>(cdy[t]));
    if (kSA) w.ctw[t] = tap.tw;
    w.cval[t] = tap.val;
  }
  // the anchors: lane a < 8 reads anchor a + 1 of the pixel's 9
  bool exists = false, valid = false;
  int axc = 0, ayc = 0;
  if (lane < kAnchors) {
    const int* an = anchors + (1 + lane) * 2;
    const int ax = __ldg(an), ay = __ldg(an + 1);
    exists = ax >= 0 && ay >= 0;
    axc = ax > 0 ? ax : 0;
    ayc = ay > 0 ? ay : 0;
    valid = anchor_valid<kSA>(src, seg, exists, axc, ayc);
    w.ax[lane] = static_cast<float>(ax);
    w.ay[lane] = static_cast<float>(ay);
    w.acx[lane] = axc;
    w.acy[lane] = ayc;
  }
  const bool marked = mark(lane, exists, axc, ayc);
  const unsigned exist_bits = __ballot_sync(kLanes, exists);
  const unsigned valid_bits = __ballot_sync(kLanes, valid);
  const unsigned marked_bits = __ballot_sync(kLanes, marked);
  __syncwarp();
  // each anchor's selected views (bit s: view s) and its window's taps
  for (int a = 0; a < kAnchors; ++a) {
    const int cx = w.acx[a], cy = w.acy[a];
    const bool sel =
        lane < S && cx < gw && cy < gh &&
        src.selected[(static_cast<int64_t>(cy) * gw + cx) * S + lane] != 0;
    const unsigned bits = __ballot_sync(kLanes, sel);
    if (lane == 0) w.sel[a] = bits;
  }
  for (int i = lane; i < kAnchors * TA; i += 32) {
    const int a = i / TA;
    const int t = i - a * TA;
    const RefTap tap =
        ref_tap<kSA>(src, seg, w.acx[a] + static_cast<int>(adx[t]),
                     w.acy[a] + static_cast<int>(ady[t]));
    if (kSA) w.atw[i] = tap.tw;
    w.aval[i] = tap.val;
  }
  __syncwarp();
  // the sums in tap order: lanes 0-7 an anchor's sum_ref, 8-15 its sum_rr,
  // 16-23 its weight sum; lanes 24, 25, 26 the centre's three
  float part = 0.f;
  {
    const int k = lane & 7;
    const int what = lane < 24 ? lane >> 3 : lane - 24;
    const float* val = lane < 24 ? w.aval + k * TA : w.cval;
    const float* tw = lane < 24 ? w.atw + k * TA : w.ctw;
    const int n = lane < 24 ? TA : T;
    if (lane < 27) part = tap_order_sum<kSA, 0>(val, tw, n, what);
  }
  bool positive = false;
  if (lane < kAnchors) {
    w.asr[lane] = part;
  } else if (lane < 2 * kAnchors) {
    w.asrr[lane - kAnchors] = part;
  } else if (lane < 3 * kAnchors) {
    // an anchor's weight sum: the count of its weights, or T' (no SA)
    bool empty;
    const float ws = kSA ? part : static_cast<float>(TA);
    inverse_weight_sum(ws, &w.ainv[lane - 2 * kAnchors], &empty);
    positive = ws > 0.f;
  }
  WeakRef r;
  r.an.positive = (__ballot_sync(kLanes, positive) >> (2 * kAnchors)) & 0xffu;
  r.cwin.dx = cdx;
  r.cwin.dy = cdy;
  r.cwin.val = w.cval;
  r.cwin.tw = w.ctw;
  r.cwin.sum_ref = __shfl_sync(kLanes, part, 24);
  r.cwin.sum_rr = __shfl_sync(kLanes, part, 25);
  const float c_wsum = __shfl_sync(kLanes, part, 26);
  if (kSA) {
    inverse_weight_sum(c_wsum, &r.cwin.inv, &r.cwin.empty);
  } else {
    // cost.ncc_from_sums' float32 1 / T of a float weight sum
    r.cwin.inv = dvd(1.f, static_cast<float>(T));
    r.cwin.empty = false;
  }
  r.an.dx = adx;
  r.an.dy = ady;
  r.an.val = w.aval;
  r.an.tw = w.atw;
  r.an.x = w.ax;
  r.an.y = w.ay;
  r.an.sum_ref = w.asr;
  r.an.sum_rr = w.asrr;
  r.an.inv = w.ainv;
  r.an.sel = w.sel;
  r.an.valid = valid_bits;
  r.exists = exist_bits;
  r.marked = marked_bits;
  return r;
}

// ---- the reference sides of many pixels at once (K6's re-score form) ------
//
// `build_weak_refs` builds the reference sides of a block's n pixels with
// its kN threads (K6's re-score form: 128) together, each into its
// `WeakRefSlice`, with the per-tap code above, so that everything
// `deformable_cost` reads equals `build_weak_ref`'s bit for bit. Its
// dependent path is one side's, not n of them:
//  1. the pixels and their 8 n anchors read at once (under SA with their
//     segment ids), the valid anchors listed;
//  2. the valid anchors' selections, their S bytes read as whole words;
//  3. the centre taps of every pixel and the taps of every valid anchor
//     spread over the threads, kLoads items issued a thread before the
//     first is stored;
//  4. the sums, each in tap order on a thread of its own, the centres'
//     (36 terms) first, then the valid anchors' (9 terms).
// Nothing else of an anchor that is not valid is built: `deformable_cost`
// reads nothing of it but its validity.

constexpr int kLoads = 8;   // tap items in flight a thread

// A block's builder scratch in shared memory: 15 words a pixel and a count.
struct WeakRefsScratch {
  int* x;            // (P,) the pixels' coordinates and segment ids
  int* y;
  int* seg;
  unsigned* valid;   // (P,) bit a: anchor a + 1 is valid
  float* csum;       // (3 P,) the centres' sum_ref, sum_rr, weight sum
  int* list;         // (8 P,) the valid anchors, 8 g + a, in no set order
  int* count;        // (1,) how many; 0 when `build_weak_refs` is entered
};

__host__ __device__ inline int weak_refs_scratch_words(int pixels) {
  return 15 * pixels + 1;
}

__device__ __forceinline__ WeakRefsScratch weak_refs_scratch(int* base,
                                                             int pixels) {
  WeakRefsScratch s;
  s.x = base;
  s.y = base + pixels;
  s.seg = base + 2 * pixels;
  s.valid = reinterpret_cast<unsigned*>(base + 3 * pixels);
  s.csum = reinterpret_cast<float*>(base + 4 * pixels);
  s.list = base + 7 * pixels;
  s.count = base + 15 * pixels;
  return s;
}

// Bit s: byte s of the S bytes at ``p`` is not 0. The bytes are read as the
// aligned 32-bit words that hold them (at most 9), all loads issued before
// the first is used; the bytes of those words outside the run are masked.
__device__ __forceinline__ unsigned selection_bits(const uint8_t* p, int S) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  const unsigned* words =
      reinterpret_cast<const unsigned*>(addr & ~uintptr_t{3});
  const int skip = static_cast<int>(addr & 3u);   // bytes before the run
  const int n = (skip + S + 3) >> 2;
  unsigned word[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) word[k] = k < n ? __ldg(words + k) : 0u;
  unsigned bits = 0u;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (k < n) {
      const unsigned nz = __vcmpne4(word[k], 0u);   // 0xff a non-zero byte
      const unsigned four = ((nz >> 7) & 1u) | ((nz >> 14) & 2u) |
                            ((nz >> 21) & 4u) | ((nz >> 28) & 8u);
      const int at = 4 * k - skip;   // in [-3, S - 1]: view of byte 0
      bits |= at >= 0 ? four << at : four >> -at;
    }
  }
  return S < 32 ? bits & ((1u << S) - 1u) : bits;
}

// Builds the reference sides of the n <= kN / 4 pixels (xs[g], ys[g]) with
// their anchors (anchors + 18 g: 9 (x, y) int32, anchor 0 the pixel), pixel
// g's into the slice at slices + g * pf (`weak_ref_slice`), the centres'
// sums and the anchors' validity into ``sc``; every thread ``tid`` < kN of
// the block takes part. kT / kTA are the two windows' tap counts where
// known at compile time, else 0 (T, TA count them). `built_weak_ref` reads
// a side.
template <bool kSA, int kN, int kT, int kTA>
__device__ __forceinline__ void build_weak_refs(
    const WeakRefSource& src, const int* __restrict__ xs,
    const int* __restrict__ ys, const int* __restrict__ anchors, int n,
    int num_taps, int num_anchor_taps, const float* cdx, const float* cdy,
    const float* adx, const float* ady, float* slices, int pf,
    const WeakRefsScratch& sc, int tid) {
  constexpr unsigned kLanes = 0xffffffffu;
  constexpr int kRounds = 2;   // 8 n <= 2 kN anchors
  const int T = kT > 0 ? kT : num_taps;
  const int TA = kTA > 0 ? kTA : num_anchor_taps;
  const int lane = tid & 31;
  auto slice = [&](int g) {
    return weak_ref_slice<kSA>(slices + g * pf, T, TA);
  };
  // ---- 1. the pixels and their anchors, every load issued at once -------
  int ax[kRounds], ay[kRounds], px[kRounds], py[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int i = tid + r * kN;
    ax[r] = ay[r] = -1;
    px[r] = py[r] = 0;
    if (i < kAnchors * n) {
      const int* an = anchors + ((i >> 3) * (kAnchors + 1) + 1 + (i & 7)) * 2;
      ax[r] = __ldg(an);
      ay[r] = __ldg(an + 1);
      px[r] = __ldg(xs + (i >> 3));
      py[r] = __ldg(ys + (i >> 3));
    }
  }
  if (tid < n) {
    const int xi = __ldg(xs + tid), yi = __ldg(ys + tid);
    sc.x[tid] = xi;
    sc.y[tid] = yi;
    sc.seg[tid] = kSA ? segment_id(src.sa, xi, yi, src.width, src.ref_h) : 0;
  }
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int i = tid + r * kN;
    const int g = i >> 3, a = i & 7;
    const bool mine = i < kAnchors * n;
    const bool exists = mine && ax[r] >= 0 && ay[r] >= 0;
    const int axc = ax[r] > 0 ? ax[r] : 0;
    const int ayc = ay[r] > 0 ? ay[r] : 0;
    const int seg = kSA && exists
                        ? segment_id(src.sa, px[r], py[r], src.width,
                                     src.ref_h)
                        : 0;
    const bool valid = anchor_valid<kSA>(src, seg, exists, axc, ayc);
    if (mine) {
      const WeakRefSlice w = slice(g);
      w.ax[a] = static_cast<float>(ax[r]);
      w.ay[a] = static_cast<float>(ay[r]);
      w.acx[a] = axc;
      w.acy[a] = ayc;
    }
    // a warp's 32 anchors are 4 whole pixels': its valid ones listed at once
    const unsigned bits = __ballot_sync(kLanes, valid);
    if (mine && a == 0) sc.valid[g] = (bits >> (lane & 24)) & 0xffu;
    if (bits != 0u) {
      int base = 0;
      if (lane == 0) base = atomicAdd(sc.count, __popc(bits));
      base = __shfl_sync(kLanes, base, 0);
      if (valid) sc.list[base + __popc(bits & ((1u << lane) - 1u))] = i;
    }
  }
  __syncthreads();
  const int nv = *sc.count;
  // ---- 2. the valid anchors' selections (bit s: view s) -----------------
  {
    const int S = src.num_views, gw = src.grid_w, gh = src.grid_h;
    for (int k = tid; k < nv; k += kN) {
      const int i = sc.list[k];
      const WeakRefSlice w = slice(i >> 3);
      const int a = i & 7;
      const int cx = w.acx[a], cy = w.acy[a];
      w.sel[a] = cx < gw && cy < gh
                     ? selection_bits(src.selected +
                                          (static_cast<int64_t>(cy) * gw +
                                           cx) * S,
                                      S)
                     : 0u;
    }
  }
  // ---- 3. the taps: every centre's, then every valid anchor's -----------
  // a tap's weight sits T + 8 T' floats past its value, in both windows
  const int D = T + kAnchors * TA;
  const int nc = n * T;
  const int total = nc + nv * TA;
  for (int base = 0; base < total; base += kLoads * kN) {
    RefTap tap[kLoads];
    int at[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int item = base + u * kN + tid;
      at[u] = -1;
      if (item < total) {
        int g, tx, ty;
        if (item < nc) {
          g = item / T;
          const int t = item - g * T;
          tx = sc.x[g] + static_cast<int>(cdx[t]);
          ty = sc.y[g] + static_cast<int>(cdy[t]);
          at[u] = g * pf + t;
        } else {
          const int j = item - nc;
          const int k = j / TA;
          const int t = j - k * TA;
          const int i = sc.list[k];
          const int a = i & 7;
          g = i >> 3;
          const WeakRefSlice w = slice(g);
          tx = w.acx[a] + static_cast<int>(adx[t]);
          ty = w.acy[a] + static_cast<int>(ady[t]);
          at[u] = g * pf + T + a * TA + t;
        }
        tap[u] = ref_tap<kSA>(src, sc.seg[g], tx, ty);
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (at[u] >= 0) {
        slices[at[u]] = tap[u].val;
        if (kSA) slices[at[u] + D] = tap[u].tw;
      }
    }
  }
  __syncthreads();
  // ---- 4. the sums in tap order, one a thread: the centres' first -------
  const int per = kSA ? 3 : 2;   // without SA a weight sum is the count
  const int ncs = n * per;
  const int chains = ncs + nv * per;
  for (int c = tid; c < chains; c += kN) {
    if (c < ncs) {
      const int g = c / per;
      const int what = c - g * per;
      const float* val = slices + g * pf;
      sc.csum[3 * g + what] = tap_order_sum<kSA, kT>(val, val + D, T, what);
    } else {
      const int j = c - ncs;
      const int k = j / per;
      const int what = j - k * per;
      const int i = sc.list[k];
      const int a = i & 7;
      const WeakRefSlice w = slice(i >> 3);
      const float part = tap_order_sum<kSA, kTA>(w.aval + a * TA,
                                                 w.atw + a * TA, TA, what);
      bool empty;
      if (what == 0) {
        w.asr[a] = part;
        // an anchor's weight sum without SA: T'
        if (!kSA) inverse_weight_sum(static_cast<float>(TA), &w.ainv[a],
                                     &empty);
      } else if (what == 1) {
        w.asrr[a] = part;
      } else {
        inverse_weight_sum(part, &w.ainv[a], &empty);
      }
    }
  }
  __syncthreads();
}

// Pixel g's reference side from the block `build_weak_refs` built, as
// `deformable_cost` reads it: the centre window and the anchors (an
// anchor's weight sum is > 0 iff its 1 / weight sum is, which
// `inverse_weight_sum` makes 0 for a sum <= 0).
template <bool kSA>
__device__ __forceinline__ void built_weak_ref(
    const WeakRefsScratch& sc, float* slices, int pf, int g, int T, int TA,
    const float* cdx, const float* cdy, const float* adx, const float* ady,
    PixelWindow* cwin, WeakAnchors* an) {
  const WeakRefSlice w = weak_ref_slice<kSA>(slices + g * pf, T, TA);
  cwin->dx = cdx;
  cwin->dy = cdy;
  cwin->val = w.cval;
  cwin->tw = w.ctw;
  cwin->sum_ref = sc.csum[3 * g];
  cwin->sum_rr = sc.csum[3 * g + 1];
  if (kSA) {
    inverse_weight_sum(sc.csum[3 * g + 2], &cwin->inv, &cwin->empty);
  } else {
    // cost.ncc_from_sums' float32 1 / T of a float weight sum
    cwin->inv = dvd(1.f, static_cast<float>(T));
    cwin->empty = false;
  }
  an->dx = adx;
  an->dy = ady;
  an->val = w.aval;
  an->tw = w.atw;
  an->x = w.ax;
  an->y = w.ay;
  an->sum_ref = w.asr;
  an->sum_rr = w.asrr;
  an->inv = w.ainv;
  an->sel = w.sel;
  an->valid = sc.valid[g];
  unsigned positive = 0u;
  for (unsigned v = an->valid; v != 0u; v &= v - 1u) {
    const int a = __ffs(v) - 1;
    if (w.ainv[a] > 0.f) positive |= 1u << a;
  }
  an->positive = positive;
}

// The deformable NCC of the pixel (x, y) against view ``s`` for the plane
// whose homography into the view is ``h`` (`weak_plain` per pair):
//  1. COST_MAX where the centre leaves the image (nothing else is needed);
//  2. the centre window's NCC (`window_cost`);
//  3. the 8 anchors in order: one that is not valid does not count; a valid
//     one whose warp leaves the image counts at COST_MAX iff it selected
//     view s; one that stays in the image counts with its sparse window's
//     NCC iff its weight sum is > 0;
//  4. `deformable._softmax_weighted` over the counting anchors: their max,
//     exp(c - max), the sums of e and of e c in anchor order from +0, one
//     true division, capped at COST_MAX; then 0.25 centre + 0.75 anchors,
//     or the centre's cost alone where no anchor counts.
// ``my_cost`` is the calling lane's column of an (8, 32) scratch array in
// shared memory (anchor a at my_cost[32 a]), where the anchors' costs wait
// for the softmax. kTaps / kATaps are the two windows' tap counts where
// they are known at compile time, else 0 (``num_taps``, ``num_anchor_taps``
// count them).
template <typename Q, bool kWeighted, int kTaps, int kATaps>
__device__ __forceinline__ float deformable_cost(
    const Q* __restrict__ tab, const float (&h)[3][3], float x, float y,
    int num_taps, int num_anchor_taps, const PixelWindow& cwin,
    const WeakAnchors& an, int s, float* my_cost, int width, int quad_h,
    float img_w, float img_h) {
  if (out_of_image(h, x, y, img_w, img_h)) return kCostMax;
  const int TA = kATaps > 0 ? kATaps : num_anchor_taps;
  const float centre = window_cost<Q, kWeighted, kTaps>(
      tab, h, x, y, num_taps, cwin, width, quad_h);
  // the anchors' costs and which of them count, in anchor order
  unsigned counts = 0u;
  float top = -INFINITY;
#pragma unroll 1
  for (int a = 0; a < kAnchors; ++a) {
    if (!((an.valid >> a) & 1u)) continue;
    const float ax = an.x[a];
    const float ay = an.y[a];
    float v = kCostMax;
    if (out_of_image(h, ax, ay, img_w, img_h)) {
      if (!((an.sel[a] >> s) & 1u)) continue;
    } else {
      if (!((an.positive >> a) & 1u)) continue;
      PixelWindow awin;
      awin.dx = an.dx;
      awin.dy = an.dy;
      awin.val = an.val + a * TA;
      awin.tw = an.tw + a * TA;
      awin.sum_ref = an.sum_ref[a];
      awin.sum_rr = an.sum_rr[a];
      awin.inv = an.inv[a];
      awin.empty = false;
      v = window_cost<Q, kWeighted, kATaps>(tab, h, ax, ay, TA, awin, width,
                                             quad_h);
    }
    counts |= 1u << a;
    my_cost[32 * a] = v;
    top = v > top ? v : top;
  }
  if (counts == 0u) return centre;
  // deformable._softmax_weighted: the sums in anchor order from +0 (an
  // anchor that does not count adds +0, which changes nothing)
  float denom = 0.f, num = 0.f;
#pragma unroll 1
  for (int a = 0; a < kAnchors; ++a) {
    if (!((counts >> a) & 1u)) continue;
    const float v = my_cost[32 * a];
    const float e = expf(sub(v, top));
    denom = add(denom, e);
    num = add(num, mul(e, v));
  }
  float anchored = dvd(num, clamp_min_keep_nan(denom, 1e-30f));
  anchored = anchored > kCostMax ? kCostMax : anchored;
  return add(mul(0.25f, centre), mul(0.75f, anchored));
}

}  // namespace apde
