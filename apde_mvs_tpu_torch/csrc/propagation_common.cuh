// The per-pixel steps a PatchMatch sweep's update shares between the strong
// sweep's colour update K3 (strong.cu) and the weak sweep's chunk update K7
// (weak_sweep.cu), so the two cannot drift apart: the joint view selection
// over 8 candidates' cost rows (`ops/selection.py`, its `ordered_*` forms;
// the reference APD.cu:1318-1386), the adoption's last minimum
// (FindMinCostIndex's <=, APD.cu:60-71), the 5 refinement hypotheses of
// `propagation.refinement_from_raws` from injected draws (APD.cu:950-1027)
// and the first minimum of their costs. Every f32 operation is rounded on
// its own (ncc_common.cuh's mul / add / sub / dvd), in the order of the
// plain versions' torch ops (`strong.select_views_plain`,
// `strong.refinement_planes_plain`), lengths in float64 as `strong._norm`
// takes them; a warp runs one pixel at a time, or (`select_views_thread`,
// the hypotheses called with lane 0) a thread runs one.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "geom_common.cuh"
#include "ncc_common.cuh"

namespace apde {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCandidates = 8;        // candidate rows of the selection
constexpr int kSamples = 15;          // selection.NUM_SAMPLES
constexpr int kHyps = 5;              // refinement hypotheses
constexpr float kPriorSelected = 0.9f;
constexpr float kPriorUnselected = 0.1f;
constexpr float kExpScale = -0.18f;   // exp(c^2 / -0.18) of a good cost
constexpr float kCostFalse = 1.2f;    // a cost above counts as false

// the index of the k-th set bit of ``mask`` (k < popc(mask))
__device__ __forceinline__ int nth_bit(unsigned mask, int k) {
  for (int i = 0; i < k; ++i) mask &= mask - 1;
  return __ffs(mask) - 1;
}

// torch.maximum on the card: NaN from either side, the first's first
__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// torch.argmin's rule for one more value: a NaN is taken first, else a
// strictly smaller value
__device__ __forceinline__ bool takes(float best, float v) {
  return !isnan(best) && (isnan(v) || v < best);
}

// |v| rounded once: sqrt((v0^2 + v1^2) + v2^2) in float64 (each square
// exact), then to float32, as the plain version's `_norm`
__device__ __forceinline__ float norm3(const float v[3]) {
  const double a = v[0], b = v[1], c = v[2];
  return __double2float_rn(__dsqrt_rn(
      __dadd_rn(__dadd_rn(__dmul_rn(a, a), __dmul_rn(b, b)),
                __dmul_rn(c, c))));
}

// v / |v|, the norm clamped below at ``floor`` (0: not clamped)
__device__ __forceinline__ void normalize(float v[3], float floor) {
  float n = norm3(v);
  if (floor > 0.f) n = clamp_min_keep_nan(n, floor);
#pragma unroll
  for (int j = 0; j < 3; ++j) v[j] = dvd(v[j], n);
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return add(add(mul(a[0], b[0]), mul(a[1], b[1])), mul(a[2], b[2]));
}

// geometry.make_plane's w: -((n0 X + n1 Y) + n2 d) of the point at depth d
// (X = d (x - cx) / fx, Y = d (y - cy) / fy)
__device__ __forceinline__ float plane_w(const float n[3], float d, float x,
                                         float y, float fx, float fy,
                                         float cx, float cy) {
  const float X = dvd(mul(d, sub(x, cx)), fx);
  const float Y = dvd(mul(d, sub(y, cy)), fy);
  return -add(add(mul(n[0], X), mul(n[1], Y)), mul(n[2], d));
}

// What the view selection leaves a lane.
struct Selection {
  float vw;            // lane s < S: view s's weight (a vote count); else 0
  unsigned weighted;   // bit s: view s weighs > 0
  int n_weighted;
  float inv;           // 1 / wnorm; 0 where the pixel has no views
  bool has;            // wnorm > 0
};

// The view selection of one pixel, lane s < S taking view s, from the
// (8, S) candidate cost rows ``costs`` in the warp's slice and the lane's
// ``prior`` (its view's 0.9 / 0.1 votes): each view's sampling probability
// from its 8 candidate costs at (``threshold``, ``fallback``) =
// `selection.selection_thresholds`, times the prior; the CDF as a running
// sum in view order; the 15 Monte-Carlo samples from the pixel's uniforms
// ``sel_u`` (15,), one a lane: integer view weights, their sum wnorm (the
// samples that land on a view), 1 / wnorm.
__device__ __forceinline__ Selection select_views(
    const float* costs, int S, int lane, float prior, float threshold,
    float fallback, const float* __restrict__ sel_u) {
  const int s = lane < S ? lane : S - 1;
  int count = 0, count_false = 0;
  float tmpw = 0.f;
  for (int c = 0; c < kCandidates; ++c) {
    const float v = costs[c * S + s];
    const bool good = v < threshold;
    count += good ? 1 : 0;
    count_false += v > kCostFalse ? 1 : 0;
    tmpw = add(tmpw, good ? expf(dvd(mul(v, v), kExpScale)) : 0.f);
  }
  float prob = (count > 2 && count_false < 3)
                   ? dvd(tmpw, static_cast<float>(count > 1 ? count : 1))
                   : (count_false < 3 ? fallback : 0.f);
  prob = lane < S ? mul(prob, prior) : 0.f;
  // the CDF: the running sum in view order, each lane its own entry
  float run = 0.f, raw = 0.f;
  for (int t = 0; t < S; ++t) {
    run = add(run, __shfl_sync(kFull, prob, t));
    if (lane == t) raw = run;
  }
  const float total = run;
  const float cdf = dvd(raw, clamp_min_keep_nan(total, 1e-30f));
  // the 15 samples, one a lane: the count of views whose cdf <= u
  const float u = lane < kSamples ? __ldg(sel_u + lane) : 0.f;
  int idx = 0;
  for (int t = 0; t < S; ++t) {
    idx += __shfl_sync(kFull, cdf, t) <= u ? 1 : 0;
  }
  int votes = 0;
  for (int t = 0; t < S; ++t) {
    const unsigned hit = __ballot_sync(kFull, lane < kSamples && idx == t);
    if (lane == t) votes = __popc(hit);
  }
  const bool mass = total > 0.f;
  Selection sel;
  sel.vw = (mass && lane < S) ? static_cast<float>(votes) : 0.f;
  sel.weighted = __ballot_sync(kFull, sel.vw != 0.f);
  sel.n_weighted = __popc(sel.weighted);
  const float wnorm = static_cast<float>(
      mass ? __popc(__ballot_sync(kFull, lane < kSamples && idx < S)) : 0);
  sel.has = wnorm > 0.f;
  sel.inv = sel.has ? dvd(1.f, clamp_min_keep_nan(wnorm, 1e-20f)) : 0.f;
  return sel;
}

// The view selection of one pixel in one thread, `select_views`' arithmetic
// in its order: ``costs`` the (8, S) candidate cost rows, ``prior(s)`` view
// s's 0.9 / 0.1 votes, ``sel_u`` the pixel's 15 uniforms; ``vw`` (S) first
// holds the running sum, then the CDF, then the integer view weights.
// Returns the rest (its ``vw`` 0).
template <typename Prior>
__device__ __forceinline__ Selection select_views_thread(
    const float* costs, int S, Prior prior, float threshold, float fallback,
    const float* __restrict__ sel_u, float* vw) {
  float run = 0.f;
  for (int s = 0; s < S; ++s) {
    int count = 0, count_false = 0;
    float tmpw = 0.f;
    for (int c = 0; c < kCandidates; ++c) {
      const float v = costs[c * S + s];
      const bool good = v < threshold;
      count += good ? 1 : 0;
      count_false += v > kCostFalse ? 1 : 0;
      tmpw = add(tmpw, good ? expf(dvd(mul(v, v), kExpScale)) : 0.f);
    }
    const float prob = (count > 2 && count_false < 3)
                           ? dvd(tmpw, static_cast<float>(count > 1 ? count
                                                                    : 1))
                           : (count_false < 3 ? fallback : 0.f);
    run = add(run, mul(prob, prior(s)));
    vw[s] = run;
  }
  const float total = run;
  const float denom = clamp_min_keep_nan(total, 1e-30f);
  for (int s = 0; s < S; ++s) vw[s] = dvd(vw[s], denom);
  // the 15 samples: the count of views whose cdf <= u
  int idx[kSamples];
  int landed = 0;
#pragma unroll
  for (int k = 0; k < kSamples; ++k) {
    const float u = __ldg(sel_u + k);
    int i = 0;
    for (int t = 0; t < S; ++t) i += vw[t] <= u ? 1 : 0;
    idx[k] = i;
    landed += i < S ? 1 : 0;
  }
  const bool mass = total > 0.f;
  Selection sel;
  sel.vw = 0.f;
  sel.weighted = 0u;
  sel.n_weighted = 0;
  for (int t = 0; t < S; ++t) {
    int votes = 0;
#pragma unroll
    for (int k = 0; k < kSamples; ++k) votes += idx[k] == t ? 1 : 0;
    const float w = mass ? static_cast<float>(votes) : 0.f;
    vw[t] = w;
    if (w != 0.f) {
      sel.weighted |= 1u << t;
      ++sel.n_weighted;
    }
  }
  const float wnorm = static_cast<float>(mass ? landed : 0);
  sel.has = wnorm > 0.f;
  sel.inv = sel.has ? dvd(1.f, clamp_min_keep_nan(wnorm, 1e-20f)) : 0.f;
  return sel;
}

// The last minimum of the 8 candidates' weighted costs, lane c < 8 holding
// candidate c's ``cost`` (FindMinCostIndex's <=): its index, and its cost
// in ``best_cost``.
__device__ __forceinline__ int last_minimum(float cost, float* best_cost) {
  int best = kCandidates - 1;
  float bc = __shfl_sync(kFull, cost, kCandidates - 1);
  for (int c = kCandidates - 2; c >= 0; --c) {
    const float v = __shfl_sync(kFull, cost, c);
    if (takes(bc, v)) {
      best = c;
      bc = v;
    }
  }
  *best_cost = bc;
  return best;
}

// A sweep's refinement draws (B,), (B, 3), (B,), (B, 3).
struct RefineDraws {
  const float* u_rand;
  const float* gauss;
  const float* u_pert;
  const float* angles;
};

// The 5 refinement hypotheses of `refinement_from_raws` for pixel b at
// (x, y) with the current plane ``plane_cur``, from its draws: (random
// depth, current normal), (current depth, the Gaussian normal flipped to
// face the camera), (random, random), (current depth, the normal rotated
// by the Euler angles, kept where it would face away), (the depth
// perturbed by up to +-2%, current normal). Lane 0 writes their planes
// (make_plane) to ``w_hyp`` (5, 4); returns bit h: hypothesis h's depth
// lies in [depth_min, depth_max] and the pixel has views (``has``).
__device__ __forceinline__ unsigned refinement_hypotheses(
    const RefineDraws& d, int64_t b, float x, float y, float fx, float fy,
    float cx, float cy, const float (&plane_cur)[4], float depth_min,
    float depth_max, bool has, int lane, float* w_hyp) {
  const float depth_cur = plane_depth(fx, fy, cx, cy, x, y, plane_cur[0],
                                      plane_cur[1], plane_cur[2],
                                      plane_cur[3]);
  const float d_rand = maximum(
      depth_min,
      add(mul(__ldg(d.u_rand + b), sub(depth_max, depth_min)), depth_min));
  // the Gaussian's direction, flipped to face the camera
  float n_rand[3], vd[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) n_rand[j] = __ldg(d.gauss + 3 * b + j);
  normalize(n_rand, 1e-12f);
  vd[0] = dvd(mul(depth_cur, sub(x, cx)), fx);
  vd[1] = dvd(mul(depth_cur, sub(y, cy)), fy);
  vd[2] = depth_cur;
  normalize(vd, 0.f);
  if (dot3(n_rand, vd) > 0.f) {
#pragma unroll
    for (int j = 0; j < 3; ++j) n_rand[j] = -n_rand[j];
  }
  // the depth perturbed by up to +-2%
  const float lo = mul(0.98f, depth_cur);
  const float d_pert = maximum(
      lo, add(mul(__ldg(d.u_pert + b), sub(mul(1.02f, depth_cur), lo)), lo));
  // the current normal rotated by the Euler angles, kept where it would
  // face away from the camera
  const float a1 = __ldg(d.angles + 3 * b), a2 = __ldg(d.angles + 3 * b + 1),
              a3 = __ldg(d.angles + 3 * b + 2);
  const float s1 = sinf(a1), s2 = sinf(a2), s3 = sinf(a3);
  const float c1 = cosf(a1), c2 = cosf(a2), c3 = cosf(a3);
  const float rot[3][3] = {
      {mul(c2, c3), sub(mul(mul(c3, s1), s2), mul(c1, s3)),
       add(mul(s1, s3), mul(mul(c1, c3), s2))},
      {mul(c2, s3), add(mul(c1, c3), mul(mul(s1, s2), s3)),
       sub(mul(mul(c1, s2), s3), mul(c3, s1))},
      {-s2, mul(c2, s1), mul(c1, c2)}};
  float n_pert[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) n_pert[i] = dot3(rot[i], plane_cur);
  float vd1[3] = {dvd(sub(x, cx), fx), dvd(sub(y, cy), fy), 1.f};
  normalize(vd1, 0.f);
  if (dot3(n_pert, vd1) >= 0.f) {
#pragma unroll
    for (int j = 0; j < 3; ++j) n_pert[j] = plane_cur[j];
  }
  normalize(n_pert, 1e-12f);
  // hypothesis h: its plane (make_plane), and whether the depth that plane
  // induces lies in range
  unsigned ok_mask = 0u;
  auto hypothesis = [&](int h, float depth, const float n[3]) {
    const float w = plane_w(n, depth, x, y, fx, fy, cx, cy);
    const float dh = plane_depth(fx, fy, cx, cy, x, y, n[0], n[1], n[2], w);
    if (dh >= depth_min && dh <= depth_max && has) ok_mask |= 1u << h;
    if (lane == 0) {
      w_hyp[4 * h + 0] = n[0];
      w_hyp[4 * h + 1] = n[1];
      w_hyp[4 * h + 2] = n[2];
      w_hyp[4 * h + 3] = w;
    }
  };
  hypothesis(0, d_rand, plane_cur);
  hypothesis(1, depth_cur, n_rand);
  hypothesis(2, d_rand, n_rand);
  hypothesis(3, depth_cur, n_pert);
  hypothesis(4, d_pert, plane_cur);
  return ok_mask;
}

// The hypotheses' costs, lane h < 5 adding its ``n_w`` weighted terms
// (row h of ``w_term``, kSamples wide) in order and scaling by ``inv``
// (inf where bit h of ``ok_mask`` is clear), and their first minimum
// (torch.argmin's rule): its index, and its cost in ``cost``.
__device__ __forceinline__ int first_minimum(const float* w_term, int n_w,
                                             unsigned ok_mask, float inv,
                                             int lane, float* cost) {
  float hyp_cost = INFINITY;
  if (lane < kHyps) {
    float acc = 0.f;
    for (int k = 0; k < n_w; ++k) acc = add(acc, w_term[lane * kSamples + k]);
    if ((ok_mask >> lane) & 1u) hyp_cost = mul(acc, inv);
  }
  int rb = 0;
  float rv = __shfl_sync(kFull, hyp_cost, 0);
  for (int h = 1; h < kHyps; ++h) {
    const float v = __shfl_sync(kFull, hyp_cost, h);
    if (takes(rv, v)) {
      rb = h;
      rv = v;
    }
  }
  *cost = rv;
  return rb;
}

}  // namespace apde
