"""Adaptive patch deformation: anchor machinery for weak-texture pixels.

The reference's three brute-force kernels, as batched torch ops (the
plain versions of the port's K10, K8 and K9):

- FindNearestStrongPoint (APD.cu:2434-2484) scans a 201x201 window per
  pixel; here it is a jump-flooding transform (log-step passes of 8
  neighbour fetches) that returns the nearest STRONG pixel per pixel, with
  the reference's acceptance predicate (candidate confidence >= the
  querying pixel's) applied during relaxation and ties preferring higher
  confidence — the JAX package's formulation, reproduced exactly.
- GenAnchors (APD.cu:1857-2082): per weak pixel, probe 8*rotate_time
  compass directions over a budgeted radius schedule with jittered samples
  snapped through the nearest-strong map, accept the first probe within
  the angular cone, then RANSAC a support plane through the hit set and
  keep the 8 best-fitting hits as anchors. The (pixels, probes) tensors are
  chunked over weak pixels to bound memory.
- RANSACToGetFitPlane (APD.cu:2486-2598): per-iteration plane fit through
  a weak pixel's anchors.

Randomness: the jitter shifts and RANSAC triplets come from a
torch.Generator, or are injected (`AnchorRaws`, `triplets`): torch cannot
reproduce the JAX package's threefry draws, so parity with it is exact
under injected draws only.

Float discipline: every product, sum and comparison that gates a discrete
choice is written in the JAX package's operation order (3-term dots and
norms left-associated, the cross product in `jnp.cross` component order),
since RANSAC redraws the same triangle in permuted vertex order and ulp
differences would flip real ties; every reduction that decides something
runs in a fixed order (the fit cost's sum over the anchors left to right,
the view direction's length in float64 rounded once).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import ANCHOR_NUM, MAX_SEARCH_RADIUS, STRONG, UNKNOWN, WEAK
from ..core import geometry as geo
from ..core.sampling import fetch
from .state import PMState

RANSAC_ITERS = 50           # reference: `int iteration = 50` (APD.cu:1989)
MIN_MARGIN = 6
# probes per (direction, radius) and the radius schedule's length, as in
# the JAX package's defaults
JITTER_SAMPLES = 4
RADIUS_BUDGET = 25

# weak pixels per gen_anchors evaluation: its probe tensors are
# (chunk, 8*rotate_time * radii * jitter) — 2432 columns at rotate_time 4
ANCHOR_CHUNK = 1 << 14


# ---------------------------------------------------------------------------
# Nearest strong point via jump flooding
# ---------------------------------------------------------------------------

def jfa_steps(h: int, w: int) -> list:
    """The flooding's jump steps for an (h, w) map: the powers of two from
    the first at or above max(h, w) - 1 down to 1, then 1 again (JFA+1)."""
    max_step = 1 << (max(h, w) - 1).bit_length()
    steps = []
    s = max_step
    while s >= 1:
        steps.append(s)
        s //= 2
    steps.append(1)  # extra pass improves JFA accuracy (JFA+1)
    return steps


JFA_NEIGHBOURS = tuple((dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                       if dx or dy)   # a step's sub-passes, in order


def nearest_strong_jfa_plain(weak: torch.Tensor, confidence: torch.Tensor,
                             valid: torch.Tensor) -> torch.Tensor:
    """(H, W) maps -> (H, W, 2) int32 coords of the nearest STRONG pixel with
    confidence >= own (ties prefer higher confidence); (-1, -1) when none.
    STRONG pixels map to themselves. Each (step, neighbour) relaxes the
    whole map against the one the previous neighbours left."""
    h, w = weak.shape
    dev = weak.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.int32, device=dev),
                            torch.arange(w, dtype=torch.int32, device=dev),
                            indexing="ij")
    strong = (weak == STRONG) & valid
    bx = torch.where(strong, xs, -1)
    by = torch.where(strong, ys, -1)
    big = torch.iinfo(torch.int32).max

    for step in jfa_steps(h, w):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dx == 0 and dy == 0:
                    continue
                nx = xs + dx * step
                ny = ys + dy * step
                cx = fetch(bx, nx, ny, fill=-1)
                cy = fetch(by, nx, ny, fill=-1)
                c_conf = fetch(confidence, torch.clamp(cx, min=0),
                               torch.clamp(cy, min=0))
                cand_ok = (cx >= 0) & (c_conf >= confidence)
                d_cand = (cx - xs) * (cx - xs) + (cy - ys) * (cy - ys)
                b_conf = fetch(confidence, torch.clamp(bx, min=0),
                               torch.clamp(by, min=0))
                d_best = torch.where(
                    bx >= 0, (bx - xs) * (bx - xs) + (by - ys) * (by - ys),
                    big)
                better = cand_ok & ((d_cand < d_best)
                                    | ((d_cand == d_best)
                                       & (c_conf > b_conf)))
                bx = torch.where(better, cx, bx)
                by = torch.where(better, cy, by)
    bx = torch.where(strong, xs, bx)
    by = torch.where(strong, ys, by)
    return torch.stack([bx, by], dim=-1)


# ---------------------------------------------------------------------------
# Directional anchor search + support-plane RANSAC
# ---------------------------------------------------------------------------

def _radius_schedule(budget: int = 25) -> np.ndarray:
    """Subsampled version of the reference's r <- min(2r, r+25) expansion
    (APD.cu:1915) from 2 to MAX_SEARCH_RADIUS, geometric in radius value so
    the dense small radii (where anchors actually live) are all kept."""
    full = []
    r = 2
    while r <= MAX_SEARCH_RADIUS:
        full.append(r)
        r = min(2 * r, r + 25)
    if len(full) <= budget:
        return np.asarray(full, np.int32)
    targets = np.geomspace(2, full[-1], budget)
    full_arr = np.asarray(full)
    picked = sorted({int(full_arr[np.argmin(np.abs(full_arr - t))])
                     for t in targets})
    return np.asarray(picked, np.int32)


def _direction_table(rotate_time: int) -> np.ndarray:
    """(D, 2) unit directions: 8 compass origins x rotate_time rotations of
    45/rotate_time degrees (reference: APD.cu:1896-1961)."""
    dirs = []
    angle = 45.0 / rotate_time
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            if ox == 0 and oy == 0:
                continue
            d = np.array([ox, oy], np.float64)
            d /= np.linalg.norm(d)
            for k in range(rotate_time):
                a = math.radians(angle * k)
                rot = np.array([[math.cos(a), -math.sin(a)],
                                [math.sin(a), math.cos(a)]])
                dirs.append(rot @ d)
    return np.asarray(dirs, np.float32)


class AnchorResult(NamedTuple):
    anchors: torch.Tensor    # (Nw, ANCHOR_NUM, 2) int32; [:, 0] = self
    reliable: torch.Tensor   # (Nw,) bool
    hit_count: torch.Tensor  # (Nw,) int32 directions with an accepted probe


class AnchorRaws(NamedTuple):
    """Raw random draws of `gen_anchors`, consumed positionally (the anchor
    oracle and the JAX package's `AnchorRaws` take the same layout)."""

    shift_x: torch.Tensor    # (Nw, D*Rn*J) int32 jitter draws
    shift_y: torch.Tensor    # (Nw, D*Rn*J) int32
    triplets: torch.Tensor   # (RANSAC_ITERS, Nw, 3) int32 raw draws [0, 2^30)


def _shift_range(rotate_time: int) -> int:
    angle = 45.0 / rotate_time
    return max(int(math.tan(math.radians(angle / 2.0)) * 20), 1)


def anchor_raws(generator: torch.Generator, n: int, rotate_time: int, *,
                device) -> AnchorRaws:
    """Draw `AnchorRaws` for n weak pixels from ``generator``."""
    drj = 8 * rotate_time * len(_radius_schedule(RADIUS_BUDGET)) \
        * JITTER_SAMPLES
    sr = _shift_range(rotate_time)

    def shifts():
        return torch.randint(-sr + 1, sr, (n, drj), generator=generator,
                             device=device, dtype=torch.int32)
    return AnchorRaws(shifts(), shifts(), ransac_draws(generator, n,
                                                      device))


def ransac_draws(generator: torch.Generator, n: int, device
                 ) -> torch.Tensor:
    """(RANSAC_ITERS, n, 3) raw RANSAC draws in [0, 2^30)."""
    return torch.randint(0, 1 << 30, (RANSAC_ITERS, n, 3),
                         generator=generator, device=device,
                         dtype=torch.int32)


def _point_in_triangle(ax, ay, bx, by, cx, cy, px, py):
    """Reference PointinTriangle (APD.cu:122-143): degenerate edges (<= 2 px)
    and near-collinear triangles rejected; same-side cross-product test."""
    abx, aby = bx - ax, by - ay
    bcx, bcy = cx - bx, cy - by
    cax, cay = ax - cx, ay - cy
    ab = torch.sqrt(abx * abx + aby * aby)
    bc = torch.sqrt(bcx * bcx + bcy * bcy)
    ca = torch.sqrt(cax * cax + cay * cay)
    ok = (ab > 2) & (bc > 2) & (ca > 2)
    ok &= (ab + bc > ca) & (bc + ca > ab) & (ab + ca > bc)
    pax, pay = ax - px, ay - py
    pbx, pby = bx - px, by - py
    pcx, pcy = cx - px, cy - py
    t1 = pax * pby - pay * pbx
    t2 = pbx * pcy - pby * pcx
    t3 = pcx * pay - pcy * pax
    return ok & (t1 * t2 >= 0) & (t1 * t3 >= 0)


def _dot3(a, b):
    """Left-associated 3-term dot over the last axis."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


def _gather_rows(pts, idx):
    """pts (N, D, 3), idx (N,) -> (N, 3)."""
    return torch.gather(pts, 1, idx[:, None, None].expand(-1, 1, 3))[:, 0]


def _plane_from_triplet(pts, a_idx, b_idx, c_idx):
    """Unit plane (n, w) through three camera-frame points gathered from
    pts (N, D, 3); returns ((N, 4), degenerate mask)."""
    A = _gather_rows(pts, a_idx)
    B = _gather_rows(pts, b_idx)
    C = _gather_rows(pts, c_idx)
    u, v = A - C, B - C
    n = torch.stack([u[:, 1] * v[:, 2] - u[:, 2] * v[:, 1],
                     u[:, 2] * v[:, 0] - u[:, 0] * v[:, 2],
                     u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0]], -1)
    norm = torch.sqrt(_dot3(n, n))
    degenerate = (norm == 0) | ~torch.isfinite(norm)
    n = n / torch.clamp(norm, min=1e-20)[:, None]
    return torch.cat([n, -_dot3(n, A)[:, None]], -1), degenerate


def _take(v, idx):
    """v (N, D), idx (N,) -> v[i, idx[i]]."""
    return torch.gather(v, 1, idx[:, None])[:, 0]


def _nth_valid(mask, rank, n):
    """Index of the n-th (0-based) True entry of each row of ``mask``; 0
    where there is none."""
    return torch.argmax((mask & (rank == n[:, None])).to(torch.uint8), dim=-1)


def _plane_dist(pts, plane):
    """|n . p + w| of points (N, D, 3) against planes (N, 4) -> (N, D)."""
    return torch.abs(_dot3(pts, plane[:, None, :3]) + plane[:, None, 3])


def _cone_cos(rotate_time: int) -> float:
    """The cosine of a direction's acceptance half-angle."""
    return math.cos(math.radians(45.0 / rotate_time / 2.0))


def probe_table(h, w, nearest_strong, weak_x, weak_y, rotate_time,
                raws: AnchorRaws) -> tuple:
    """Every probe of every weak pixel, (n, D * Rn * J) each in the flat
    order (direction, radius, jitter), jitter innermost: whether its
    un-jittered test point lies in the (h, w) image, whether it is
    accepted, the nearest-strong pixel (sx, sy) it snaps to, and the flat
    index y * w + x of the map texel it reads (-1 where it reads none: its
    test point out of the image or the probe within MIN_MARGIN of an
    edge)."""
    xf = weak_x.to(torch.float32)
    yf = weak_y.to(torch.float32)
    dev = weak_x.device
    dirs_np = _direction_table(rotate_time)                   # (D, 2)
    D = dirs_np.shape[0]
    radii_np = _radius_schedule(RADIUS_BUDGET).astype(np.float32)
    Rn = radii_np.shape[0]
    J = JITTER_SAMPLES

    # flat probe layout: (direction, radius, jitter) with jitter innermost,
    # radius next — the reference's first-hit scan order
    flat = np.arange(D * Rn * J)
    d_of = flat // (Rn * J)
    r_of = (flat // J) % Rn
    dirx = torch.as_tensor(dirs_np[d_of, 0], device=dev)
    diry = torch.as_tensor(dirs_np[d_of, 1], device=dev)
    rad = torch.as_tensor(radii_np[r_of], device=dev)

    pdx = dirx * 20.0 + raws.shift_x.to(torch.float32)
    pdy = diry * 20.0 + raws.shift_y.to(torch.float32)
    pn = torch.clamp(torch.sqrt(pdx * pdx + pdy * pdy), min=1e-20)
    px = (xf[:, None] + pdx / pn * rad).to(torch.int32)
    py = (yf[:, None] + pdy / pn * rad).to(torch.int32)
    del pdx, pdy, pn

    # expansion stop: the un-jittered test point at this radius must be in
    # the image (a ray from an interior pixel leaves the convex image
    # monotonically, so the cumulative stop is a per-radius bounds test)
    tx = xf[:, None] + dirx * rad
    ty = yf[:, None] + diry * rad
    in_image = (tx >= 0) & (ty >= 0) & (tx < w) & (ty < h)
    del tx, ty
    probe_ok = in_image & (px >= MIN_MARGIN) & (py >= MIN_MARGIN) \
        & (px < w - MIN_MARGIN) & (py < h - MIN_MARGIN)
    texel = torch.where(probe_ok, py * w + px, -1)
    pxc = torch.clamp(px, min=0)
    pyc = torch.clamp(py, min=0)
    sx = fetch(nearest_strong[..., 0], pxc, pyc)
    sy = fetch(nearest_strong[..., 1], pxc, pyc)
    del px, py, pxc, pyc
    probe_ok &= (sx >= 0) & (sy >= 0)
    # angular cone acceptance against the ORIGIN direction
    vx = sx.to(torch.float32) - xf[:, None]
    vy = sy.to(torch.float32) - yf[:, None]
    vn = torch.clamp(torch.sqrt(vx * vx + vy * vy), min=1e-20)
    probe_ok &= (vx * dirx + vy * diry) / vn > _cone_cos(rotate_time)
    return in_image, probe_ok, sx, sy, texel


def gen_anchors_chunk_plain(cam, h, w, depth_map, nearest_strong, weak_x,
                            weak_y, rotate_time, ransac_threshold, depth_min,
                            depth_max, raws: AnchorRaws) -> AnchorResult:
    """K8's plain version: the anchors of one chunk of weak pixels as torch
    ops, every probe evaluated (``probe_table``)."""
    n = weak_x.shape[0]
    dev = weak_x.device
    xf = weak_x.to(torch.float32)
    yf = weak_y.to(torch.float32)
    D = 8 * rotate_time
    Rn = len(_radius_schedule(RADIUS_BUDGET))
    J = JITTER_SAMPLES
    _, probe_ok, sx, sy, _ = probe_table(h, w, nearest_strong, weak_x, weak_y,
                                      rotate_time, raws)

    # first accepted probe per direction (radius-major, then jitter order)
    flat_ok = probe_ok.reshape(n, D, Rn * J)
    first = torch.argmax(flat_ok.to(torch.uint8), dim=-1)[..., None]
    found = flat_ok.any(-1)                                    # (n, D)
    fx = torch.gather(sx.reshape(n, D, -1), -1, first)[..., 0]
    fy = torch.gather(sy.reshape(n, D, -1), -1, first)[..., 0]
    fx = torch.where(found, fx, -1)
    fy = torch.where(found, fy, -1)
    del probe_ok, flat_ok, sx, sy

    count = found.sum(-1)
    enough = count > 3

    # camera-frame 3-D points of the hits at their current stored depth
    hit_depth = fetch(depth_map, torch.clamp(fx, min=0),
                      torch.clamp(fy, min=0))
    pts = geo.backproject(cam, fx.to(torch.float32), fy.to(torch.float32),
                          hit_depth)                           # (n, D, 3)
    center_pt = geo.backproject(cam, xf, yf,
                                fetch(depth_map, weak_x, weak_y))
    depth_diff = depth_max - depth_min

    # RANSAC for a support plane through >= 6 hits whose triangle holds p
    rank = torch.cumsum(found.to(torch.int32), dim=-1) - 1
    fxf = fx.to(torch.float32)
    fyf = fy.to(torch.float32)
    best_count = torch.full((n,), 3, dtype=torch.int64, device=dev)
    best_cdist = torch.full((n,), torch.inf, device=dev)
    best_plane = torch.zeros((n, 4), device=dev)
    best_abc = torch.full((n, 3), -1, dtype=torch.int64, device=dev)
    has_plane = torch.zeros((n,), dtype=torch.bool, device=dev)
    cmax = torch.clamp(count, min=1)[:, None].to(torch.int32)
    for i in range(RANSAC_ITERS):
        ns = raws.triplets[i] % cmax
        a = _nth_valid(found, rank, ns[:, 0])
        b = _nth_valid(found, rank, ns[:, 1])
        c = _nth_valid(found, rank, ns[:, 2])
        distinct = (a != b) & (b != c) & (a != c)
        tri = _point_in_triangle(_take(fxf, a), _take(fyf, a),
                                 _take(fxf, b), _take(fyf, b),
                                 _take(fxf, c), _take(fyf, c), xf, yf)
        plane, degen = _plane_from_triplet(pts, a, b, c)
        inlier = found & (_plane_dist(pts, plane) / depth_diff
                          < ransac_threshold)
        n_in = inlier.sum(-1)
        usable = distinct & tri & ~degen & (n_in >= 6)
        cdist = torch.abs(_dot3(center_pt, plane[:, :3]) + plane[:, 3])
        better = usable & ((n_in > best_count)
                           | ((n_in == best_count) & (cdist < best_cdist)))
        best_plane = torch.where(better[:, None], plane, best_plane)
        best_cdist = torch.where(better, cdist, best_cdist)
        best_count = torch.where(better, n_in, best_count)
        best_abc = torch.where(better[:, None], torch.stack([a, b, c], -1),
                               best_abc)
        has_plane = has_plane | better

    # rank hits by plane distance (triangle members boosted by -1), keep 8
    dist = _plane_dist(pts, best_plane)
    is_inlier = found & (dist / depth_diff < ransac_threshold)
    is_abc = (torch.arange(D, device=dev)[None, :, None]
              == best_abc[:, None, :]).any(-1)
    weight = torch.where(is_inlier, dist - is_abc.to(torch.float32),
                         torch.inf)
    top = torch.argsort(weight, dim=-1, stable=True)[:, :ANCHOR_NUM - 1]
    ok = torch.isfinite(torch.gather(weight, -1, top))
    ax = torch.where(ok, torch.gather(fx, -1, top), -1)
    ay = torch.where(ok, torch.gather(fy, -1, top), -1)

    reliable = enough & has_plane
    rest = torch.stack([ax, ay], -1)
    rest = torch.where(reliable[:, None, None], rest, -1)
    anchors = torch.cat([torch.stack([weak_x, weak_y], -1)[:, None, :]
                         .to(rest.dtype), rest], 1).to(torch.int32)
    return AnchorResult(anchors=anchors, reliable=reliable,
                        hit_count=count.to(torch.int32))


def gen_anchors(data, state: PMState, weak_x, weak_y, rotate_time: int,
                ransac_threshold, depth_min, depth_max,
                nearest_strong: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                raws: Optional[AnchorRaws] = None,
                chunk: int = ANCHOR_CHUNK) -> AnchorResult:
    """Anchor generation for the compacted weak list (reference: GenAnchors).

    `state.planes[..., 3]` must hold depths (this op runs before the
    per-pass camera-frame conversion, as in the reference's kernel order,
    APD.cu:2685-2690). ``raws`` injects the jitter / RANSAC draws; without
    them they are drawn from ``generator``, chunk by chunk. The weak list
    is evaluated in chunks of ``chunk`` pixels; with injected draws the
    result does not depend on it."""
    dev = weak_x.device
    nw = weak_x.shape[0]
    f32 = [geo.f32_scalar(v, dev)
           for v in (ransac_threshold, depth_min, depth_max)]

    def run(wx, wy, r):
        return gen_anchors_chunk_plain(
            data.ref_cam, data.img_h, data.img_w, state.planes[..., 3],
            nearest_strong, wx, wy, rotate_time, *f32, r)
    parts = []
    for lo in range(0, nw, chunk):
        sl = slice(lo, min(lo + chunk, nw))
        if raws is None:
            r = anchor_raws(generator, sl.stop - lo, rotate_time, device=dev)
        else:
            r = AnchorRaws(raws.shift_x[sl], raws.shift_y[sl],
                           raws.triplets[:, sl])
        parts.append(run(weak_x[sl], weak_y[sl], r))
    if not parts:
        return AnchorResult(
            torch.zeros((0, ANCHOR_NUM, 2), dtype=torch.int32, device=dev),
            torch.zeros((0,), dtype=torch.bool, device=dev),
            torch.zeros((0,), dtype=torch.int32, device=dev))
    return AnchorResult(*(torch.cat(f) for f in zip(*parts)))


def neighbor_update(state: PMState, weak_x, weak_y, reliable) -> PMState:
    """Demote weak pixels that failed anchor generation to UNKNOWN
    (reference: NeigbourUpdate, APD.cu:2084-2100)."""
    h, w = state.weak.shape
    weak = state.weak.clone().reshape(-1)
    weak[weak_y.long() * w + weak_x.long()] = torch.where(
        reliable, WEAK, UNKNOWN).to(weak.dtype)
    return state.replace(weak=weak.reshape(h, w))


def ransac_fit_planes(data, state: PMState, weak_x, weak_y, anchors,
                      generator: Optional[torch.Generator] = None,
                      triplets: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Per-iteration support-plane fit from a weak pixel's anchors
    (reference: RANSACToGetFitPlane, APD.cu:2486-2598). Runs on
    camera-frame planes; returns (Nw, 4) fit planes (zeros when no fit).

    As in the JAX package, the reference's <3-anchors branch (emit the
    current plane, APD.cu:2525-2528) is not reproduced: every surviving
    WEAK pixel carries >= 6 anchors, so it never runs.

    ``triplets`` injects the (RANSAC_ITERS, Nw, 3) raw draws; without them
    they are drawn from ``generator``."""
    n = weak_x.shape[0]
    dev = weak_x.device
    if triplets is None:
        triplets = ransac_draws(generator, n, dev)
    return ransac_fit_planes_plain(data.ref_cam, state.planes, weak_x,
                                   weak_y, anchors, triplets)


def _length_f64(v) -> torch.Tensor:
    """|v| of (..., 3) f32 rounded once: sqrt((v0^2 + v1^2) + v2^2) in
    float64 (each square exact), then to float32."""
    d = v.to(torch.float64)
    return torch.sqrt(_dot3(d, d)).to(torch.float32)


def ransac_fit_planes_plain(cam, planes, weak_x, weak_y, anchors,
                            triplets) -> torch.Tensor:
    """K9's plain version: `ransac_fit_planes` as torch ops on the
    camera-frame ``planes`` (H, W, 4), every reduction that decides
    something in a fixed order."""
    n = weak_x.shape[0]
    dev = weak_x.device
    xf = weak_x.to(torch.float32)
    yf = weak_y.to(torch.float32)

    ax = anchors[:, 1:, 0]
    ay = anchors[:, 1:, 1]
    exists = (ax >= 0) & (ay >= 0)
    axf = ax.to(torch.float32)
    ayf = ay.to(torch.float32)
    a_planes = fetch(planes, torch.clamp(ax, min=0), torch.clamp(ay, min=0))
    pts = geo.backproject(cam, axf, ayf,
                          geo.depth_from_plane(cam, a_planes, axf, ayf))
    count = exists.sum(-1)
    enough = count >= 3
    rank = torch.cumsum(exists.to(torch.int32), dim=-1) - 1
    slots = torch.arange(ANCHOR_NUM - 1, device=dev)[None, :]
    cmax = torch.clamp(count, min=1)[:, None].to(torch.int32)

    best_cost = torch.full((n,), torch.inf, device=dev)
    best_plane = torch.zeros((n, 4), device=dev)
    has = torch.zeros((n,), dtype=torch.bool, device=dev)
    for i in range(RANSAC_ITERS):
        r = triplets[i] % cmax
        a = _nth_valid(exists, rank, r[:, 0])
        b = _nth_valid(exists, rank, r[:, 1])
        c = _nth_valid(exists, rank, r[:, 2])
        distinct = (a != b) & (b != c) & (a != c)
        tri = _point_in_triangle(_take(axf, a), _take(ayf, a),
                                 _take(axf, b), _take(ayf, b),
                                 _take(axf, c), _take(ayf, c), xf, yf)
        plane, degen = _plane_from_triplet(pts, a, b, c)
        others = exists & (slots != a[:, None]) & (slots != b[:, None]) \
            & (slots != c[:, None])
        terms = torch.where(others, _plane_dist(pts, plane), 0.0)
        # the other anchors' distances summed left to right
        cost = terms[:, 0]
        for k in range(1, ANCHOR_NUM - 1):
            cost = cost + terms[:, k]
        better = distinct & tri & ~degen & enough & (cost < best_cost)
        best_plane = torch.where(better[:, None], plane, best_plane)
        best_cost = torch.where(better, cost, best_cost)
        has = has | better

    # flip toward the camera (reference: APD.cu:2582-2594): against the
    # unit view direction, its length taken in float64
    depth = geo.depth_from_plane(cam, fetch(planes, weak_x, weak_y), xf, yf)
    view = geo.backproject(cam, xf, yf, depth)
    vd = view / _length_f64(view)[:, None]
    flip = _dot3(best_plane[:, :3], vd) > 0
    best_plane = torch.where(flip[:, None], -best_plane, best_plane)
    return torch.where(has[:, None], best_plane, 0.0)
