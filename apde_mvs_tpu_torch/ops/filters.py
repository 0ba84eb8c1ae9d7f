"""Post-sweep per-view ops: plane conversion, median filter, reliability
classification, confidence, local refine (reference: APD.cu:1694-2432).

DepthToWeak / LocalRefine evaluate NCC sweeps over all source views (the
selection-gated view weights zero out the unselected ones) for flat pixel
batches, so the pipeline can chunk full images. Each sweep of a batch is one
launch of the fused sweep kernel K5 (ops/cuda/sweep.py) on CUDA tensors, its
plain version on CPU tensors; the peak classification and the refine accept
rule run on its output.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import RELIABLE_CURVE_SAMPLE_NUM, STRONG, UNKNOWN, WEAK
from ..core import checkerboard as cb
from ..core import geometry as geo
from ..core.sampling import fetch, texel_fetch
from .cost import COST_MAX, CostData, contiguous_window, \
    precompute_ref_window
from .cuda import sweep as k5
from .state import PMState


def planes_to_depth_normal(data: CostData, planes: torch.Tensor
                           ) -> torch.Tensor:
    """Camera-frame plane hypotheses -> (world normal, depth-in-w)
    (reference: GetDepthandNormal, APD.cu:1694-1709)."""
    h, w, _ = planes.shape
    xs, ys = geo.pixel_grid(h, w, planes.device)
    depth = geo.depth_from_plane(data.ref_cam, planes, xs, ys)
    world = geo.normal_cam_to_world(data.ref_cam.R, planes)
    return torch.cat([world[..., :3], depth[..., None]], -1)


def depth_normal_to_planes(data: CostData, depth: torch.Tensor,
                           normal_world: torch.Tensor) -> torch.Tensor:
    """Inverse: (world normal, depth) maps -> camera-frame plane hypotheses
    (reference: RandomInitialization REFINE path, APD.cu:939-947)."""
    h, w = depth.shape
    xs, ys = geo.pixel_grid(h, w, depth.device)
    n4 = torch.cat([normal_world, depth[..., None]], -1)
    cam_n = geo.normal_world_to_cam(data.ref_cam.R, n4)
    wdist = geo.plane_dist_to_origin(data.ref_cam, xs, ys, depth,
                                     cam_n[..., :3])
    return torch.cat([cam_n[..., :3], wdist[..., None]], -1)


# Median-filter star neighborhood (reference: CheckerboardFilterStrong,
# APD.cu:1711-1821): center + 20 STRONG-gated neighbors.
_FILTER_OFFSETS = np.asarray([
    (0, -1), (0, -3), (0, -5), (0, 1), (0, 3), (0, 5),
    (-1, 0), (-3, 0), (-5, 0), (1, 0), (3, 0), (5, 0),
    (2, -1), (2, 1), (-2, -1), (-2, 1),
    (-1, -2), (1, -2), (-1, 2), (1, 2),
], np.int32)
_FILTER_Y_GT2 = np.zeros((len(_FILTER_OFFSETS),), bool)
_FILTER_Y_GT2[[16, 17]] = True   # (-1,-2) and (1,-2)


def _masked_median(vals: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Median over the valid entries along axis 0 (even count averages the
    two middles, as in the reference's sort_small + index math). Invalid
    entries sort last as +inf."""
    rows = torch.sort(torch.where(valid, vals, math.inf), dim=0).values
    n = valid.sum(0)
    mid = (n // 2)[None]
    lo = torch.gather(rows, 0, torch.clamp(mid - 1, min=0))[0]
    hi = torch.gather(rows, 0, torch.clamp(mid, max=rows.shape[0] - 1))[0]
    return torch.where(n % 2 == 0, 0.5 * (lo + hi), hi)


def median_filter_color(state: PMState, color: int) -> PMState:
    """One color's depth median filter. Runs on depth-in-w planes (post
    planes_to_depth_normal). Black then red, sequentially, as the reference
    launches them."""
    h, w = state.costs.shape
    dev = state.costs.device
    xs2, ys2 = cb.color_coords(h, w, color, device=dev)
    x = xs2.reshape(-1)
    y = ys2.reshape(-1)
    weak_c = cb.gather_color(state.weak, color).reshape(-1)
    cost_c = cb.gather_color(state.costs, color).reshape(-1)
    valid_c = cb.gather_color(state.valid, color).reshape(-1)
    active = (weak_c != WEAK) & (cost_c >= 0.001) & valid_c

    offs = torch.as_tensor(_FILTER_OFFSETS, device=dev)     # (T, 2)
    nx = x[None, :] + offs[:, 0:1]                          # (T, B) tap-major
    ny = y[None, :] + offs[:, 1:2]
    inb = (nx >= 0) & (nx < w) & (ny >= 0) & (ny < h)
    # reference quirk: the (-1,-2)/(1,-2) taps additionally require p.y > 2
    # (APD.cu:1798-1804), one row stricter than the bounds check
    strict = torch.as_tensor(_FILTER_Y_GT2, device=dev)[:, None]
    inb = inb & (~strict | (y[None, :] > 2))
    n_state = fetch(state.weak, nx, ny, fill=UNKNOWN)
    depth_map = state.planes[..., 3]
    ok = inb & (n_state == STRONG)
    center_d = fetch(depth_map, x, y)
    vals = torch.cat([center_d[None], fetch(depth_map, nx, ny)], 0)
    valid = torch.cat([torch.ones_like(ok[:1]), ok], 0)
    new_d = torch.where(active, _masked_median(vals, valid), center_d)
    half = cb.gather_color(state.planes, color)
    half = torch.cat([half[..., :3], new_d.reshape(h, w // 2, 1)], -1)
    return state.replace(planes=cb.scatter_color(state.planes, half, color))


def compute_confidence(data: CostData, state: PMState) -> PMState:
    """Cross-view consistency confidence (reference: ConfidenceCompute,
    APD.cu:2282-2344). Runs on depth-in-w planes."""
    h, w = state.costs.shape
    xs, ys = geo.pixel_grid(h, w, state.costs.device)
    xf = xs.reshape(-1)
    yf = ys.reshape(-1)
    depth = state.planes[..., 3].reshape(-1)
    sel = state.selected.reshape(-1, data.num_src)
    Xw = geo.backproject_world(data.ref_cam, xf, yf, depth)
    src = data.src_views
    sx, sy, _sd = geo.project(src, Xw)                          # (S, B)
    src_depth = texel_fetch(data.src_depths, sx, sy)
    exist = src_depth > 0.0
    Xs = geo.backproject_world(src, sx, sy, src_depth)
    bx, by, bd = geo.project(data.ref_cam, Xs)
    pix = torch.sqrt((xf - bx) ** 2 + (yf - by) ** 2)
    rel = torch.abs(depth - bd) / torch.clamp(depth, min=1e-20)
    score = torch.where(exist, 1.0 + 2.0 * (pix <= 2.0) + 2.0 * (rel <= 0.02),
                        0.0)
    conf = 1.0 + torch.where(sel, score.T, 0.0).sum(-1)
    conf = torch.clamp(conf, max=255.0).reshape(h, w)
    bad = depth.reshape(h, w) <= 0.0
    return state.replace(confidence=torch.where(bad, 0.0, conf),
                         weak=torch.where(bad, UNKNOWN, state.weak))


class _SweepScalars(NamedTuple):
    ok: torch.Tensor          # (B,) pixels with a usable setup
    plane_cam: torch.Tensor   # (B, 4) camera-frame normal, w = depth
    depth: torch.Tensor       # (B,)
    disp: torch.Tensor        # (B,) current disparity f*B/d
    base_line: torch.Tensor   # (B,)
    wnorm: torch.Tensor       # (B,)
    vw: torch.Tensor          # (B, S) selection-gated weights


def _sweep_scalars(data: CostData, state: PMState, x, y) -> _SweepScalars:
    """Per-pixel scalar setup shared by the disparity sweeps (reference:
    APD.cu:2121-2157, 2356-2401)."""
    plane_world = fetch(state.planes, x, y)
    plane_cam = geo.normal_world_to_cam(data.ref_cam.R, plane_world)
    depth = plane_cam[..., 3]
    sel = fetch(state.selected, x, y)
    vw = torch.where(sel, fetch(state.view_weights, x, y), 0.0)
    wnorm = vw.sum(-1)
    dists = torch.linalg.vector_norm(data.ref_cam.c[None, :]
                                     - data.src_cams.c, dim=-1)
    valid_src = sel.sum(-1)
    base_line = torch.where(sel, dists[None, :], 0.0).sum(-1) \
        / torch.clamp(valid_src, min=1)
    disp = data.ref_cam.fx * base_line / torch.where(depth != 0, depth, 1.0)
    ok = (depth != 0) & (valid_src > 0)
    return _SweepScalars(ok, plane_cam, depth, disp, base_line, wnorm, vw)


def _sweep(data: CostData, sc: _SweepScalars, xf, yf, win, *, refine: bool,
           geom: bool, geom_factor, depth_min, depth_max) -> torch.Tensor:
    """The batch's disparity sweep: one K5 call over every source view
    (reference: APD.cu:2159-2186, 2403-2416)."""
    px = k5.SweepPixels(xf.contiguous(), yf.contiguous(),
                        sc.plane_cam.contiguous(), sc.disp.contiguous(),
                        sc.base_line.contiguous(), sc.vw.contiguous(),
                        sc.wnorm.contiguous())
    return k5.sweep_fused(data, px, contiguous_window(win), refine=refine,
                          geom=geom, geom_factor=geom_factor,
                          depth_min=depth_min, depth_max=depth_max)


def depth_to_weak(data: CostData, state: PMState, x, y, weak_peak_radius,
                  geom: bool, geom_factor, depth_min, depth_max,
                  strong_radius=5, strong_increment=2,
                  return_curve: bool = False, use_sa: bool = False):
    """Reliability classification for a pixel batch (reference: DepthToWeak,
    APD.cu:2103-2250): sweep 61 one-pixel-disparity steps around the current
    depth, find cost-curve local minima ("peaks"), classify STRONG/WEAK/
    UNKNOWN. ``use_sa`` selects the SA star window where the pixel lies in
    a segment. Returns (new_weak (B,), curve (B, 61) or None)."""
    xf = x.to(torch.float32)
    yf = y.to(torch.float32)
    sc = _sweep_scalars(data, state, x, y)
    win = precompute_ref_window(data, xf, yf, strong_radius, strong_increment,
                                use_sa)
    curve = _sweep(data, sc, xf, yf, win, refine=False, geom=geom,
                   geom_factor=geom_factor, depth_min=depth_min,
                   depth_max=depth_max)                       # (B, 61)
    new_weak = _classify_peaks(data, state, x, y, curve, weak_peak_radius,
                               sc.ok)
    return new_weak, (curve if return_curve else None)


def _classify_peaks(data: CostData, state: PMState, x, y, curve,
                    weak_peak_radius, setup_ok) -> torch.Tensor:
    """STRONG/WEAK/UNKNOWN from a (B, 61) sweep cost curve: strict local
    minima ("peaks"), distance/cost/variance rules, margin guards
    (reference: DepthToWeak peak analysis, APD.cu:2188-2249)."""
    radius = (RELIABLE_CURVE_SAMPLE_NUM - 1) // 2
    min_margin = 6
    # peaks: strict local minima over i in [2, 58]
    left = curve[:, 1:-1]
    is_peak_inner = (curve[:, :-2] > left) & (curve[:, 2:] > left)
    idx_inner = torch.arange(1, RELIABLE_CURVE_SAMPLE_NUM - 1,
                             device=curve.device)
    in_range = (idx_inner >= 2) & (idx_inner <= RELIABLE_CURVE_SAMPLE_NUM - 3)
    is_peak = is_peak_inner & in_range[None, :]
    peak_count = is_peak.sum(-1)
    peak_costs = torch.where(is_peak, left, math.inf)
    best_inner = torch.argmin(peak_costs, -1)
    min_cost = torch.gather(peak_costs, 1, best_inner[:, None])[:, 0]
    # reference keeps min_peak=0 when no peak beats the initial 2.0
    has_min = min_cost < 2.0
    min_peak = torch.where(has_min, best_inner + 1, 0)
    min_cost = torch.where(has_min, min_cost, 2.0)

    far = (torch.abs(min_peak - radius) > weak_peak_radius) | (min_cost > 0.5)
    single = peak_count == 1
    single_strong = min_cost <= 0.15
    others = is_peak & (idx_inner[None, :] != min_peak[:, None])
    var = torch.sqrt(torch.where(others, (left - min_cost[:, None]) ** 2,
                                 0.0).sum(-1)) \
        / torch.clamp(peak_count - 1, min=1)
    multi_strong = var > 0.2

    new_weak = torch.where(
        far, WEAK,
        torch.where(single, torch.where(single_strong, STRONG, WEAK),
                    torch.where(multi_strong, STRONG, WEAK)))
    # guards: margins and degenerate setups -> UNKNOWN
    margin = (x < min_margin) | (y < min_margin) \
        | (x >= data.img_w - min_margin) | (y >= data.img_h - min_margin)
    invalid = margin | ~setup_ok | ~fetch(state.valid, x, y)
    return torch.where(invalid, UNKNOWN, new_weak).to(torch.int32)


def local_refine(data: CostData, state: PMState, x, y, geom: bool,
                 geom_factor, depth_min, depth_max, strong_radius=5,
                 strong_increment=2, use_sa: bool = False):
    """±5 one-pixel-disparity local depth sweep at fixed normal; replaces the
    depth when the cost improves by > 0.1 (reference: LocalRefine,
    APD.cu:2346-2432). ``use_sa`` as in `depth_to_weak`. Returns new depth
    values for the batch."""
    xf = x.to(torch.float32)
    yf = y.to(torch.float32)
    sc = _sweep_scalars(data, state, x, y)
    win = precompute_ref_window(data, xf, yf, strong_radius, strong_increment,
                                use_sa)
    costs = _sweep(data, sc, xf, yf, win, refine=True, geom=geom,
                   geom_factor=geom_factor, depth_min=depth_min,
                   depth_max=depth_max)                       # (B, 12)
    ok = sc.ok & (sc.wnorm > 0) & fetch(state.valid, x, y)
    return torch.where(ok, _refine_depths(data, sc, costs), sc.depth)


def _refine_depths(data: CostData, sc: _SweepScalars, costs) -> torch.Tensor:
    """LocalRefine's accept rule on K5's (B, 12) costs (the current depth's,
    then the 11 probes'): the reference's loop starts at COST_MAX and takes
    a probe only when strictly cheaper, so the first minimum wins and NaN
    never does; the best probe's depth replaces the current one when it
    improves the cost by > 0.1 (reference: APD.cu:2403-2430). Written as a
    leading COST_MAX column and argmin's first minimum."""
    cost_now = costs[:, 0]
    p_depth = k5.probe_depths(data.ref_cam.fx, sc.disp, sc.base_line,
                              k5.REFINE_OFFSETS)              # (B, 11)
    sweep = costs[:, 1:]
    sweep = torch.cat([torch.full_like(cost_now[:, None], COST_MAX),
                       torch.where(torch.isnan(sweep), math.inf, sweep)], 1)
    best = torch.argmin(sweep, 1, keepdim=True)
    min_cost = torch.gather(sweep, 1, best)[:, 0]
    best_depth = torch.gather(torch.cat([sc.depth[:, None], p_depth], 1), 1,
                              best)[:, 0]
    return torch.where((cost_now - min_cost) > 0.1, best_depth, sc.depth)
