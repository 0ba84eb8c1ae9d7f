"""The weak sweep as the port ran it before its kernels, kept as the one
witness that both the CPU tests and ``chip_smoke.py`` hold K6, K7 and their
plain versions against.

- ``weak_taps`` and ``ncc_weak`` are the deformable NCC of the old
  ``ops/deformable.py``, unchanged: each plane hypothesis warps the pixel,
  its centre window, its anchors and their sparse windows into all S views
  as torch ops, samples them with two K1 launches on the card (the (S, B,
  36) centre taps at site "weak_centre", the (S, B, 8, 9) anchor taps at
  "weak_anchor"), and combines them with ``cost.window_sums``,
  ``cost.ncc_from_sums`` and ``deformable._softmax_weighted``: ~575 torch
  ops a plane. ``weak_composition`` runs it for each of P planes, with the
  torch-op ``cost.geom_cost`` beside it, as ``propagation._weak_body`` did
  before K6. It differs from K6's plain version only in the order of its
  sums (torch's reductions against Kahan sums in tap order and ordered
  adds), so the two agree to float tolerance.
- ``weak_body_composition`` is the old ``propagation._weak_body`` before
  K7, unchanged: ``deformable.WeakRefData.build``, two K6 calls (the 10
  candidate planes against every view, the 5 probes against the weighted
  views), the selection of ``ops/selection.py`` and the view sums as
  ``.sum``: ~250 torch ops a chunk. It differs from K7's plain version only
  in the order of its sums (torch's reductions against ordered adds; the
  window sums and lengths), so the two agree to float tolerance, a pixel
  whose discrete choice sits on a float tie aside. Its arguments are
  ``_weak_body``'s; the depth bounds and the geometric factor are float32
  0-d tensors on the data's device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import STRONG
from ..core import geometry as geo
from ..core.sampling import bilinear_sample_packed, fetch
from ..ops import selection
from ..ops.cost import COST_MAX, GEOM_COST_MAX, CostData, geom_cost, \
    ncc_from_sums, square_taps, window_sums
from ..ops.deformable import WeakRefData, _softmax_weighted, \
    ncc_weak_planes
from ..ops.propagation import PropCfg, WeakDraws, last_min_index, \
    refinement_from_raws
from ..ops.state import PMState


class WeakTaps(NamedTuple):
    """One plane hypothesis per weak pixel warped into all S source views:
    the coordinates K1 samples and the out-of-image tests."""

    center_oob: torch.Tensor   # (S, B) the pixel leaves the image
    cwx: torch.Tensor          # (S, B, T) centre-window taps
    cwy: torch.Tensor
    anchor_oob: torch.Tensor   # (S, B, 8) the anchor leaves the image
    awx: torch.Tensor          # (S, B, 8, T') anchor-window taps
    awy: torch.Tensor


def weak_taps(data: CostData, wref: WeakRefData, plane, params) -> WeakTaps:
    """Warp the pixel, its centre window, its anchors and their sparse
    windows through the homographies of ``plane`` (B, 4)."""
    Hm = geo.homography(data.ref_cam, data.src_views, plane)   # (S, B, 3, 3)
    x, y = wref.x, wref.y
    cx, cy = geo.warp(Hm, x, y)                                 # (S, B)
    center_oob = (cx < 0) | (cx >= data.img_w) | (cy < 0) \
        | (cy >= data.img_h)
    win = wref.center_win
    cwx, cwy = geo.warp(Hm[..., None, :, :], x[:, None] + win.tap_dx,
                        y[:, None] + win.tap_dy)
    awx, awy = geo.warp(Hm[..., None, :, :], wref.anchor_x, wref.anchor_y)
    a_oob = (awx < 0) | (awx >= data.img_w) | (awy < 0) | (awy >= data.img_h)
    wk = torch.as_tensor(square_taps(params.weak_radius,
                                     params.weak_increment),
                         device=x.device).to(torch.float32)
    wx, wy = geo.warp(Hm[..., None, None, :, :],
                      wref.anchor_x[..., None] + wk[:, 0],
                      wref.anchor_y[..., None] + wk[:, 1])
    return WeakTaps(center_oob, cwx.contiguous(), cwy.contiguous(), a_oob,
                    wx.contiguous(), wy.contiguous())


def ncc_weak(data: CostData, wref: WeakRefData, plane, params
             ) -> torch.Tensor:
    """Multi-view deformable NCC cost vector (B, S) of one plane (B, 4) per
    weak pixel (reference: ComputeMultiViewCostVectorNew, APD.cu:809-818,
    over ComputeBilateralNCCNew for every view)."""
    t = weak_taps(data, wref, plane, params)

    # anchor 0 (the pixel) with the strong window: (S, B, T) taps
    win = wref.center_win
    csv = bilinear_sample_packed(data.src_quads, data.width, data.quad_h,
                                 t.cwx, t.cwy, site="weak_centre")
    center_cost = ncc_from_sums(win.sum_ref, win.sum_rr,
                                *window_sums(win.tap_w, win.tap_val, csv),
                                win.wsum)                       # (S, B)

    # anchors 1..8 with sparse windows: (S, B, 8, T') taps
    sv = bilinear_sample_packed(data.src_quads, data.width, data.quad_h,
                                t.awx, t.awy, site="weak_anchor")
    a_cost = ncc_from_sums(wref.sum_ref, wref.sum_rr,
                           *window_sums(wref.tap_w, wref.tap_val, sv),
                           wref.wsum)                           # (S, B, 8)

    # contribution rules (APD.cu:488-571): invalid anchors skip; anchors
    # whose warp leaves the image contribute COST_MAX iff that anchor
    # selected this source view; degenerate windows (wsum == 0) skip
    sel_here = wref.anchor_sel.permute(2, 0, 1)                 # (S, B, 8)
    computable = wref.anchor_valid & ~t.anchor_oob & (wref.wsum > 0)
    contrib = computable | (wref.anchor_valid & t.anchor_oob & sel_here)
    vals = torch.where(computable, a_cost, COST_MAX)
    strong_cost = _softmax_weighted(vals, contrib)
    cost = torch.where(contrib.any(-1),
                       0.25 * center_cost + 0.75 * strong_cost, center_cost)
    return torch.where(t.center_oob, COST_MAX, cost).T


def weak_composition(data: CostData, wref: WeakRefData, planes, params,
                     geom: bool = False):
    """The (B, P, S) deformable NCC costs of P planes (B, P, 4) a pixel, one
    ``ncc_weak`` a plane, and with ``geom`` the (B, P, S) geometric costs,
    one ``cost.geom_cost`` a plane: returns (costs, geometric costs or
    None)."""
    p = planes.shape[1]
    costs = torch.stack([ncc_weak(data, wref, planes[:, c], params)
                         for c in range(p)], 1)
    if not geom:
        return costs, None
    return costs, torch.stack([geom_cost(data, wref.x, wref.y,
                                         planes[:, c]) for c in range(p)], 1)


def weak_body_composition(data: CostData, state: PMState, cfg: PropCfg,
                          iteration, draws: WeakDraws, x, y, anchors,
                          fit_planes, depth_min, depth_max, geom_factor):
    """Anchor-candidate evaluation + fit-plane test + refinement for one
    flat batch of weak pixels (reference: CheckerboardPropagationWeak,
    APD.cu:1441-1615, and PlaneHypothesisRefinementWeak, :1008-1096).
    Returns (planes_out, costs_out, sel_new, vw). Two launches of the
    deformable NCC kernel K6 (`ops/cuda/weak.py`), with the geometric cost
    K4 inside when the pass is geometric: the 10 candidate planes (8 anchor
    candidates, the current plane, the fit plane) against every view, then
    the 5 refinement probes against the views the selection weights."""
    xf = x.to(torch.float32)
    yf = y.to(torch.float32)
    cam = data.ref_cam

    wref = WeakRefData.build(data, xf, yf, anchors, state.selected, cfg)

    a_x = anchors[:, 1:, 0]
    a_y = anchors[:, 1:, 1]
    exists = (a_x >= 0) & (a_y >= 0)
    a_xc = torch.clamp(a_x, min=0)
    a_yc = torch.clamp(a_y, min=0)
    flags = exists & (fetch(state.weak, a_xc, a_yc) == STRONG)
    cand_planes = fetch(state.planes, a_xc, a_yc)               # (B, 8, 4)
    cur_plane = fetch(state.planes, x, y)
    all_planes = torch.cat([cand_planes, cur_plane[:, None],
                            fit_planes[:, None]], 1)            # (B, 10, 4)
    geom = cfg.geom_consistency
    all_costs, gcosts = ncc_weak_planes(data, wref, all_planes, cfg,
                                        geom=geom)              # (B, 10, S)
    cost_array = torch.where(flags[..., None], all_costs[:, :8], 0.0)
    # C aggregate-init quirk (APD.cu:1464): a missing / non-strong anchor 0
    # leaves cost_array[0][0] = 2.0 (see the strong body)
    cost_array[:, 0, 0] = torch.where(flags[:, 0], cost_array[:, 0, 0], 2.0)

    # priors from all existing anchors (the reference gates only on -1)
    priors = selection.view_selection_priors(wref.anchor_sel, exists)
    probs = selection.sampling_probabilities(cost_array, priors, iteration)
    vw, temp_sel, wnorm = selection.monte_carlo_view_weights(draws.sel_u,
                                                             probs)
    has_views = wnorm > 0
    inv_norm = torch.where(has_views, 1.0 / torch.clamp(wnorm, min=1e-20),
                           0.0)

    # geometric consistency here has no impetus gate; an invalid candidate
    # pays the flat GEOM_COST_MAX (APD.cu:1556-1576, 1589-1599)
    if geom:
        total = cost_array + geom_factor * torch.where(
            flags[..., None], gcosts[:, :8], GEOM_COST_MAX)
        all_costs = all_costs[:, 8:] + geom_factor * gcosts[:, 8:]
    else:
        total = cost_array
        all_costs = all_costs[:, 8:]
    final_costs = (vw[:, None, :] * total).sum(-1) * inv_norm[:, None]
    cost_recomputed = torch.where(
        has_views, (vw * all_costs[:, 0]).sum(-1) * inv_norm, COST_MAX)

    best = last_min_index(final_costs)[:, None]
    best_plane = torch.gather(cand_planes, 1,
                              best[:, :, None].expand(-1, 1, 4))[:, 0]
    best_cost = torch.gather(final_costs, 1, best)[:, 0]
    best_flag = torch.gather(flags, 1, best)[:, 0]
    depth_before = geo.depth_from_plane(cam, best_plane, xf, yf)
    adopt = best_flag & (depth_before >= depth_min) \
        & (depth_before <= depth_max) & (best_cost < cost_recomputed) \
        & has_views
    plane_cur = torch.where(adopt[:, None], best_plane, cur_plane)
    cost_cur = torch.where(adopt, best_cost, cost_recomputed)
    sel_new = torch.where(adopt[:, None], temp_sel,
                          fetch(state.selected, x, y))

    # fit-plane test (reference: PlaneHypothesisRefinementWeak,
    # APD.cu:1026-1052)
    fit_ok = (fit_planes[:, :3] != 0.0).any(-1)
    fit_cost = (vw * all_costs[:, 1]).sum(-1) * inv_norm
    fit_depth = geo.depth_from_plane(cam, fit_planes, xf, yf)
    take_fit = fit_ok & (fit_depth >= depth_min) & (fit_depth <= depth_max) \
        & (fit_cost < cost_cur) & has_views
    plane_cur = torch.where(take_fit[:, None], fit_planes, plane_cur)
    cost_cur = torch.where(take_fit, fit_cost, cost_cur)

    # random refinement, weighted over the Monte-Carlo-voted views
    depth_cur = geo.depth_from_plane(cam, plane_cur, xf, yf)
    r_depths, r_normals = refinement_from_raws(
        draws.raws, cam, xf, yf, plane_cur, depth_cur, depth_min, depth_max)
    r_planes = torch.stack([
        geo.make_plane(cam, xf, yf, r_depths[:, i], r_normals[:, i])
        for i in range(5)], 1)                                  # (B, 5, 4)
    # only the weighted views: the others weigh 0 in every use of the costs
    cvs, gvs = ncc_weak_planes(data, wref, r_planes, cfg, geom=geom,
                               view_weights=vw)                 # (B, 5, S)
    if geom:
        cvs = cvs + geom_factor * gvs
    r_costs = []
    for i in range(5):
        d_i = geo.depth_from_plane(cam, r_planes[:, i], xf, yf)
        ok = (d_i >= depth_min) & (d_i <= depth_max) & has_views
        r_costs.append(torch.where(ok, (vw * cvs[:, i]).sum(-1) * inv_norm,
                                   math.inf))
    r_costs = torch.stack(r_costs, 1)                           # (B, 5)
    r_best = torch.argmin(r_costs, -1)[:, None]
    r_cost = torch.gather(r_costs, 1, r_best)[:, 0]
    r_plane = torch.gather(r_planes, 1,
                           r_best[:, :, None].expand(-1, 1, 4))[:, 0]
    # PlaneHypothesisRefinementWeak returns EARLY when the fit plane is all
    # zeros (APD.cu:1029-1032): a weak pixel without a RANSAC fit gets
    # neither the fit test nor random refinement
    take_ref = (r_cost < cost_cur) & fit_ok
    plane_cur = torch.where(take_ref[:, None], r_plane, plane_cur)
    cost_cur = torch.where(take_ref, r_cost, cost_cur)

    if cfg.refine_init:
        commit = cost_cur < cost_recomputed - 0.1
        return (torch.where(commit[:, None], plane_cur, cur_plane),
                torch.where(commit, cost_cur, cost_recomputed), sel_new, vw)
    return plane_cur, cost_cur, sel_new, vw
