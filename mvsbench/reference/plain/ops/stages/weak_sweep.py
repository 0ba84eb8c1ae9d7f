"""K7's plain version: the weak sweep's chunk update.

For each weak pixel of a chunk: the reference side of its deformable NCC
(the centre window and its 8 anchors' sparse windows,
``weak.weak_ref_plain``), the 10 plane slots (the 8 anchor candidates,
the current plane, the fit plane) against every view through K6's plain
deformable NCC (with the geometric cost when the pass is geometric), the
joint view selection (the existing anchors' priors, the sampling
probabilities, 15 Monte-Carlo samples from the injected uniforms), the
adoption of the best candidate, the fit-plane test, the 5 refinement
hypotheses from the injected draws costed over the selected views, and
the REFINE_INIT commit. Every operation's order is fixed: the selection
of ``selection.ordered_*``, every view sum as ordered adds over s = 0 ..
S-1, K3's plain adoption and hypotheses (``strong.adopt_plain``,
``strong.refinement_planes_plain``), every division a true one between
tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ...config import STRONG
from ...core import geometry as geo
from ...core.sampling import fetch
from .. import selection
from ..cost import COST_MAX, GEOM_COST_MAX
from . import strong, weak
from .strong import weighted_sum
from .sweep import _f32
from .weak import WeakRefData, weak_ref_plain


class WeakOutputs(NamedTuple):
    """A weak-sweep chunk's per-pixel outputs."""

    planes: torch.Tensor     # (B, 4)
    costs: torch.Tensor      # (B,)
    selected: torch.Tensor   # (B, S) bool
    view_weights: torch.Tensor   # (B, S) f32 counts


ANCHORS = 8      # a weak pixel's anchors


class WeakStage(NamedTuple):
    """What a chunk's update holds before its refinement probes are costed:
    the reference side, the anchors' masks, the selection, the adopted or
    fitted plane and cost, and the 5 hypotheses of that plane."""

    wref: WeakRefData
    exists: torch.Tensor         # (B, 8) the anchor exists
    flags: torch.Tensor          # (B, 8) ... and is STRONG
    cur_plane: torch.Tensor      # (B, 4) the state's plane at the pixel
    vw: torch.Tensor             # (B, S) view weights
    sel_new: torch.Tensor        # (B, S) the selection the pixel keeps
    inv_norm: torch.Tensor       # (B,) 1 / wnorm, 0 without views
    has_views: torch.Tensor      # (B,)
    cost_recomputed: torch.Tensor    # (B,) the current plane's cost
    fit_ok: torch.Tensor         # (B,) the fit plane has a normal
    plane_cur: torch.Tensor      # (B, 4) after the adoption and fit test
    cost_cur: torch.Tensor       # (B,)
    hypotheses: torch.Tensor     # (B, 5, 4) refinement planes of plane_cur
    scalars: tuple               # depth_min, depth_max, geom_factor (0-d)


def weak_stage_plain(data, state, x, y, anchors, fit_planes, draws, *,
                     strong_radius: int, strong_increment: int,
                     weak_radius: int, weak_increment: int, use_sa: bool,
                     iteration, depth_min, depth_max, geom_factor,
                     geom: bool) -> WeakStage:
    """The chunk update of weak pixels (x, y) int32 as torch ops, in the
    kernel's operation order, up to the refinement hypotheses: the
    reference side, the 10 slots' costs (phase 0), the selection, the
    adoption and the fit-plane test."""
    dev = x.device
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    cam = data.ref_cam
    dmin, dmax, gf = (geo.f32_scalar(_f32(v), dev)
                      for v in (depth_min, depth_max, geom_factor))
    wref = weak_ref_plain(data, xf, yf, anchors, state.selected,
                          strong_radius, strong_increment, weak_radius,
                          weak_increment, use_sa)

    # the anchors: `exists` gates the priors, `flags` the cost array and
    # the adoption (wref.anchor_valid, the NCC)
    ax, ay = anchors[:, 1:, 0], anchors[:, 1:, 1]
    exists = (ax >= 0) & (ay >= 0)
    axc, ayc = torch.clamp(ax, min=0), torch.clamp(ay, min=0)
    flags = exists & (fetch(state.weak, axc, ayc) == STRONG)
    cand_planes = fetch(state.planes, axc, ayc)                # (B, 8, 4)
    cur_plane = fetch(state.planes, x, y)
    all_planes = torch.cat([cand_planes, cur_plane[:, None],
                            fit_planes[:, None]], 1).contiguous()
    costs, gcosts = weak.weak_plain(data, wref, all_planes, weak_radius,
                                    weak_increment, geom=geom)
    cost_array = torch.where(flags[..., None], costs[:, :ANCHORS], 0.0)
    # C aggregate-init quirk (APD.cu:1464): an unflagged anchor 0 leaves
    # cost_array[0][0] = 2.0
    cost_array[:, 0, 0] = torch.where(flags[:, 0], cost_array[:, 0, 0], 2.0)

    priors = selection.ordered_priors(wref.anchor_sel, exists)
    probs = selection.ordered_probabilities(
        cost_array, priors, *selection.selection_thresholds(iteration))
    vw, temp_sel, wnorm = selection.ordered_view_weights(draws.sel_u, probs)
    has_views = wnorm > 0
    inv_norm = torch.where(has_views, torch.ones_like(wnorm)
                           / torch.clamp(wnorm, min=1e-20), 0.0)

    # the geometric cost has no impetus gate here; an unflagged candidate
    # pays the flat GEOM_COST_MAX (APD.cu:1556-1576, 1589-1599)
    if geom:
        total = cost_array + gf * torch.where(flags[..., None],
                                              gcosts[:, :ANCHORS],
                                              GEOM_COST_MAX)
        own = costs[:, ANCHORS:] + gf * gcosts[:, ANCHORS:]
    else:
        total, own = cost_array, costs[:, ANCHORS:]
    final_costs = weighted_sum(vw[:, None, :], total) * inv_norm[:, None]
    cost_recomputed = torch.where(
        has_views, weighted_sum(vw, own[:, 0]) * inv_norm, COST_MAX)
    adopt, best_plane, best_cost = strong.adopt_plain(
        cam, xf, yf, cand_planes, flags, final_costs, cost_recomputed,
        has_views, dmin, dmax)
    plane_cur = torch.where(adopt[:, None], best_plane, cur_plane)
    cost_cur = torch.where(adopt, best_cost, cost_recomputed)
    sel_new = torch.where(adopt[:, None], temp_sel,
                          fetch(state.selected, x, y))

    # the fit-plane test (PlaneHypothesisRefinementWeak, APD.cu:1026-1052)
    fit_ok = (fit_planes[:, :3] != 0.0).any(-1)
    fit_cost = weighted_sum(vw, own[:, 1]) * inv_norm
    fit_depth = geo.depth_from_plane(cam, fit_planes, xf, yf)
    take_fit = fit_ok & (fit_depth >= dmin) & (fit_depth <= dmax) \
        & (fit_cost < cost_cur) & has_views
    plane_cur = torch.where(take_fit[:, None], fit_planes, plane_cur)
    cost_cur = torch.where(take_fit, fit_cost, cost_cur)

    depth_cur = geo.depth_from_plane(cam, plane_cur, xf, yf)
    hypotheses = strong.refinement_planes_plain(draws.raws, cam, xf, yf,
                                                plane_cur, depth_cur, dmin,
                                                dmax)
    return WeakStage(wref, exists, flags, cur_plane, vw, sel_new, inv_norm,
                     has_views, cost_recomputed, fit_ok, plane_cur, cost_cur,
                     hypotheses, (dmin, dmax, gf))


def weak_update_plain(data, state, x, y, anchors, fit_planes, draws, *,
                      strong_radius: int, strong_increment: int,
                      weak_radius: int, weak_increment: int, use_sa: bool,
                      iteration, depth_min, depth_max, geom_factor,
                      geom: bool, refine_init: bool) -> WeakOutputs:
    """The chunk update of weak pixels (x, y) int32 as torch ops, in the
    kernel's operation order: `weak_stage_plain`, then the hypotheses
    costed over the weighted views (phase 1), the first minimum taken where
    lower and the fit plane has a normal (no refinement without a fit: the
    early return at APD.cu:1029-1032), and the commit."""
    st = weak_stage_plain(
        data, state, x, y, anchors, fit_planes, draws,
        strong_radius=strong_radius, strong_increment=strong_increment,
        weak_radius=weak_radius, weak_increment=weak_increment,
        use_sa=use_sa, iteration=iteration, depth_min=depth_min,
        depth_max=depth_max, geom_factor=geom_factor, geom=geom)
    dmin, dmax, gf = st.scalars
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    pc, pg = weak.weak_plain(data, st.wref, st.hypotheses, weak_radius,
                             weak_increment, geom=geom, view_weights=st.vw)
    if geom:
        pc = pc + gf * pg
    r_costs = []
    for i in range(strong.NUM_HYPOTHESES):
        d_i = geo.depth_from_plane(data.ref_cam, st.hypotheses[:, i], xf, yf)
        ok = (d_i >= dmin) & (d_i <= dmax) & st.has_views
        r_costs.append(torch.where(
            ok, weighted_sum(st.vw, pc[:, i]) * st.inv_norm, math.inf))
    r_costs = torch.stack(r_costs, 1)
    r_best = torch.argmin(r_costs, -1)[:, None]
    r_cost = torch.gather(r_costs, 1, r_best)[:, 0]
    r_plane = torch.gather(st.hypotheses, 1,
                           r_best[:, :, None].expand(-1, 1, 4))[:, 0]
    take = (r_cost < st.cost_cur) & st.fit_ok
    plane_cur = torch.where(take[:, None], r_plane, st.plane_cur)
    cost_cur = torch.where(take, r_cost, st.cost_cur)
    plane_cur, cost_cur = strong.commit_plain(plane_cur, cost_cur,
                                              st.cur_plane,
                                              st.cost_recomputed, refine_init)
    return WeakOutputs(plane_cur, cost_cur, st.sel_new, st.vw)
