"""K3's plain version: the strong checkerboard sweep's colour update.

For each pixel of one colour's flat batch: the 8 adaptive-region
candidates, K2's strong NCC of each against every source view, the joint
view selection (neighbour priors, sampling probabilities, 15 Monte-Carlo
samples from the injected uniforms), the adoption of the best candidate,
the 5 refinement hypotheses from the injected draws, each costed over the
selected views (with the geometric cost when it is on), and the
REFINE_INIT commit (`strong_plain`); `commit_maps_plain` writes the active
pixels' (not WEAK, valid) outputs into fresh copies of the state's maps.

Every operation's order is fixed: the window of ``cost.ref_window_taps``
with its sums in tap order (`window_plain`), K2's plain NCC, ``cost.geom_cost``'s torch ops, the
selection of ``selection.ordered_*``, every view sum as ordered adds over
s = 0 .. S-1, the hypotheses' norms and dot products written out x, y, z,
every division a true one between tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ...config import WEAK
from ...core import geometry as geo
from ...core.sampling import fetch
from .. import selection
from ..cost import COST_MAX, RefWindow, geom_cost, ref_window_taps
from . import ncc
from .sweep import _f32


NUM_HYPOTHESES = 5


class StrongOutputs(NamedTuple):
    """A colour update's per-pixel outputs."""

    planes: torch.Tensor     # (B, 4)
    costs: torch.Tensor      # (B,)
    selected: torch.Tensor   # (B, S) bool
    view_weights: torch.Tensor   # (B, S) f32 counts


def ordered_sum(v: torch.Tensor) -> torch.Tensor:
    """sum_t v[..., t], added in order from +0."""
    acc = torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    for t in range(v.shape[-1]):
        acc = acc + v[..., t]
    return acc


def window_plain(data, x, y, radius: int, increment: int,
                 use_sa: bool) -> RefWindow:
    """The reference window of pixels (x, y) f32: the taps, weights and
    values of ``cost.ref_window_taps``, its sums taken in tap order."""
    dx, dy, val, w = ref_window_taps(data, x, y, radius, increment, use_sa)
    wv = val if w is None else w * val
    return RefWindow(dx, dy, val, ordered_sum(wv), ordered_sum(wv * val),
                     float(dx.shape[0]) if w is None else w.sum(-1), w)


def weighted_sum(vw: torch.Tensor, costs: torch.Tensor) -> torch.Tensor:
    """sum_s vw[..., s] * costs[..., s], added in view order from 0."""
    acc = torch.zeros(torch.broadcast_shapes(vw.shape, costs.shape)[:-1],
                      dtype=torch.float32, device=costs.device)
    for s in range(costs.shape[-1]):
        acc = acc + vw[..., s] * costs[..., s]
    return acc


def plane_costs_plain(data, x, y, plane, win, geom: bool,
                      geom_factor) -> torch.Tensor:
    """(B, S) costs of ``plane`` at pixels (x, y) f32: K2's NCC, plus
    ``geom_factor`` times the geometric cost with ``geom``."""
    cv = ncc.ncc_strong_plain(data, x, y, plane, win)
    if geom:
        cv = cv + geom_factor * geom_cost(data, x, y, plane)
    return cv


def candidate_costs_plain(data, state, x, y, win, row_bounds=None):
    """The candidates' (B, 8, 4) planes, (B, 8) region flags and (B, 8, S)
    cost array: K2's NCC of each candidate, 0 on an invalid region's row
    but 2 at [0][0] when region 0 is invalid (``float cost_array[8][32] =
    {2.0f}``, APD.cu:1120)."""
    from ..propagation import checkerboard_candidates
    cand_x, cand_y, flags = checkerboard_candidates(state.costs, x, y,
                                                    row_bounds)
    planes = fetch(state.planes, cand_x, cand_y)
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    costs = torch.stack([ncc.ncc_strong_plain(data, xf, yf, planes[:, c], win)
                         for c in range(8)], 1)
    costs = torch.where(flags[..., None], costs, 0.0)
    costs[:, 0, 0] = torch.where(flags[:, 0], costs[:, 0, 0], 2.0)
    return planes, flags, costs


def select_views_plain(state, x, y, flags, cost_array, sel_u, iteration):
    """(vw, temporary selection, wnorm): the 0.9 / 0.1 votes of the
    neighbours (x, y -+ 1), (x -+ 1, y), valid by regions 0, 2, 4, 6, the
    sampling probabilities and the 15 Monte-Carlo samples, every sum in its
    fixed order."""
    nb_sel = fetch(state.selected, torch.stack([x, x, x - 1, x + 1], -1),
                   torch.stack([y - 1, y + 1, y, y], -1))       # (B, 4, S)
    priors = selection.ordered_priors(nb_sel, flags[:, [0, 2, 4, 6]])
    probs = selection.ordered_probabilities(
        cost_array, priors, *selection.selection_thresholds(iteration))
    return selection.ordered_view_weights(sel_u, probs)


def _dot(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def _norm(v) -> torch.Tensor:
    """The length of the 3-vector ``v`` (a sequence of f32 tensors), rounded
    once: sqrt((v0^2 + v1^2) + v2^2) in float64 (each square exact), then
    to float32. A float32 sum of the squares lands an ulp off the correctly
    rounded length often enough to flip the choice between two nearly equal
    hypotheses against the JAX package and the reference oracle."""
    d = [c.to(torch.float64) for c in v]
    return torch.sqrt(_dot(d, d)).to(torch.float32)


def _normalized(v, floor: Optional[float]):
    """v / |v|, the norm clamped below at ``floor`` unless it is None."""
    norm = _norm(v)
    if floor is not None:
        norm = torch.clamp(norm, min=floor)
    return [c / norm for c in v]


def refinement_planes_plain(raws, cam, x, y, plane_cur, depth_cur, depth_min,
                            depth_max) -> torch.Tensor:
    """The (B, 5, 4) planes of ``propagation.refinement_from_raws``'
    (depth, normal) pairs, with the norms and dot products written out."""
    fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
    d_rand = torch.maximum(depth_min,
                           raws.u_rand * (depth_max - depth_min) + depth_min)
    # the Gaussian's direction, flipped to face the camera
    n_rand = _normalized(raws.g.unbind(-1), 1e-12)
    view_dir = _normalized(((depth_cur * (x - cx)) / fx,
                            (depth_cur * (y - cy)) / fy, depth_cur), None)
    flip = _dot(n_rand, view_dir) > 0
    n_rand = [torch.where(flip, -c, c) for c in n_rand]
    # the depth perturbed by up to +-2%
    lo = 0.98 * depth_cur
    d_pert = torch.maximum(lo, raws.u_pert * (1.02 * depth_cur - lo) + lo)
    # the current normal rotated by the Euler angles, kept where the
    # rotated one would face away from the camera
    s1, s2, s3 = torch.sin(raws.angles).unbind(-1)
    c1, c2, c3 = torch.cos(raws.angles).unbind(-1)
    rot = ((c2 * c3, c3 * s1 * s2 - c1 * s3, s1 * s3 + c1 * c3 * s2),
           (c2 * s3, c1 * c3 + s1 * s2 * s3, c1 * s2 * s3 - c3 * s1),
           (-s2, c2 * s1, c1 * c2))
    n_cur = plane_cur.unbind(-1)[:3]
    n_pert = [_dot(row, n_cur) for row in rot]
    unit_dir = _normalized(((x - cx) / fx, (y - cy) / fy,
                            torch.ones_like(x)), None)
    away = _dot(n_pert, unit_dir) >= 0
    n_pert = _normalized([torch.where(away, a, b)
                          for a, b in zip(n_cur, n_pert)], 1e-12)
    planes = []
    for depth, n in ((d_rand, n_cur), (depth_cur, n_rand), (d_rand, n_rand),
                     (depth_cur, n_pert), (d_pert, n_cur)):
        X = (depth * (x - cx)) / fx
        Y = (depth * (y - cy)) / fy
        w = -((n[0] * X + n[1] * Y) + n[2] * depth)
        planes.append(torch.stack([*n, w], -1))
    return torch.stack(planes, 1)


def adopt_plain(cam, x, y, cand_planes, flags, final_costs, cost_recomputed,
                has_views, depth_min, depth_max):
    """(adopt (B,) bool, best plane (B, 4), its cost (B,)): the last minimum
    of the (B, 8) weighted candidate costs (FindMinCostIndex's <=,
    APD.cu:60-71), adopted only where its region is valid, its depth lies
    in range, its cost is below ``cost_recomputed`` and the pixel has views.
    An invalid region's 0 can win and so block the adoption."""
    from ..propagation import last_min_index
    best = last_min_index(final_costs)[:, None]
    best_plane = torch.gather(cand_planes, 1,
                              best[:, :, None].expand(-1, 1, 4))[:, 0]
    best_cost = torch.gather(final_costs, 1, best)[:, 0]
    depth = geo.depth_from_plane(cam, best_plane, x, y)
    adopt = torch.gather(flags, 1, best)[:, 0] & (depth >= depth_min) \
        & (depth <= depth_max) & (best_cost < cost_recomputed) & has_views
    return adopt, best_plane, best_cost


def refine_choice(r_costs, r_planes, plane_cur, cost_cur):
    """The first minimum of the (B, 5) hypotheses' costs, taken where it is
    below ``cost_cur``: (plane, cost)."""
    r_best = torch.argmin(r_costs, -1)[:, None]
    r_cost = torch.gather(r_costs, 1, r_best)[:, 0]
    r_plane = torch.gather(r_planes, 1,
                           r_best[:, :, None].expand(-1, 1, 4))[:, 0]
    take = r_cost < cost_cur
    return (torch.where(take[:, None], r_plane, plane_cur),
            torch.where(take, r_cost, cost_cur))


def commit_plain(plane_cur, cost_cur, cur_plane, cost_recomputed,
                 refine_init: bool):
    """(plane, cost) a pixel keeps: under REFINE_INIT the new ones only on
    an improvement of more than 0.1 (APD.cu:1430-1439)."""
    if not refine_init:
        return plane_cur, cost_cur
    commit = cost_cur < cost_recomputed - 0.1
    return (torch.where(commit[:, None], plane_cur, cur_plane),
            torch.where(commit, cost_cur, cost_recomputed))


def strong_plain(data, state, x, y, draws, *, radius, increment, use_sa,
                 iteration, depth_min, depth_max, geom_factor, geom: bool,
                 refine_init: bool, row_bounds=None) -> StrongOutputs:
    """The colour update of pixels (x, y) int32 as torch ops, in the
    kernel's operation order."""
    dev = x.device
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    cam = data.ref_cam
    win = window_plain(data, xf, yf, radius, increment, use_sa)
    dmin, dmax, gf = (geo.f32_scalar(_f32(v), dev)
                      for v in (depth_min, depth_max, geom_factor))

    cand_planes, flags, cost_array = candidate_costs_plain(
        data, state, x, y, win, row_bounds)
    cur_plane = fetch(state.planes, x, y)
    vw, temp_sel, wnorm = select_views_plain(state, x, y, flags, cost_array,
                                             draws.sel_u, iteration)
    has_views = wnorm > 0
    inv_norm = torch.where(has_views, torch.ones_like(wnorm)
                           / torch.clamp(wnorm, min=1e-20), 0.0)

    def weighted_cost(plane):
        return weighted_sum(vw, plane_costs_plain(data, xf, yf, plane, win,
                                                  geom, gf)) * inv_norm

    final_costs = weighted_sum(vw[:, None, :], cost_array) \
        * inv_norm[:, None]
    cost_recomputed = torch.where(has_views, weighted_cost(cur_plane),
                                  COST_MAX)
    adopt, best_plane, best_cost = adopt_plain(
        cam, xf, yf, cand_planes, flags, final_costs, cost_recomputed,
        has_views, dmin, dmax)
    plane_cur = torch.where(adopt[:, None], best_plane, cur_plane)
    cost_cur = torch.where(adopt, best_cost, cost_recomputed)
    sel_new = torch.where(adopt[:, None], temp_sel,
                          fetch(state.selected, x, y))

    depth_cur = geo.depth_from_plane(cam, plane_cur, xf, yf)
    r_planes = refinement_planes_plain(draws.raws, cam, xf, yf, plane_cur,
                                       depth_cur, dmin, dmax)
    r_costs = []
    for i in range(NUM_HYPOTHESES):
        plane_i = r_planes[:, i]
        d_i = geo.depth_from_plane(cam, plane_i, xf, yf)
        ok = (d_i >= dmin) & (d_i <= dmax) & has_views
        r_costs.append(torch.where(ok, weighted_cost(plane_i), math.inf))
    plane_cur, cost_cur = refine_choice(torch.stack(r_costs, 1), r_planes,
                                        plane_cur, cost_cur)
    plane_cur, cost_cur = commit_plain(plane_cur, cost_cur, cur_plane,
                                       cost_recomputed, refine_init)
    return StrongOutputs(plane_cur, cost_cur, sel_new, vw)


def commit_maps_plain(state, x, y, out: StrongOutputs) -> StrongOutputs:
    """The commit of a colour update's outputs ``out`` for pixels (x, y):
    fresh copies of the state's planes, costs, selections and view weights
    with ``out`` written at the active pixels (weak state not WEAK, valid),
    as ``propagation.propagate_strong``'s ``put`` writes them; every other
    cell keeps its value."""
    active = (fetch(state.weak, x, y) != WEAK) & fetch(state.valid, x, y)
    cells = y.long() * state.costs.shape[1] + x.long()

    def put(full, vals):
        new = full.clone()
        flat = new.view((-1,) + tuple(full.shape[2:]))
        keep = active.reshape(active.shape + (1,) * (vals.ndim - 1))
        flat[cells] = torch.where(keep, vals, flat[cells])
        return new
    return StrongOutputs(put(state.planes, out.planes),
                         put(state.costs, out.costs),
                         put(state.selected, out.selected),
                         put(state.view_weights, out.view_weights))
