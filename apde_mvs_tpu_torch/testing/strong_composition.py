"""The strong sweep's colour update as the port ran it before K3, kept as the
one witness that both the CPU tests and ``chip_smoke.py`` hold K3 and its
plain version against.

``strong_composition`` is the old ``propagation._strong_body``, unchanged:
one ``cost.ncc_strong`` call (a K2 launch on the card) for each of the 8
candidates, the current plane and the 5 refinement hypotheses, the
geometric cost's torch ops, the selection of ``ops/selection.py`` and the
view sums as ``.sum``. It differs from K3's plain version only in the order
of its sums and norms (torch's reductions), so the two agree to float
tolerance, a pixel whose discrete choice sits on a float tie aside.
Its arguments are ``_strong_body``'s; the depth bounds and the geometric
factor are float32 0-d tensors on the data's device.

``put_composition`` is the commit as ``propagation.propagate_strong`` ran
it before K3 wrote it: a fetch, a where and a scatter a map. It is the
witness that K3's plain commit (``strong.commit_maps_plain``) is held to,
bit for bit, and what ``chip_smoke.py`` times K3's commit form against.
"""

from __future__ import annotations

import math

import torch

from ..config import WEAK
from ..core import checkerboard as cb
from ..core import geometry as geo
from ..core.sampling import fetch
from ..ops import selection
from ..ops.cost import COST_MAX, CostData, geom_cost, ncc_strong, \
    precompute_ref_window
from ..ops.propagation import PropCfg, SweepDraws, checkerboard_candidates, \
    last_min_index, refinement_from_raws
from ..ops.state import PMState


def strong_composition(data: CostData, state: PMState, cfg: PropCfg,
                       iteration, draws: SweepDraws, x, y, depth_min,
                       depth_max, geom_factor, row_bounds=None):
    """Candidate evaluation + view selection + refinement for one flat batch
    of same-color pixels. Returns (planes_out, costs_out, sel_new, vw).
    Each plane hypothesis (8 candidates, the current plane, 5 refinement
    probes) is one all-views `ncc_strong`: 14 K2 launches."""
    xf = x.to(torch.float32)
    yf = y.to(torch.float32)
    cam = data.ref_cam

    cand_x, cand_y, flags = checkerboard_candidates(state.costs, x, y,
                                                    row_bounds)
    cand_planes = fetch(state.planes, cand_x, cand_y)          # (B, 8, 4)
    cur_plane = fetch(state.planes, x, y)

    win = precompute_ref_window(data, xf, yf, cfg.strong_radius,
                                cfg.strong_increment, cfg.use_sa)
    cost_array = torch.stack([ncc_strong(data, xf, yf, cand_planes[:, c], win,
                                         site="strong")
                              for c in range(8)], dim=1)        # (B, 8, S)
    # invalid regions keep ~zero rows (C aggregate-init quirk, see module
    # doc) EXCEPT element [0][0]: `float cost_array[8][32] = {2.0f}`
    # (APD.cu:1120) leaves 2.0 in the very first slot, so an invalid region
    # 0 contributes cost 2.0 to view 0
    cost_array = torch.where(flags[..., None], cost_array, 0.0)
    cost_array[:, 0, 0] = torch.where(flags[:, 0], cost_array[:, 0, 0], 2.0)

    # view selection
    nb_x = torch.stack([x, x, x - 1, x + 1], -1)
    nb_y = torch.stack([y - 1, y + 1, y, y], -1)
    nb_sel = fetch(state.selected, nb_x, nb_y)                 # (B, 4, S)
    nb_valid = flags[:, [0, 2, 4, 6]]
    priors = selection.view_selection_priors(nb_sel, nb_valid)
    probs = selection.sampling_probabilities(cost_array, priors, iteration)
    vw, temp_sel, wnorm = selection.monte_carlo_view_weights(draws.sel_u,
                                                             probs)
    has_views = wnorm > 0
    inv_norm = torch.where(has_views, 1.0 / torch.clamp(wnorm, min=1e-20),
                           0.0)
    final_costs = (vw[:, None, :] * cost_array).sum(-1) * inv_norm[:, None]

    # current plane + refinement hypotheses are weighted sums over the
    # Monte-Carlo-selected views only (APD.cu:1405-1412, 988-996): all views
    # are evaluated and unselected ones weigh 0
    def weighted_cost(plane):
        cv = ncc_strong(data, xf, yf, plane, win, site="strong")
        if cfg.geom_consistency and cfg.use_impetus:
            cv = cv + geom_factor * geom_cost(data, xf, yf, plane)
        return (vw * cv).sum(-1) * inv_norm

    cost_recomputed = torch.where(has_views, weighted_cost(cur_plane),
                                  COST_MAX)

    # adopt best candidate (last-min wins ties)
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

    # refinement (5 hypotheses; geom only under impetus gating)
    depth_cur = geo.depth_from_plane(cam, plane_cur, xf, yf)
    r_depths, r_normals = refinement_from_raws(
        draws.raws, cam, xf, yf, plane_cur, depth_cur, depth_min, depth_max)
    r_costs, r_planes = [], []
    for i in range(5):
        plane_i = geo.make_plane(cam, xf, yf, r_depths[:, i], r_normals[:, i])
        ci = weighted_cost(plane_i)
        d_i = geo.depth_from_plane(cam, plane_i, xf, yf)
        ok = (d_i >= depth_min) & (d_i <= depth_max) & has_views
        r_costs.append(torch.where(ok, ci, math.inf))
        r_planes.append(plane_i)
    r_costs = torch.stack(r_costs, 1)                          # (B, 5)
    r_planes = torch.stack(r_planes, 1)                        # (B, 5, 4)
    r_best = torch.argmin(r_costs, -1)[:, None]
    r_cost = torch.gather(r_costs, 1, r_best)[:, 0]
    r_plane = torch.gather(r_planes, 1,
                           r_best[:, :, None].expand(-1, 1, 4))[:, 0]
    take_ref = r_cost < cost_cur
    plane_cur = torch.where(take_ref[:, None], r_plane, plane_cur)
    cost_cur = torch.where(take_ref, r_cost, cost_cur)

    # commit (REFINE_INIT needs a 0.1 improvement; reference APD.cu:1430-1439)
    if cfg.refine_init:
        commit = cost_cur < cost_recomputed - 0.1
        return (torch.where(commit[:, None], plane_cur, cur_plane),
                torch.where(commit, cost_cur, cost_recomputed), sel_new, vw)
    return plane_cur, cost_cur, sel_new, vw


def put_composition(state: PMState, color: int, outs) -> PMState:
    """The commit of one colour's outputs ``outs`` (planes, costs,
    selections, view weights of its pixels in `color_coords` raster order)
    as torch ops: each map's colour half, the outputs where the pixel is
    active (not WEAK, valid), the old values elsewhere, scattered back."""
    h, w = state.costs.shape
    xs2, ys2 = cb.color_coords(h, w, color, device=state.costs.device)
    x = xs2.reshape(-1)
    y = ys2.reshape(-1)
    weak_c = cb.gather_color(state.weak, color).reshape(-1)
    valid_c = cb.gather_color(state.valid, color).reshape(-1)
    active = (weak_c != WEAK) & valid_c

    def put(full, vals_flat):
        old_flat = fetch(full, x, y)
        vals = torch.where(
            active.reshape(active.shape + (1,) * (vals_flat.ndim - 1)),
            vals_flat, old_flat)
        return cb.scatter_color(full, vals.reshape((h, w // 2)
                                                   + vals.shape[1:]), color)

    planes_out, costs_out, sel_new, vw = outs
    return state.replace(
        planes=put(state.planes, planes_out),
        costs=put(state.costs, costs_out),
        selected=put(state.selected, sel_new),
        view_weights=put(state.view_weights, vw),
    )
