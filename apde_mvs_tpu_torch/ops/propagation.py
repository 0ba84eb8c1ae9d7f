"""Checkerboard PatchMatch propagation: the strong sweep of one color.

The reference's red-black kernels (CheckerboardPropagationStrong,
APD.cu:1098-1439) become one batched evaluation per color over the
checkerboard-compacted half grid (candidates live on the opposite color, so
black-then-red preserves the reference's intra-sweep data flow exactly).

Semantic notes carried over deliberately:
- invalid candidate regions contribute ~0 cost rows (the reference's C
  aggregate initialization `float cost_array[8][32] = {2.0f}` zero-fills all
  but the first element, APD.cu:1120), and FindMinCostIndex's `<=` makes
  the *last* minimum win; both quirks shape which pixels adopt candidates and
  are reproduced.
- pixels whose Monte-Carlo view selection comes back empty (zero probability
  mass) hit a 0/0 in the reference; we define that case as "no update".

Randomness: the 15 selection uniforms and the refinement draws of a sweep
(`SweepDraws`) come from a torch.Generator, or are injected whole (the
parity tests inject the JAX package's draws).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import WEAK
from ..core import checkerboard as cb
from ..core import geometry as geo
from ..core.sampling import fetch
from . import selection
from .cost import COST_MAX, CostData, geom_cost, ncc_strong, \
    precompute_ref_window
from .state import PMState


class PropCfg(NamedTuple):
    """Static propagation configuration."""

    geom_consistency: bool = False
    use_impetus: bool = True
    refine_init: bool = False     # REFINE_INIT accept rule (improve > 0.1)
    strong_radius: int = 5
    strong_increment: int = 2


# ---------------------------------------------------------------------------
# Adaptive checkerboard candidate regions (reference: APD.cu:1119-1316).
# Region order matches the reference cost_array indexing:
# 0 up_near, 1 up_far, 2 down_near, 3 down_far,
# 4 left_near, 5 left_far, 6 right_near, 7 right_far.
# ---------------------------------------------------------------------------

def _near_offsets(axis: str, sign: int):
    if axis == "y":
        offs = [(0, sign)]
        for i in range(3):
            offs.append((-(i + 1), sign * (2 + i)))
            offs.append((+(i + 1), sign * (2 + i)))
    else:
        offs = [(sign, 0)]
        for i in range(3):
            offs.append((sign * (2 + i), -(i + 1)))
            offs.append((sign * (2 + i), +(i + 1)))
    return offs


def _far_offsets(axis: str, sign: int):
    if axis == "y":
        return [(0, sign * (3 + 2 * i)) for i in range(11)]
    return [(sign * (3 + 2 * i), 0) for i in range(11)]


_REGIONS = [
    _near_offsets("y", -1), _far_offsets("y", -1),
    _near_offsets("y", +1), _far_offsets("y", +1),
    _near_offsets("x", -1), _far_offsets("x", -1),
    _near_offsets("x", +1), _far_offsets("x", +1),
]


def checkerboard_candidates(costs: torch.Tensor, x, y
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Min-cost candidate position per region.

    costs: (H, W); x, y: (B,) int32. Returns (cand_x, cand_y (B, 8),
    flags (B, 8)). A region is valid iff its base offset is in-bounds; within
    a region the first position achieving the minimal cost wins (the
    reference's strict `<` scan order; torch.argmin returns the first
    minimum)."""
    h, w = costs.shape
    cxs, cys, fls = [], [], []
    for r in range(8):
        offs = torch.as_tensor(np.asarray(_REGIONS[r], np.int32),
                               device=x.device)                 # (M, 2)
        px = x[None, :] + offs[:, 0:1]                          # (M, B)
        py = y[None, :] + offs[:, 1:2]
        inb = (px >= 0) & (px < w) & (py >= 0) & (py < h)
        c = torch.where(inb, fetch(costs, px, py, fill=0.0), math.inf)
        best = torch.argmin(c, dim=0, keepdim=True)
        cxs.append(torch.gather(px, 0, best)[0])
        cys.append(torch.gather(py, 0, best)[0])
        fls.append(inb[0])                          # base position validity
    return torch.stack(cxs, -1), torch.stack(cys, -1), torch.stack(fls, -1)


def last_min_index(vals: torch.Tensor) -> torch.Tensor:
    """Index of the last minimum along -1 (reference FindMinCostIndex's `<=`,
    APD.cu:60-71)."""
    n = vals.shape[-1]
    return n - 1 - torch.argmin(torch.flip(vals, dims=[-1]), dim=-1)


# ---------------------------------------------------------------------------
# Plane refinement hypotheses (reference: PlaneHypothesisRefinementStrong,
# APD.cu:950-1027).
# ---------------------------------------------------------------------------

class RefineRaws(NamedTuple):
    """Raw random draws of one refinement step."""

    u_rand: torch.Tensor    # (B,) uniform [0,1) -> full-range random depth
    g: torch.Tensor         # (B, 3) gaussian -> random facing normal
    u_pert: torch.Tensor    # (B,) uniform [0,1) -> ±2% depth perturbation
    angles: torch.Tensor    # (B, 3) scaled Euler angles -> normal perturbation


def refinement_raws(generator: torch.Generator, n: int,
                    device) -> RefineRaws:
    def rand(*shape):
        return torch.rand(shape, generator=generator, device=device)
    u_rand = rand(n)
    g = torch.randn((n, 3), generator=generator, device=device)
    u_pert = rand(n)
    angles = (rand(n, 3) - 0.5) * np.float32(0.02 * np.pi)
    return RefineRaws(u_rand, g, u_pert, angles)


def refinement_from_raws(raws: RefineRaws, cam: geo.CameraArrays, x, y,
                         cur_plane, cur_depth, depth_min, depth_max):
    """The 5 (depth, normal) refinement combos. Returns (depths (B, 5),
    normals (B, 5, 3)). The reference's do-while depth-perturbation loop has
    a condition that can never hold (`< depth_min && > depth_max`), i.e. it
    samples exactly once; so do we."""
    depth_min = geo.f32_scalar(depth_min, x.device)
    depth_max = geo.f32_scalar(depth_max, x.device)
    d_rand = torch.maximum(depth_min,
                           raws.u_rand * (depth_max - depth_min) + depth_min)
    n_rand = geo.unit_normal_facing_from_gaussian(raws.g, cam, x, y,
                                                  cur_depth)
    lo = 0.98 * cur_depth
    d_pert = torch.maximum(lo, raws.u_pert * (1.02 * cur_depth - lo) + lo)
    n_cur = cur_plane[..., :3]
    n_pert = geo.perturbed_normal_from_angles(raws.angles, cam, x, y, n_cur)
    depths = torch.stack([d_rand, cur_depth, d_rand, cur_depth, d_pert], -1)
    normals = torch.stack([n_cur, n_rand, n_rand, n_pert, n_cur], -2)
    return depths, normals


class SweepDraws(NamedTuple):
    """All random draws of one color sweep of B pixels."""

    sel_u: torch.Tensor     # (B, NUM_SAMPLES) Monte-Carlo uniforms
    raws: RefineRaws


def sweep_draws(generator: torch.Generator, n: int, device) -> SweepDraws:
    sel_u = torch.rand((n, selection.NUM_SAMPLES), generator=generator,
                       device=device)
    return SweepDraws(sel_u, refinement_raws(generator, n, device))


# ---------------------------------------------------------------------------
# Strong sweep (one checkerboard color)
# ---------------------------------------------------------------------------

def _strong_body(data: CostData, state: PMState, cfg: PropCfg, iteration,
                 draws: SweepDraws, x, y, depth_min, depth_max, geom_factor):
    """Candidate evaluation + view selection + refinement for one flat batch
    of same-color pixels. Returns (planes_out, costs_out, sel_new, vw).
    Each plane hypothesis (8 candidates, the current plane, 5 refinement
    probes) is one all-views `ncc_strong`: 14 K1 launches."""
    xf = x.to(torch.float32)
    yf = y.to(torch.float32)
    cam = data.ref_cam

    cand_x, cand_y, flags = checkerboard_candidates(state.costs, x, y)
    cand_planes = fetch(state.planes, cand_x, cand_y)          # (B, 8, 4)
    cur_plane = fetch(state.planes, x, y)

    win = precompute_ref_window(data, xf, yf, cfg.strong_radius,
                                cfg.strong_increment)
    cost_array = torch.stack([ncc_strong(data, xf, yf, cand_planes[:, c], win)
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
        cv = ncc_strong(data, xf, yf, plane, win)
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


def propagate_strong(data: CostData, state: PMState, cfg: PropCfg,
                     iteration, color: int, depth_min, depth_max,
                     geom_factor, generator: Optional[torch.Generator] = None,
                     draws: Optional[SweepDraws] = None) -> PMState:
    """One color's strong sweep over the whole image. ``draws`` are the
    sweep's random draws (pixels in `color_coords` raster order); without
    them they are taken from ``generator``."""
    h, w = state.costs.shape
    dev = state.costs.device
    xs2, ys2 = cb.color_coords(h, w, color, device=dev)
    x = xs2.reshape(-1)
    y = ys2.reshape(-1)
    if draws is None:
        draws = sweep_draws(generator, x.shape[0], dev)
    depth_min = geo.f32_scalar(depth_min, dev)
    depth_max = geo.f32_scalar(depth_max, dev)
    geom_factor = geo.f32_scalar(geom_factor, dev)

    weak_c = cb.gather_color(state.weak, color).reshape(-1)
    valid_c = cb.gather_color(state.valid, color).reshape(-1)
    active = (weak_c != WEAK) & valid_c

    planes_out, costs_out, sel_new, vw = _strong_body(
        data, state, cfg, iteration, draws, x, y, depth_min, depth_max,
        geom_factor)

    # scatter back (only active pixels change)
    def put(full, vals_flat):
        old_flat = fetch(full, x, y)
        vals = torch.where(
            active.reshape(active.shape + (1,) * (vals_flat.ndim - 1)),
            vals_flat, old_flat)
        return cb.scatter_color(full, vals.reshape((h, w // 2)
                                                   + vals.shape[1:]), color)

    return state.replace(
        planes=put(state.planes, planes_out),
        costs=put(state.costs, costs_out),
        selected=put(state.selected, sel_new),
        view_weights=put(state.view_weights, vw),
    )
