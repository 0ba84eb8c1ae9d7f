"""Checkerboard PatchMatch propagation sweeps.

The reference's red-black kernels (CheckerboardPropagationStrong/Weak,
APD.cu:1098-1692) become batched evaluations:

- the *strong* sweep runs per color on the checkerboard-compacted half
  grid (candidates live on the opposite color, so black-then-red preserves
  the reference's intra-sweep data flow exactly); a color's update is one
  call of K3's plain version (stages/strong.py);
- the *weak* sweep runs once over a compacted weak-pixel list — weak
  pixels read only strong pixels' state (their anchors) and never each
  other, so the reference's black/red split of the weak kernels is a no-op;
  a chunk's update is one call of K7's plain version (stages/weak_sweep.py).

Semantic notes carried over deliberately:
- invalid candidate regions contribute ~0 cost rows (the reference's C
  aggregate initialization `float cost_array[8][32] = {2.0f}` zero-fills all
  but the first element, APD.cu:1120/1464), and FindMinCostIndex's `<=` makes
  the *last* minimum win; both quirks shape which pixels adopt candidates and
  are reproduced.
- pixels whose Monte-Carlo view selection comes back empty (zero probability
  mass) hit a 0/0 in the reference; we define that case as "no update".

Randomness: the 15 selection uniforms and the refinement draws of a sweep
(`SweepDraws`, `WeakDraws`) come from a torch.Generator, or are injected
whole (the parity tests inject the JAX package's draws).
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
from .cost import CostData
from .state import PMState


class PropCfg(NamedTuple):
    """Static propagation configuration."""

    geom_consistency: bool = False
    use_impetus: bool = True
    use_sa: bool = False
    refine_init: bool = False     # REFINE_INIT accept rule (improve > 0.1)
    strong_radius: int = 5
    strong_increment: int = 2
    weak_radius: int = 5
    weak_increment: int = 5


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


def checkerboard_candidates(costs: torch.Tensor, x, y, row_bounds=None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Min-cost candidate position per region.

    costs: (H, W); x, y: (B,) int32. Returns (cand_x, cand_y (B, 8),
    flags (B, 8)). A region is valid iff its base offset is in-bounds; within
    a region the first position achieving the minimal cost wins (the
    reference's strict `<` scan order; torch.argmin returns the first
    minimum). ``row_bounds=(lo, hi)`` narrows the in-bounds rows to
    lo..hi inclusive: a halo-extended row block whose outer rows lie
    outside the image (parallel/tiles.py)."""
    h, w = costs.shape
    lo, hi = (0, h - 1) if row_bounds is None else row_bounds
    cxs, cys, fls = [], [], []
    for r in range(8):
        offs = torch.as_tensor(np.asarray(_REGIONS[r], np.int32),
                               device=x.device)                 # (M, 2)
        px = x[None, :] + offs[:, 0:1]                          # (M, B)
        py = y[None, :] + offs[:, 1:2]
        inb = (px >= 0) & (px < w) & (py >= lo) & (py <= hi)
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


class SweepDraws(NamedTuple):
    """All random draws of one color sweep of B pixels."""

    sel_u: torch.Tensor     # (B, NUM_SAMPLES) Monte-Carlo uniforms
    raws: RefineRaws


def sweep_draws(generator: torch.Generator, n: int, device) -> SweepDraws:
    sel_u = torch.rand((n, selection.NUM_SAMPLES), generator=generator,
                       device=device)
    return SweepDraws(sel_u, refinement_raws(generator, n, device))


# The weak sweep draws the same two things per weak pixel, in the same
# order (JAX: propagate_weak's k_sel / k_ref).
WeakDraws = SweepDraws


# ---------------------------------------------------------------------------
# Strong sweep (one checkerboard color)
# ---------------------------------------------------------------------------

def propagate_strong(data: CostData, state: PMState, cfg: PropCfg,
                     iteration, color: int, depth_min, depth_max,
                     geom_factor, generator: Optional[torch.Generator] = None,
                     draws: Optional[SweepDraws] = None,
                     row_bounds=None) -> PMState:
    """One color's strong sweep over the whole image: K3's plain colour
    update of the color's pixels (``stages.strong.strong_plain``), then
    its commit of the active pixels (not WEAK, valid). ``draws`` are the
    sweep's random draws (pixels in `color_coords` raster order); without
    them they are taken from ``generator``. ``row_bounds`` as in
    `checkerboard_candidates`."""
    from .stages.strong import commit_maps_plain, strong_plain
    h, w = state.costs.shape
    dev = state.costs.device
    xs2, ys2 = cb.color_coords(h, w, color, device=dev)
    x = xs2.reshape(-1)
    y = ys2.reshape(-1)
    if draws is None:
        draws = sweep_draws(generator, x.shape[0], dev)
    out = strong_plain(
        data, state, x, y, draws, radius=cfg.strong_radius,
        increment=cfg.strong_increment, use_sa=cfg.use_sa,
        iteration=iteration, depth_min=depth_min, depth_max=depth_max,
        geom_factor=geom_factor,
        geom=cfg.geom_consistency and cfg.use_impetus,
        refine_init=cfg.refine_init, row_bounds=row_bounds)
    planes, costs, selected, view_weights = commit_maps_plain(state, x, y,
                                                              out)
    return state.replace(planes=planes, costs=costs, selected=selected,
                         view_weights=view_weights)


# ---------------------------------------------------------------------------
# Weak sweep (one pass over the compacted weak-pixel list)
# ---------------------------------------------------------------------------

# weak pixels per sweep evaluation: it bounds the (chunk, 10, S) costs and
# the plain version's (S, chunk x 10 x 8, 9) anchor taps; the result does
# not depend on it (draws are taken for the whole list first)
WEAK_SWEEP_CHUNK = 1 << 16


def _take_draws(draws: SweepDraws, sl) -> SweepDraws:
    return SweepDraws(draws.sel_u[sl],
                      RefineRaws(*(r[sl] for r in draws.raws)))


def _weak_body(data: CostData, state: PMState, cfg: PropCfg, iteration,
               draws: WeakDraws, x, y, anchors, fit_planes, depth_min,
               depth_max, geom_factor):
    """Anchor-candidate evaluation + fit-plane test + refinement for one
    flat batch of weak pixels (reference: CheckerboardPropagationWeak,
    APD.cu:1441-1615, and PlaneHypothesisRefinementWeak, :1008-1096):
    K7's plain chunk update (``stages.weak_sweep.weak_update_plain``).
    Returns (planes_out, costs_out, sel_new, vw)."""
    from .stages.weak_sweep import weak_update_plain
    return tuple(weak_update_plain(
        data, state, x, y, anchors, fit_planes, draws,
        strong_radius=cfg.strong_radius,
        strong_increment=cfg.strong_increment, weak_radius=cfg.weak_radius,
        weak_increment=cfg.weak_increment, use_sa=cfg.use_sa,
        iteration=iteration, depth_min=depth_min, depth_max=depth_max,
        geom_factor=geom_factor, geom=cfg.geom_consistency,
        refine_init=cfg.refine_init))


def propagate_weak(data: CostData, state: PMState, cfg: PropCfg, iteration,
                   weak_x, weak_y, anchors, fit_planes, depth_min, depth_max,
                   geom_factor, generator: Optional[torch.Generator] = None,
                   draws: Optional[WeakDraws] = None,
                   chunk: int = WEAK_SWEEP_CHUNK) -> PMState:
    """One weak-pixel sweep.

    weak_x / weak_y: (Nw,) int32 coords; anchors: (Nw, 9, 2) int32;
    fit_planes: (Nw, 4) from the iteration's RANSAC fit (zeros when
    absent). ``draws`` are the sweep's random draws in weak-list order;
    without them they are taken from ``generator``. Only pixels still WEAK
    in ``state`` are written."""
    h, w = state.costs.shape
    dev = state.costs.device
    nw = weak_x.shape[0]
    if nw == 0:
        return state
    if draws is None:
        draws = sweep_draws(generator, nw, dev)
    # the scalars as float32 values in Python floats, as the port's K7
    # takes them
    depth_min, depth_max, geom_factor = (
        float(geo.f32_scalar(v, "cpu"))
        for v in (depth_min, depth_max, geom_factor))
    outs = [_weak_body(data, state, cfg, iteration,
                       _take_draws(draws, slice(lo, min(lo + chunk, nw))),
                       weak_x[lo:lo + chunk], weak_y[lo:lo + chunk],
                       anchors[lo:lo + chunk], fit_planes[lo:lo + chunk],
                       depth_min, depth_max, geom_factor)
            for lo in range(0, nw, chunk)]
    planes_out, costs_out, sel_new, vw = (torch.cat(o) for o in zip(*outs))

    upd = fetch(state.weak, weak_x, weak_y) == WEAK
    flat_idx = weak_y.long() * w + weak_x.long()

    def put(full, vals):
        flat = full.reshape((h * w,) + full.shape[2:]).clone()
        sel = upd.reshape(upd.shape + (1,) * (vals.ndim - 1))
        flat[flat_idx] = torch.where(sel, vals, flat[flat_idx])
        return flat.reshape(full.shape)

    return state.replace(planes=put(state.planes, planes_out),
                         costs=put(state.costs, costs_out),
                         selected=put(state.selected, sel_new),
                         view_weights=put(state.view_weights, vw))
