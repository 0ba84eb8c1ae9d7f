"""Checkerboard PatchMatch propagation sweeps.

The reference's red-black kernels (CheckerboardPropagationStrong/Weak,
APD.cu:1098-1692) become batched evaluations:

- the *strong* sweep runs per color on the checkerboard-compacted half
  grid (candidates live on the opposite color, so black-then-red preserves
  the reference's intra-sweep data flow exactly); a color's update is one
  launch of the kernel K3 (ops/cuda/strong.py);
- the *weak* sweep runs once over a compacted weak-pixel list — weak
  pixels read only strong pixels' state (their anchors) and never each
  other, so the reference's black/red split of the weak kernels is a no-op;
  a chunk's update is one launch of the kernel K7 (ops/cuda/weak_sweep.py).

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


# The weak sweep draws the same two things per weak pixel, in the same
# order (JAX: propagate_weak's k_sel / k_ref).
WeakDraws = SweepDraws


# ---------------------------------------------------------------------------
# Strong sweep (one checkerboard color)
# ---------------------------------------------------------------------------

def _strong_body(data: CostData, state: PMState, cfg: PropCfg, iteration,
                 draws: SweepDraws, x, y, depth_min, depth_max, geom_factor,
                 row_bounds=None):
    """Candidate evaluation + view selection + refinement for one flat batch
    of same-color pixels. Returns (planes_out, costs_out, sel_new, vw):
    one call of the colour-update kernel K3 (`ops/cuda/strong.py`), which
    builds the reference window itself, its plain version on CPU
    tensors."""
    from .cuda.strong import strong_fused
    draws = SweepDraws(draws.sel_u.contiguous(),
                       RefineRaws(*(r.contiguous() for r in draws.raws)))
    state = state.replace(costs=state.costs.contiguous(),
                          planes=state.planes.contiguous(),
                          selected=state.selected.contiguous())
    return tuple(strong_fused(
        data, state, x.contiguous(), y.contiguous(), draws,
        radius=cfg.strong_radius, increment=cfg.strong_increment,
        use_sa=cfg.use_sa, iteration=iteration, depth_min=depth_min, depth_max=depth_max,
        geom_factor=geom_factor,
        geom=cfg.geom_consistency and cfg.use_impetus,
        refine_init=cfg.refine_init, row_bounds=row_bounds))


def propagate_strong(data: CostData, state: PMState, cfg: PropCfg,
                     iteration, color: int, depth_min, depth_max,
                     geom_factor, generator: Optional[torch.Generator] = None,
                     draws: Optional[SweepDraws] = None, shard=None,
                     row_bounds=None) -> PMState:
    """One color's strong sweep over the whole image. ``draws`` are the
    sweep's random draws (pixels in `color_coords` raster order); without
    them they are taken from ``generator``, all of them, on every rank.

    ``shard`` (a `parallel.tile_pass.RowShard`) evaluates only its rank's
    rows, with their slice of the draws, and all-gathers the outputs
    before the commit, so every rank commits the serial sweep's result.
    ``row_bounds`` as in `checkerboard_candidates`. The depth bounds and
    the geometric factor are best Python numbers: K3 reads a device
    tensor's value back, which waits for the device."""
    h, w = state.costs.shape
    dev = state.costs.device
    xs2, ys2 = cb.color_coords(h, w, color, device=dev)
    x = xs2.reshape(-1)
    y = ys2.reshape(-1)
    if draws is None:
        draws = sweep_draws(generator, x.shape[0], dev)

    weak_c = cb.gather_color(state.weak, color).reshape(-1)
    valid_c = cb.gather_color(state.valid, color).reshape(-1)
    active = (weak_c != WEAK) & valid_c

    if shard is None:
        planes_out, costs_out, sel_new, vw = _strong_body(
            data, state, cfg, iteration, draws, x, y, depth_min, depth_max,
            geom_factor, row_bounds)
    else:
        sl, counts = shard.row_part(h, w // 2)
        outs = _strong_body(data, state, cfg, iteration,
                            _take_draws(draws, sl), x[sl], y[sl], depth_min,
                            depth_max, geom_factor, row_bounds)
        planes_out, costs_out, sel_new, vw = (shard.gather(o, counts)
                                              for o in outs)

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
    APD.cu:1441-1615, and PlaneHypothesisRefinementWeak, :1008-1096).
    Returns (planes_out, costs_out, sel_new, vw): one call of the weak
    sweep's chunk-update kernel K7 (`ops/cuda/weak_sweep.py`), which builds
    the reference side and runs K6's deformable NCC (with the geometric cost
    K4 when the pass is geometric) inside, its plain version on CPU
    tensors. The depth bounds and the geometric factor are best Python
    numbers (`propagate_weak` reads them once)."""
    from .cuda.weak_sweep import weak_update_fused
    draws = SweepDraws(draws.sel_u.contiguous(),
                       RefineRaws(*(r.contiguous() for r in draws.raws)))
    state = state.replace(planes=state.planes.contiguous(),
                          selected=state.selected.contiguous(),
                          weak=state.weak.contiguous())
    return tuple(weak_update_fused(
        data, state, x.contiguous(), y.contiguous(), anchors.contiguous(),
        fit_planes.contiguous(), draws, strong_radius=cfg.strong_radius,
        strong_increment=cfg.strong_increment, weak_radius=cfg.weak_radius,
        weak_increment=cfg.weak_increment, use_sa=cfg.use_sa,
        iteration=iteration, depth_min=depth_min, depth_max=depth_max,
        geom_factor=geom_factor, geom=cfg.geom_consistency,
        refine_init=cfg.refine_init))


def propagate_weak(data: CostData, state: PMState, cfg: PropCfg, iteration,
                   weak_x, weak_y, anchors, fit_planes, depth_min, depth_max,
                   geom_factor, generator: Optional[torch.Generator] = None,
                   draws: Optional[WeakDraws] = None,
                   chunk: int = WEAK_SWEEP_CHUNK, shard=None) -> PMState:
    """One weak-pixel sweep.

    weak_x / weak_y: (Nw,) int32 coords; anchors: (Nw, 9, 2) int32;
    fit_planes: (Nw, 4) from the iteration's RANSAC fit (zeros when
    absent). ``draws`` are the sweep's random draws in weak-list order;
    without them they are taken from ``generator``. Only pixels still WEAK
    in ``state`` are written. ``shard`` evaluates only its rank's slice of
    the list and all-gathers the outputs, as in `propagate_strong`."""
    h, w = state.costs.shape
    dev = state.costs.device
    nw = weak_x.shape[0]
    if nw == 0:
        return state
    if draws is None:
        draws = sweep_draws(generator, nw, dev)
    # K7 takes the scalars as float32 values in Python floats, read here
    # once a sweep (a device tensor's read waits for the device)
    depth_min, depth_max, geom_factor = (
        float(geo.f32_scalar(v, "cpu"))
        for v in (depth_min, depth_max, geom_factor))
    sl, counts = (slice(0, nw), None) if shard is None \
        else shard.list_part(nw)

    def part(lo, hi):
        if lo == hi:        # a rank whose slice of a short list is empty
            s = state.selected.shape[-1]
            return (torch.zeros((0, 4), device=dev),
                    torch.zeros((0,), device=dev),
                    torch.zeros((0, s), dtype=torch.bool, device=dev),
                    torch.zeros((0, s), device=dev))
        return _weak_body(data, state, cfg, iteration,
                          _take_draws(draws, slice(lo, hi)), weak_x[lo:hi],
                          weak_y[lo:hi], anchors[lo:hi], fit_planes[lo:hi],
                          depth_min, depth_max, geom_factor)
    outs = [part(lo, min(lo + chunk, sl.stop))
            for lo in range(sl.start, sl.stop, chunk)] \
        or [part(sl.start, sl.start)]
    planes_out, costs_out, sel_new, vw = (torch.cat(o) for o in zip(*outs))
    if shard is not None:
        planes_out, costs_out, sel_new, vw = (
            shard.gather(o, counts)
            for o in (planes_out, costs_out, sel_new, vw))

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
