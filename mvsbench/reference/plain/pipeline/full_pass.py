"""One view's PatchMatch pass as three stages (reference schedule:
APD::RunPatchMatch, APD.cu:2663-2737).

1. `pass_sweeps`: [APD] nearest-strong transform, anchors over the
   compacted weak list and demotion; init (random planes or the priors) and
   the initial cost; max_iterations x {strong sweep black, red; [APD]
   fit-plane RANSAC + weak sweep}; plane -> (world normal, depth); the
   strong median filter.
2. `pass_classify`: reliability reclassification (DepthToWeak) over the
   pixels the sweep would not mark UNKNOWN without sampling.
3. `pass_finish`: [geom or APD] confidence; local refine.

All random draws come from the one per-view generator. The classify /
refine stages evaluate pixels in chunks of ``CHUNK`` (the JAX engine's
classify chunk); results do not depend on it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import UNKNOWN, WEAK, PatchMatchParams
from ..core import geometry as geo
from ..ops import anchors as anchor_ops
from ..ops import filters, init as init_ops
from ..ops.cost import CostData
from ..ops.stages.sweep import MIN_MARGIN
from ..ops.propagation import PropCfg, propagate_strong, propagate_weak
from ..ops.state import PMState

# pixels per classify / refine evaluation: bounds the (S, chunk, 36)
# intermediates; results do not depend on it
CHUNK = 1 << 16


class PassStatic(NamedTuple):
    """The pass's configuration, derived once from its parameters."""

    params: PatchMatchParams
    prop: PropCfg
    first_init: bool
    use_apd: bool          # weak machinery on (never on a FIRST_INIT pass)

    @staticmethod
    def from_params(params: PatchMatchParams) -> "PassStatic":
        first_init = params.state == "first_init"
        return PassStatic(
            params=params,
            prop=PropCfg(
                geom_consistency=bool(params.geom_consistency),
                use_impetus=bool(params.use_impetus),
                use_sa=bool(params.use_sa),
                refine_init=(params.state == "refine_init"),
                strong_radius=params.strong_radius,
                strong_increment=params.strong_increment,
                weak_radius=params.weak_radius,
                weak_increment=params.weak_increment),
            first_init=first_init,
            use_apd=bool(params.use_apd) and not first_init)


class WeakSet(NamedTuple):
    """The pass's weak list and its anchors (fixed for the pass), and the
    reliable subset the fit and the weak sweeps run over."""

    x: torch.Tensor          # (Nw,) int32
    y: torch.Tensor
    anchors: torch.Tensor    # (Nw, 9, 2) int32
    sweep: tuple             # (x, y, anchors) of the reliable pixels


def prior_state(data: CostData, cfg: PassStatic, *, prior_depth=None,
                prior_normal=None, prior_weak=None, prior_confidence=None,
                valid: Optional[torch.Tensor] = None) -> PMState:
    """The state a pass starts from: planes = (world normal, depth) priors
    on non-first passes, prior weak map (APD) and confidence. Priors are
    numpy arrays or tensors at the padded resolution."""
    dev = data.device
    state = PMState.create(data.height, data.width, data.num_src,
                           valid=valid, device=dev)
    if prior_weak is not None and cfg.use_apd:
        state = state.replace(weak=torch.where(
            state.valid, torch.as_tensor(prior_weak, device=dev).to(
                torch.int32), UNKNOWN))
    if prior_confidence is not None:
        state = state.replace(confidence=torch.as_tensor(
            prior_confidence, dtype=torch.float32, device=dev))
    if prior_depth is not None:
        state = state.replace(planes=torch.cat(
            [torch.as_tensor(prior_normal, dtype=torch.float32, device=dev),
             torch.as_tensor(prior_depth, dtype=torch.float32,
                             device=dev)[..., None]], -1))
    return state


def lowered(state: PMState) -> PMState:
    """The control's state: planes and costs rounded to bfloat16, the
    nearest precision below the configuration's float32."""
    return state.replace(
        planes=state.planes.to(torch.bfloat16).to(torch.float32),
        costs=state.costs.to(torch.bfloat16).to(torch.float32))


def pass_sweeps(data: CostData, state: PMState, cfg: PassStatic, dmin, dmax,
                gen: torch.Generator, *, lower: bool = False):
    """Stage 1. ``state`` is `prior_state`'s; returns (post-sweep state
    with planes = (world normal, depth), the pass's `WeakSet` or None).
    With ``lower`` the state is `lowered` after the initial cost and every
    sweep (the control)."""
    params = cfg.params
    # the sweeps' scalars as float32 values in Python floats, as the port
    # reads them once a pass
    gf, dmin_f, dmax_f = _sweep_constants(params, dmin, dmax)

    # ---- APD setup: weak list, anchors, demotion --------------------------
    weak = None
    if cfg.use_apd:
        wy, wx = torch.nonzero(state.weak == WEAK, as_tuple=True)
        if wx.numel() > 0:
            wx = wx.to(torch.int32)
            wy = wy.to(torch.int32)
            ns = anchor_ops.nearest_strong_jfa_plain(
                state.weak, state.confidence, state.valid)
            res = anchor_ops.gen_anchors(
                data, state, wx, wy, params.rotate_time,
                params.ransac_threshold, dmin_f, dmax_f, ns, generator=gen)
            state = anchor_ops.neighbor_update(state, wx, wy, res.reliable)
            # demoted pixels are no longer WEAK: the fit and the weak sweep
            # (which write WEAK pixels only) run over the reliable ones
            keep = torch.nonzero(res.reliable, as_tuple=True)[0]
            weak = WeakSet(wx, wy, res.anchors,
                           (wx[keep], wy[keep], res.anchors[keep]))

    # ---- init + iterations ------------------------------------------------
    if cfg.first_init:
        planes = init_ops.random_planes(data, dmin, dmax, generator=gen)
    else:
        planes = filters.depth_normal_to_planes(
            data, state.planes[..., 3], state.planes[..., :3])
    state = init_ops.initial_cost(
        data, state.replace(planes=planes), params,
        *(weak[:3] if weak is not None else ()))
    if lower:
        state = lowered(state)
    state = _iterations(data, state, cfg, weak, (dmin_f, dmax_f, gf), gen,
                        lower)
    state = state.replace(planes=filters.planes_to_depth_normal(
        data, state.planes))
    for color in (0, 1):
        state = filters.median_filter_color(state, color)
    return state, weak


def _iterations(data: CostData, state: PMState, cfg: PassStatic, weak,
                consts: tuple, gen: torch.Generator,
                lower: bool = False) -> PMState:
    """Stage 1's iterations: the strong sweep's two colours, then [APD] the
    fit-plane RANSAC and the weak sweep. ``consts`` are `_sweep_constants`'
    depth bounds and geometric factor."""
    dmin_f, dmax_f, gf = consts
    for it in range(cfg.params.max_iterations):
        for color in (0, 1):
            state = propagate_strong(data, state, cfg.prop, it, color,
                                     dmin_f, dmax_f, gf, generator=gen)
            if lower:
                state = lowered(state)
        if weak is not None and weak.sweep[0].numel() > 0:
            fit = anchor_ops.ransac_fit_planes(data, state, *weak.sweep,
                                               generator=gen)
            state = propagate_weak(data, state, cfg.prop, it, *weak.sweep,
                                   fit, dmin_f, dmax_f, gf, generator=gen)
            if lower:
                state = lowered(state)
    return state


def _row_chunks(fn, mask: torch.Tensor, fill: torch.Tensor) -> torch.Tensor:
    """``fn(x, y)`` over ``mask``'s pixels (raster order, chunks of
    ``CHUNK``), written into a copy of ``fill``."""
    ys, xs = torch.nonzero(mask, as_tuple=True)
    ys = ys.to(torch.int32)
    xs = xs.to(torch.int32)
    outs = [fn(xs[i:i + CHUNK], ys[i:i + CHUNK])
            for i in range(0, xs.numel(), CHUNK)]
    full = fill.clone()
    if outs:
        vals = torch.cat([o[0] if isinstance(o, tuple) else o for o in outs])
        full[ys.long(), xs.long()] = vals.to(full.dtype)
    return full


def sweepable(data: CostData, state: PMState) -> torch.Tensor:
    """Pixels the classify / refine sweeps can score: real pixels with a
    depth and a non-empty view selection (the guard conditions of
    DepthToWeak, APD.cu:2107-2119)."""
    return state.valid & (state.planes[..., 3] != 0.0) \
        & state.selected.any(-1)


def _sweep_constants(params, dmin, dmax) -> tuple:
    """The geometric factor and the depth bounds as Python floats (float32
    values)."""
    return tuple(float(geo.f32_scalar(v, "cpu"))
                 for v in (params.geom_factor, dmin, dmax))


def pass_classify(data: CostData, state: PMState, cfg: PassStatic, dmin,
                  dmax) -> torch.Tensor:
    """Stage 2: the reclassified (H, W) int32 weak map. Pixels the sweep
    would classify UNKNOWN without sampling anything (margins, padding,
    zero depth, empty selection) are skipped. The depth bounds are Python
    numbers (`full_pass` reads them once a pass)."""
    h, w = data.height, data.width
    dev = data.device
    params = cfg.params
    gf, dmin, dmax = _sweep_constants(params, dmin, dmax)
    xs, ys = geo.pixel_grid(h, w, dev)
    margin = (xs < MIN_MARGIN) | (ys < MIN_MARGIN) \
        | (xs >= data.img_w - MIN_MARGIN) | (ys >= data.img_h - MIN_MARGIN)
    mask = sweepable(data, state) & ~margin

    def classify(cx, cy):
        return filters.depth_to_weak(
            data, state, cx, cy, params.weak_peak_radius,
            cfg.prop.geom_consistency, gf, dmin, dmax, cfg.prop.strong_radius,
            cfg.prop.strong_increment, use_sa=cfg.prop.use_sa)

    return _row_chunks(classify, mask,
                       torch.full((h, w), UNKNOWN, dtype=torch.int32,
                                  device=dev))


def pass_finish(data: CostData, state: PMState, cfg: PassStatic, dmin,
                dmax) -> PMState:
    """Stage 3: confidence + local refine. ``state.weak`` must already hold
    stage 2's reclassification; the depth bounds as in `pass_classify`."""
    params = cfg.params
    gf, dmin, dmax = _sweep_constants(params, dmin, dmax)
    refine_mask = sweepable(data, state)
    if params.geom_consistency or cfg.use_apd:
        state = filters.compute_confidence(data, state)

    def refine(cx, cy):
        return filters.local_refine(
            data, state, cx, cy, cfg.prop.geom_consistency, gf, dmin, dmax,
            cfg.prop.strong_radius, cfg.prop.strong_increment,
            use_sa=cfg.prop.use_sa)

    depth = _row_chunks(refine, refine_mask, state.planes[..., 3])
    return state.replace(planes=torch.cat([state.planes[..., :3],
                                           depth[..., None]], -1))


def full_pass(data: CostData, state: PMState, cfg: PassStatic, dmin, dmax,
              gen: torch.Generator, *, lower: bool = False):
    """The three stages in order. Returns (the final state: planes =
    (world normal, refined depth), the reclassified weak map, confidence;
    the pass's `WeakSet` or None)."""
    state, weak = pass_sweeps(data, state, cfg, dmin, dmax, gen, lower=lower)
    # the classify and refine stages' depth bounds, read to the host once
    _, dmin, dmax = _sweep_constants(cfg.params, dmin, dmax)
    weak_map = pass_classify(data, state, cfg, dmin, dmax)
    state = pass_finish(data, state.replace(weak=weak_map), cfg, dmin, dmax)
    return state, weak
