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

`pipeline.patchmatch.run_patchmatch` composes them for the serial engine
and the view-parallel engine (`parallel.scene`). Every stage takes an
optional ``shard`` (`parallel.tile_pass.RowShard`): the tile route runs one
view's pass over several ranks, each evaluating its own rows (and its slice
of the weak list) against the full state, then all-gathering the results
so every rank commits what the serial pass commits. All random draws come
from the one per-view generator, drawn whole on every rank and sliced, so
the sharded pass takes exactly the serial pass's draws.

The classify / refine stages evaluate pixels in chunks of ``CHUNK`` (the
JAX engine's classify chunk); results do not depend on it. On the card a
chunk is one launch of K5's stage form and nothing else, so a stage costs
one `nonzero` (its pixel count, the one read that waits for the device)
and a launch a chunk.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import UNKNOWN, WEAK, PatchMatchParams
from ..core import geometry as geo
from ..ops import anchors as anchor_ops
from ..ops import filters, init as init_ops
from ..ops.cost import CostData
from ..ops.cuda import sweep as k5
from ..ops.cuda.sweep import MIN_MARGIN
from ..ops.propagation import PropCfg, propagate_strong, propagate_weak
from ..ops.state import PMState

# pixels per classify / refine evaluation: bounds the plain version's
# (S, chunk, 36) intermediates on the CPU; results do not depend on it
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


def _anchors(data, state, wx, wy, params, dmin, dmax, ns, gen, shard,
             cam=None):
    """`gen_anchors` over the weak list (``cam``: the reference camera's
    intrinsics on the host). With a shard, every rank draws each serial
    chunk's raws in turn and scores the part of the chunk inside its own
    slice, then the results are all-gathered."""
    if shard is None:
        return anchor_ops.gen_anchors(
            data, state, wx, wy, params.rotate_time, params.ransac_threshold,
            dmin, dmax, ns, generator=gen, cam=cam)
    n = wx.shape[0]
    sl, counts = shard.list_part(n)
    parts = []
    for lo in range(0, n, anchor_ops.ANCHOR_CHUNK):
        hi = min(lo + anchor_ops.ANCHOR_CHUNK, n)
        raws = anchor_ops.anchor_raws(gen, hi - lo, params.rotate_time,
                                      device=data.device)
        a, b = max(lo, sl.start), min(hi, sl.stop)
        if a < b:
            parts.append(anchor_ops.gen_anchors(
                data, state, wx[a:b], wy[a:b], params.rotate_time,
                params.ransac_threshold, dmin, dmax, ns,
                raws=anchor_ops.AnchorRaws(
                    raws.shift_x[a - lo:b - lo], raws.shift_y[a - lo:b - lo],
                    raws.triplets[:, a - lo:b - lo]), cam=cam))
    if not parts:
        parts = [anchor_ops.gen_anchors(data, state, wx[:0], wy[:0],
                                        params.rotate_time,
                                        params.ransac_threshold, dmin, dmax,
                                        ns, raws=None, cam=cam)]
    return anchor_ops.AnchorResult(*(shard.gather(torch.cat(f), counts)
                                     for f in zip(*parts)))


def _fit_planes(data, state, sweep_list, gen, shard, cam=None):
    """The iteration's fit-plane RANSAC over the reliable weak pixels
    (``cam``: the reference camera's intrinsics on the host); with a shard,
    over this rank's slice of the whole list's draws."""
    if shard is None:
        return anchor_ops.ransac_fit_planes(data, state, *sweep_list,
                                            generator=gen, cam=cam)
    n = sweep_list[0].shape[0]
    triplets = anchor_ops.ransac_draws(gen, n, data.device)
    sl, counts = shard.list_part(n)
    fit = anchor_ops.ransac_fit_planes(data, state,
                                       *(a[sl] for a in sweep_list),
                                       triplets=triplets[:, sl], cam=cam)
    return shard.gather(fit, counts)


def pass_sweeps(data: CostData, state: PMState, cfg: PassStatic, dmin, dmax,
                gen: torch.Generator, *, shard=None):
    """Stage 1. ``state`` is `prior_state`'s; returns (post-sweep state
    with planes = (world normal, depth), the pass's `WeakSet` or None)."""
    params = cfg.params
    # the colour update K3, the weak sweep's K7 and the APD setup's K8 take
    # their scalars as Python floats, K8 and K9 the reference camera's
    # intrinsics: read once a pass, so that no launch waits on the device
    gf, dmin_f, dmax_f = _sweep_constants(params, dmin, dmax)
    cam = None

    # ---- APD setup: weak list, anchors, demotion --------------------------
    weak = None
    if cfg.use_apd:
        wy, wx = torch.nonzero(state.weak == WEAK, as_tuple=True)
        if wx.numel() > 0:
            wx = wx.to(torch.int32)
            wy = wy.to(torch.int32)
            cam = anchor_ops.host_camera(data.ref_cam)
            ns = anchor_ops.nearest_strong_jfa(state.weak, state.confidence,
                                               state.valid)
            res = _anchors(data, state, wx, wy, params, dmin_f, dmax_f, ns,
                           gen, shard, cam)
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
        *(weak[:3] if weak is not None else ()), shard=shard)
    state = _iterations(data, state, cfg, weak, (dmin_f, dmax_f, gf), cam,
                        gen, shard)
    state = state.replace(planes=filters.planes_to_depth_normal(
        data, state.planes))
    for color in (0, 1):
        state = filters.median_filter_color(state, color)
    return state, weak


def _iterations(data: CostData, state: PMState, cfg: PassStatic, weak,
                consts: tuple, cam, gen: torch.Generator, shard) -> PMState:
    """Stage 1's iterations: the strong sweep's two colours, then [APD] the
    fit-plane RANSAC and the weak sweep. ``consts`` are `_sweep_constants`'
    depth bounds and geometric factor, ``cam`` the reference camera's
    intrinsics on the host (`anchor_ops.host_camera`; None without APD or
    on the CPU), both read once a pass."""
    dmin_f, dmax_f, gf = consts
    for it in range(cfg.params.max_iterations):
        for color in (0, 1):
            state = propagate_strong(data, state, cfg.prop, it, color,
                                     dmin_f, dmax_f, gf, generator=gen,
                                     shard=shard)
        if weak is not None and weak.sweep[0].numel() > 0:
            fit = _fit_planes(data, state, weak.sweep, gen, shard, cam)
            state = propagate_weak(data, state, cfg.prop, it, *weak.sweep,
                                   fit, dmin_f, dmax_f, gf, generator=gen,
                                   shard=shard)
    return state


def _row_chunks(fn, mask: torch.Tensor, shard, fill: torch.Tensor):
    """``fn(x, y)`` over ``mask``'s pixels in this rank's rows (raster
    order, chunks of ``CHUNK``), written into ``fill``'s copy of those rows;
    the row blocks are all-gathered into the whole map. Returns (the map,
    the evaluated (ys, xs), the per-chunk outputs)."""
    h, w = mask.shape
    sl, counts = (slice(0, h), None) if shard is None \
        else shard.row_part(h, 1)
    ys, xs = torch.nonzero(mask[sl], as_tuple=True)
    ys = (ys + sl.start).to(torch.int32)
    xs = xs.to(torch.int32)
    outs = [fn(xs[i:i + CHUNK], ys[i:i + CHUNK])
            for i in range(0, xs.numel(), CHUNK)]
    block = fill[sl].clone()
    if outs:
        vals = torch.cat([o[0] if isinstance(o, tuple) else o for o in outs])
        block[ys.long() - sl.start, xs.long()] = vals.to(block.dtype)
    full = block if shard is None else shard.gather(block, counts)
    return full, (ys.long(), xs.long()), outs


def sweepable(data: CostData, state: PMState) -> torch.Tensor:
    """Pixels the classify / refine sweeps can score: real pixels with a
    depth and a non-empty view selection (the guard conditions of
    DepthToWeak, APD.cu:2107-2119)."""
    return state.valid & (state.planes[..., 3] != 0.0) \
        & state.selected.any(-1)


def _sweep_constants(params, dmin, dmax) -> tuple:
    """The geometric factor and the depth bounds as Python floats (float32
    values) for the launches of the sweep kernel K5, the colour-update
    kernel K3, the weak sweep's K7 and the anchor kernel K8: read once a
    stage, not once a chunk or colour, so no launch waits on the device."""
    return tuple(float(geo.f32_scalar(v, "cpu"))
                 for v in (params.geom_factor, dmin, dmax))


def _stage_state(data: CostData, state: PMState) -> PMState:
    """The state with the maps K5's stage form reads contiguous, and its
    per-CostData tables (the camera table, the views' distances) made:
    once a stage, so that each chunk is one launch and nothing more."""
    k5.cached_camera_table(data)
    k5.cached_view_distances(data)
    return state.replace(planes=state.planes.contiguous(),
                         selected=state.selected.contiguous(),
                         view_weights=state.view_weights.contiguous(),
                         valid=state.valid.contiguous())


def pass_classify(data: CostData, state: PMState, cfg: PassStatic, dmin,
                  dmax, *, shard=None, export_curve: bool = False):
    """Stage 2: the reclassified (H, W) int32 weak map, and with
    ``export_curve`` the (H, W, 61) reliability curves of every pixel (a
    debug mode: every pixel is swept, the extra ones come out UNKNOWN, as
    the reference's exporter does). Pixels the sweep would classify
    UNKNOWN without sampling anything (margins, padding, zero depth, empty
    selection) are skipped otherwise. The depth bounds are best Python
    numbers (`full_pass` reads them once a pass)."""
    if export_curve and shard is not None:
        raise ValueError("curve export runs on the serial pass only")
    h, w = data.height, data.width
    dev = data.device
    params = cfg.params
    gf, dmin, dmax = _sweep_constants(params, dmin, dmax)
    xs, ys = geo.pixel_grid(h, w, dev)
    margin = (xs < MIN_MARGIN) | (ys < MIN_MARGIN) \
        | (xs >= data.img_w - MIN_MARGIN) | (ys >= data.img_h - MIN_MARGIN)
    mask = torch.ones((h, w), dtype=torch.bool, device=dev) if export_curve \
        else sweepable(data, state) & ~margin
    state = _stage_state(data, state)

    def classify(cx, cy):
        return filters.depth_to_weak(
            data, state, cx, cy, params.weak_peak_radius,
            cfg.prop.geom_consistency, gf, dmin, dmax, cfg.prop.strong_radius,
            cfg.prop.strong_increment, return_curve=export_curve,
            use_sa=cfg.prop.use_sa)

    weak_map, (cy, cx), outs = _row_chunks(
        classify, mask, shard,
        torch.full((h, w), UNKNOWN, dtype=torch.int32, device=dev))
    curve = None
    if export_curve and outs:
        curve = torch.zeros((h, w, outs[0][1].shape[-1]), dtype=torch.float32,
                            device=dev)
        curve[cy, cx] = torch.cat([o[1] for o in outs])
    return weak_map, curve


def pass_finish(data: CostData, state: PMState, cfg: PassStatic, dmin, dmax,
                *, shard=None) -> PMState:
    """Stage 3: confidence + local refine. ``state.weak`` must already hold
    stage 2's reclassification; the depth bounds as in `pass_classify`."""
    params = cfg.params
    gf, dmin, dmax = _sweep_constants(params, dmin, dmax)
    refine_mask = sweepable(data, state)
    if params.geom_consistency or cfg.use_apd:
        state = filters.compute_confidence(data, state)
    swept = _stage_state(data, state)

    def refine(cx, cy):
        return filters.local_refine(
            data, swept, cx, cy, cfg.prop.geom_consistency, gf, dmin, dmax,
            cfg.prop.strong_radius, cfg.prop.strong_increment,
            use_sa=cfg.prop.use_sa)

    depth, _, _ = _row_chunks(refine, refine_mask, shard,
                              state.planes[..., 3])
    return state.replace(planes=torch.cat([state.planes[..., :3],
                                           depth[..., None]], -1))


def full_pass(data: CostData, state: PMState, cfg: PassStatic, dmin, dmax,
              gen: torch.Generator, *, shard=None, export_curve: bool = False):
    """The three stages in order. Returns (the final state: planes =
    (world normal, refined depth), the reclassified weak map, confidence;
    the pass's `WeakSet` or None; the reliability curves of
    ``export_curve`` or None)."""
    state, weak = pass_sweeps(data, state, cfg, dmin, dmax, gen, shard=shard)
    # the classify and refine stages' depth bounds, read to the host once
    _, dmin, dmax = _sweep_constants(cfg.params, dmin, dmax)
    weak_map, curve = pass_classify(data, state, cfg, dmin, dmax,
                                    shard=shard, export_curve=export_curve)
    state = pass_finish(data, state.replace(weak=weak_map), cfg, dmin, dmax,
                        shard=shard)
    return state, weak, curve
