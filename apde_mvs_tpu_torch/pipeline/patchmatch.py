"""Per-view PatchMatch engine — the device-side orchestration of one pass
(reference: APD::RunPatchMatch, APD.cu:2663-2737).

One pass:

1.  [APD] nearest-strong transform -> anchor generation over the compacted
    weak list -> demote anchorless weak pixels
2.  initialization (random planes or loaded depth/normal) + initial cost
    ([APD] weak pixels re-scored with the deformable NCC) and top-k view
    selection
3.  max_iterations x { strong sweep (black, red); [APD] fit-plane RANSAC +
    weak sweep }
4.  plane -> (world normal, depth); strong median filter (black, red)
5.  reliability reclassification (DepthToWeak), over the pixels the sweep
    would not mark UNKNOWN without sampling, in fixed chunks
6.  [geom or APD] confidence; local refine, chunked the same way

The weak set is fixed for the pass (as in the reference), so the weak list
is compacted once, on the device.

Debug outputs (the reference's exporters): ``export_curve`` classifies
every pixel (the extra ones come out UNKNOWN) and returns the 61-sample
reliability curves; ``export_debug`` returns the anchors of the whole weak
list and its map, the final nearest-strong map, and one more fit-plane
RANSAC over the weak list on the final planes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import UNKNOWN, WEAK, PatchMatchParams
from ..core import geometry as geo
from ..ops import anchors as anchor_ops
from ..ops import filters, init as init_ops
from ..ops.cost import CostData
from ..ops.propagation import PropCfg, propagate_strong, propagate_weak
from ..ops.state import PMState


def pad_to_multiple(arr: np.ndarray, mh: int, mw: int, mode="edge"):
    h, w = arr.shape[:2]
    ph = (-h) % mh
    pw = (-w) % mw
    if ph == 0 and pw == 0:
        return arr
    pad = [(0, ph), (0, pw)] + [(0, 0)] * (arr.ndim - 2)
    return np.pad(arr, pad, mode=mode)


class PatchMatchOutputs(NamedTuple):
    depth: np.ndarray        # (H, W) f32
    normal: np.ndarray       # (H, W, 3) world-frame
    weak: np.ndarray         # (H, W) uint8
    confidence: np.ndarray   # (H, W) uint8
    cost: np.ndarray         # (H, W) f32
    anchors: Optional[np.ndarray] = None          # (Nw, 9, 2) int32 (APD)
    anchors_map: Optional[np.ndarray] = None      # (H, W) int32, -1 off list
    reliable_curve: Optional[np.ndarray] = None   # (H, W, 61) f32
    nearest_strong: Optional[np.ndarray] = None   # (H, W, 2) int32 debug
    fit_normal: Optional[np.ndarray] = None       # (Nw, 4) debug


# pixels per classify / refine evaluation (the JAX engine's classify chunk):
# bounds the (S, chunk, 36) intermediates; results do not depend on it
CHUNK = 1 << 16


def _chunked(fn, mask: torch.Tensor, chunk: int = CHUNK):
    """Run ``fn(x, y)`` over ``mask``'s pixels (raster order) in chunks of
    ``chunk``; returns (ys, xs, per-chunk outputs) or None when empty."""
    ys, xs = torch.nonzero(mask, as_tuple=True)
    if xs.numel() == 0:
        return None
    xs = xs.to(torch.int32)
    ys = ys.to(torch.int32)
    outs = [fn(xs[i:i + chunk], ys[i:i + chunk])
            for i in range(0, xs.numel(), chunk)]
    return ys.long(), xs.long(), outs


def run_patchmatch(
    data: CostData,
    params: PatchMatchParams,
    *,
    prior_depth: Optional[np.ndarray] = None,
    prior_normal: Optional[np.ndarray] = None,
    prior_weak: Optional[np.ndarray] = None,
    prior_confidence: Optional[np.ndarray] = None,
    valid: Optional[torch.Tensor] = None,
    depth_min: float,
    depth_max: float,
    seed: int = 0,
    export_curve: bool = False,
    export_debug: bool = False,
) -> PatchMatchOutputs:
    """Run one full PatchMatch pass for one reference view.

    `data` carries the (padded) images/cameras/depths; priors are the loaded
    previous-iteration maps at the same padded resolution (the weak map and
    confidence feed the APD setup). The pass's random draws come from a
    torch.Generator seeded with ``seed`` on data's device; the debug fit of
    ``export_debug`` draws from one seeded with ``seed ^ 0x5F17``.
    """
    first_init = params.state == "first_init"
    use_apd = bool(params.use_apd) and not first_init
    h, w = data.height, data.width
    dev = data.device
    cfg = PropCfg(
        geom_consistency=bool(params.geom_consistency),
        use_impetus=bool(params.use_impetus),
        use_sa=bool(params.use_sa),
        refine_init=(params.state == "refine_init"),
        strong_radius=params.strong_radius,
        strong_increment=params.strong_increment,
        weak_radius=params.weak_radius,
        weak_increment=params.weak_increment)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dmin = geo.f32_scalar(depth_min, dev)
    dmax = geo.f32_scalar(depth_max, dev)
    gf = geo.f32_scalar(params.geom_factor, dev)

    state = PMState.create(h, w, data.num_src, valid=valid, device=dev)
    if prior_weak is not None and use_apd:
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

    # ---- APD setup: weak list, anchors, demotion --------------------------
    weak = None
    anchors_map = None
    if use_apd:
        wy, wx = torch.nonzero(state.weak == WEAK, as_tuple=True)
        if wx.numel() > 0:
            anchors_map = np.full((h, w), -1, np.int32)
            anchors_map[wy.cpu().numpy(), wx.cpu().numpy()] = np.arange(
                wx.numel(), dtype=np.int32)
            wx = wx.to(torch.int32)
            wy = wy.to(torch.int32)
            ns = anchor_ops.nearest_strong_jfa(state.weak, state.confidence,
                                               state.valid)
            res = anchor_ops.gen_anchors(
                data, state, wx, wy, params.rotate_time,
                params.ransac_threshold, dmin, dmax, ns, generator=gen)
            state = anchor_ops.neighbor_update(state, wx, wy, res.reliable)
            weak = (wx, wy, res.anchors)
            # demoted pixels are no longer WEAK: the fit and the weak sweep
            # (which write WEAK pixels only) run over the reliable ones
            keep = torch.nonzero(res.reliable, as_tuple=True)[0]
            sweep_list = (wx[keep], wy[keep], res.anchors[keep])

    # ---- init + iterations ------------------------------------------------
    if first_init:
        planes = init_ops.random_planes(data, dmin, dmax, generator=gen)
    else:
        planes = filters.depth_normal_to_planes(
            data, state.planes[..., 3], state.planes[..., :3])
    state = init_ops.initial_cost(
        data, state.replace(planes=planes), params,
        *(weak if weak is not None else ()))
    for it in range(params.max_iterations):
        for color in (0, 1):
            state = propagate_strong(data, state, cfg, it, color, dmin, dmax,
                                     gf, generator=gen)
        if weak is not None and sweep_list[0].numel() > 0:
            fit = anchor_ops.ransac_fit_planes(data, state, *sweep_list,
                                               generator=gen)
            state = propagate_weak(data, state, cfg, it, *sweep_list, fit,
                                   dmin, dmax, gf, generator=gen)
    state = state.replace(planes=filters.planes_to_depth_normal(
        data, state.planes))
    for color in (0, 1):
        state = filters.median_filter_color(state, color)

    # ---- reliability classification --------------------------------------
    # Pixels the sweep would classify UNKNOWN without sampling anything
    # (margins, padding, zero depth, empty selection — the guard conditions
    # of DepthToWeak, APD.cu:2107-2119) are skipped.
    min_margin = 6
    xs, ys = geo.pixel_grid(h, w, dev)
    margin = (xs < min_margin) | (ys < min_margin) \
        | (xs >= data.img_w - min_margin) | (ys >= data.img_h - min_margin)
    depth_map = state.planes[..., 3]
    sweepable = state.valid & (depth_map != 0.0) & state.selected.any(-1)

    def classify(cx, cy):
        return filters.depth_to_weak(
            data, state, cx, cy, params.weak_peak_radius,
            cfg.geom_consistency, gf, dmin, dmax, cfg.strong_radius,
            cfg.strong_increment, return_curve=export_curve,
            use_sa=cfg.use_sa)

    # curve export is a debug mode: sweep every pixel so the exported curve
    # covers the whole image, as the reference's exporter does
    cls_mask = torch.ones((h, w), dtype=torch.bool, device=dev) \
        if export_curve else (sweepable & ~margin)
    weak_map = torch.full((h, w), UNKNOWN, dtype=torch.int32, device=dev)
    reliable_curve = None
    res = _chunked(classify, cls_mask)
    if res is not None:
        cy_, cx_, outs = res
        weak_map[cy_, cx_] = torch.cat([o[0] for o in outs])
        if export_curve:
            curve = torch.zeros((h, w, outs[0][1].shape[-1]),
                                dtype=torch.float32, device=dev)
            curve[cy_, cx_] = torch.cat([o[1] for o in outs])
            reliable_curve = curve.cpu().numpy()
    state = state.replace(weak=weak_map)

    # ---- confidence + local refine ----------------------------------------
    if params.geom_consistency or use_apd:
        state = filters.compute_confidence(data, state)

    def refine(cx, cy):
        return filters.local_refine(
            data, state, cx, cy, cfg.geom_consistency, gf, dmin, dmax,
            cfg.strong_radius, cfg.strong_increment, use_sa=cfg.use_sa)

    res = _chunked(refine, sweepable)
    if res is not None:
        ry, rx, outs = res
        depth_map = depth_map.clone()
        depth_map[ry, rx] = torch.cat(outs)
        state = state.replace(planes=torch.cat(
            [state.planes[..., :3], depth_map[..., None]], -1))

    nearest_strong = fit_normal = None
    if export_debug and weak is not None:
        # the reference's (unused) exporters ExportNearestStrong /
        # ExportFitNormal (APD.cu:2600-2649), over the whole weak list
        nearest_strong = anchor_ops.nearest_strong_jfa(
            state.weak, state.confidence, state.valid).cpu().numpy()
        cam_planes = filters.depth_normal_to_planes(
            data, state.planes[..., 3], state.planes[..., :3])
        debug_gen = torch.Generator(device=dev)
        debug_gen.manual_seed(seed ^ 0x5F17)
        fit_normal = anchor_ops.ransac_fit_planes(
            data, state.replace(planes=cam_planes), *weak,
            generator=debug_gen).cpu().numpy()

    planes_np = state.planes.cpu().numpy()
    return PatchMatchOutputs(
        depth=planes_np[..., 3].copy(),
        normal=planes_np[..., :3].copy(),
        weak=state.weak.cpu().numpy().astype(np.uint8),
        confidence=np.clip(state.confidence.cpu().numpy(), 0, 255
                           ).astype(np.uint8),
        cost=state.costs.cpu().numpy(),
        anchors=None if weak is None else weak[2].cpu().numpy(),
        anchors_map=anchors_map,
        reliable_curve=reliable_curve,
        nearest_strong=nearest_strong,
        fit_normal=fit_normal,
    )
