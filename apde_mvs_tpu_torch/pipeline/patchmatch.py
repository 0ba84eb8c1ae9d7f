"""Per-view PatchMatch engine — the device-side orchestration of one pass
(reference: APD::RunPatchMatch, APD.cu:2663-2737), without the APD weak
path.

One pass:

1.  initialization (random planes or loaded depth/normal) + initial cost and
    top-k view selection
2.  max_iterations x strong sweep (black, red)
3.  plane -> (world normal, depth); strong median filter (black, red)
4.  reliability reclassification (DepthToWeak), over the pixels the sweep
    would not mark UNKNOWN without sampling, in fixed chunks
5.  [geom] confidence; local refine, chunked the same way
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import UNKNOWN, PatchMatchParams
from ..core import geometry as geo
from ..ops import filters, init as init_ops
from ..ops.cost import CostData
from ..ops.propagation import PropCfg, propagate_strong
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
    valid: Optional[torch.Tensor] = None,
    depth_min: float,
    depth_max: float,
    seed: int = 0,
) -> PatchMatchOutputs:
    """Run one full PatchMatch pass for one reference view.

    `data` carries the (padded) images/cameras/depths; priors are the loaded
    previous-iteration maps at the same padded resolution. The pass's random
    draws come from a torch.Generator seeded with ``seed`` on data's device.
    """
    first_init = params.state == "first_init"
    if params.use_apd and not first_init:
        raise NotImplementedError(
            "APD passes (use_apd with refine_init/refine_iter: anchors, "
            "fit-plane RANSAC, deformable NCC, weak sweeps) belong to the APD "
            "slice of the port, which is not ported yet")
    h, w = data.height, data.width
    dev = data.device
    cfg = PropCfg(
        geom_consistency=bool(params.geom_consistency),
        use_impetus=bool(params.use_impetus),
        refine_init=(params.state == "refine_init"),
        strong_radius=params.strong_radius,
        strong_increment=params.strong_increment)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dmin = geo.f32_scalar(depth_min, dev)
    dmax = geo.f32_scalar(depth_max, dev)
    gf = geo.f32_scalar(params.geom_factor, dev)

    state = PMState.create(h, w, data.num_src, valid=valid, device=dev)

    # ---- init + iterations ------------------------------------------------
    if first_init:
        planes = init_ops.random_planes(data, dmin, dmax, generator=gen)
    else:
        planes = filters.depth_normal_to_planes(
            data, torch.as_tensor(prior_depth, device=dev),
            torch.as_tensor(prior_normal, device=dev))
    state = init_ops.initial_cost(data, state.replace(planes=planes), params)
    for it in range(params.max_iterations):
        for color in (0, 1):
            state = propagate_strong(data, state, cfg, it, color, dmin, dmax,
                                     gf, generator=gen)
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
            cfg.strong_increment)[0]

    weak_map = torch.full((h, w), UNKNOWN, dtype=torch.int32, device=dev)
    res = _chunked(classify, sweepable & ~margin)
    if res is not None:
        cy_, cx_, outs = res
        weak_map[cy_, cx_] = torch.cat(outs)
    state = state.replace(weak=weak_map)

    # ---- confidence + local refine ----------------------------------------
    if params.geom_consistency:
        state = filters.compute_confidence(data, state)

    def refine(cx, cy):
        return filters.local_refine(
            data, state, cx, cy, cfg.geom_consistency, gf, dmin, dmax,
            cfg.strong_radius, cfg.strong_increment)

    res = _chunked(refine, sweepable)
    if res is not None:
        ry, rx, outs = res
        depth_map = depth_map.clone()
        depth_map[ry, rx] = torch.cat(outs)
        state = state.replace(planes=torch.cat(
            [state.planes[..., :3], depth_map[..., None]], -1))

    planes_np = state.planes.cpu().numpy()
    return PatchMatchOutputs(
        depth=planes_np[..., 3].copy(),
        normal=planes_np[..., :3].copy(),
        weak=state.weak.cpu().numpy().astype(np.uint8),
        confidence=np.clip(state.confidence.cpu().numpy(), 0, 255
                           ).astype(np.uint8),
        cost=state.costs.cpu().numpy(),
    )
