"""Per-view PatchMatch engine — the device-side orchestration of one pass
(reference: APD::RunPatchMatch, APD.cu:2663-2737).

`run_patchmatch` runs `pipeline.full_pass` (three stages: sweeps,
reliability classification, confidence + local refine) on one view and
returns its maps as numpy arrays. The weak set is fixed for the pass (as in
the reference), so the weak list is compacted once, on the device.

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

from ..config import PatchMatchParams
from ..core import geometry as geo
from ..ops import anchors as anchor_ops
from ..ops import filters
from ..ops.cost import CostData
from .full_pass import PassStatic, full_pass, prior_state


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
    shard=None,
) -> PatchMatchOutputs:
    """Run one full PatchMatch pass for one reference view.

    `data` carries the (padded) images/cameras/depths; priors are the loaded
    previous-iteration maps at the same padded resolution (the weak map and
    confidence feed the APD setup). The pass's random draws come from a
    torch.Generator seeded with ``seed`` on data's device; the debug fit of
    ``export_debug`` draws from one seeded with ``seed ^ 0x5F17``.
    ``shard`` (`parallel.tile_pass.RowShard`) runs the pass row-sharded
    over its process group; every rank returns the whole view's maps.
    """
    dev = data.device
    h, w = data.height, data.width
    cfg = PassStatic.from_params(params)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dmin = geo.f32_scalar(depth_min, dev)
    dmax = geo.f32_scalar(depth_max, dev)

    state = prior_state(data, cfg, prior_depth=prior_depth,
                        prior_normal=prior_normal, prior_weak=prior_weak,
                        prior_confidence=prior_confidence, valid=valid)
    state, weak, curve = full_pass(data, state, cfg, dmin, dmax, gen,
                                   shard=shard, export_curve=export_curve)

    anchors_map = nearest_strong = fit_normal = None
    if weak is not None:
        anchors_map = np.full((h, w), -1, np.int32)
        anchors_map[weak.y.cpu().numpy(), weak.x.cpu().numpy()] = np.arange(
            weak.x.numel(), dtype=np.int32)
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
            data, state.replace(planes=cam_planes), *weak[:3],
            generator=debug_gen).cpu().numpy()

    planes_np = state.planes.cpu().numpy()
    return PatchMatchOutputs(
        depth=planes_np[..., 3].copy(),
        normal=planes_np[..., :3].copy(),
        weak=state.weak.cpu().numpy().astype(np.uint8),
        confidence=np.clip(state.confidence.cpu().numpy(), 0, 255
                           ).astype(np.uint8),
        cost=state.costs.cpu().numpy(),
        anchors=None if weak is None else weak.anchors.cpu().numpy(),
        anchors_map=anchors_map,
        reliable_curve=None if curve is None else curve.cpu().numpy(),
        nearest_strong=nearest_strong,
        fit_normal=fit_normal,
    )
