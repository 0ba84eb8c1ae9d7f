"""Per-pass state initialization (reference: RandomInitialization,
APD.cu:919-948): FIRST_INIT draws random plane hypotheses; later passes
convert the loaded (world normal, depth) maps into camera-frame planes. Both
then compute the initial multi-view cost and top-k view selection, on the
card K2's stage form and K6's re-score form, each with the selection in its
epilogue (the tile route: their cost-out modes and K11). The torch-op
composition they replaced is ``testing/init_composition.py``."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import geometry as geo
from .cost import CostData
from .cuda import ncc as k2
from .cuda import select as k11
from .cuda import weak as k6
from .state import PMState

# pixels per evaluation of the plain versions on the CPU (the JAX engine's
# chunks): they bound the (chunk, S, taps) intermediates; the result does
# not depend on them. The card takes the image's pixels in one launch and
# the weak list in launches of WEAK_CHUNK.
CHUNK = 1 << 19
WEAK_CHUNK = 1 << 16


class PlaneDraws(NamedTuple):
    """Raw draws of `random_planes`: u (H, W) uniform [0, 1) -> depth,
    g (H, W, 3) standard normal -> facing normal."""

    u: torch.Tensor
    g: torch.Tensor


def plane_draws(generator: torch.Generator, height: int, width: int,
                device) -> PlaneDraws:
    return PlaneDraws(
        torch.rand((height, width), generator=generator, device=device),
        torch.randn((height, width, 3), generator=generator, device=device))


def random_planes(data: CostData, depth_min, depth_max,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[PlaneDraws] = None) -> torch.Tensor:
    """(H, W, 4) random plane hypotheses, from ``draws`` when given, else
    drawn from ``generator``."""
    h, w = data.height, data.width
    if draws is None:
        draws = plane_draws(generator, h, w, data.device)
    xs, ys = geo.pixel_grid(h, w, data.device)
    return geo.random_plane_from_draws(draws.u, draws.g, data.ref_cam, xs, ys,
                                       depth_min, depth_max)


def initial_cost(data: CostData, state: PMState, params, weak_x=None,
                 weak_y=None, anchors=None, shard=None) -> PMState:
    """Initial cost + top-k selected views for the whole image (reference:
    ComputeMultiViewInitialCostandSelectedViews, APD.cu:723-774). Given a
    weak list (``weak_x``, ``weak_y`` (Nw,) int32, ``anchors`` (Nw, 9, 2)),
    those pixels are re-scored with the deformable NCC before the view
    selection (the APD passes).

    On the card the stage is K2's stage form and K6's re-score form and no
    torch op but the outputs' allocations: one launch of K2's stage form
    over the image's pixels (each pixel's window built once in the kernel),
    whose epilogue writes every pixel's selection into the state's new cost
    map and selections, then one launch of K6's re-score form a WEAK_CHUNK
    of the weak list, whose epilogue writes its pixels' selections over
    K2's; no per-view costs go through device memory. On the CPU the same
    entries run as their plain versions, K2's over CHUNK pixels at a time.
    ``shard`` (`parallel.tile_pass.RowShard`) scores only its rank's rows
    and slice of the weak list in the two forms' cost-out modes, gathers
    the (H W, S) costs, places the re-scored ones with one ``index_put``
    and selects on the whole image with K11 on every rank. The maps the
    kernels read (the planes, the prior selections, the validity) must be
    contiguous."""
    h, w, s = data.height, data.width, data.num_src
    card = data.device.type == "cuda"
    planes = state.planes
    window = dict(radius=params.strong_radius,
                  increment=params.strong_increment,
                  use_sa=bool(params.use_sa))
    rescore = dict(strong_radius=params.strong_radius,
                   strong_increment=params.strong_increment,
                   weak_radius=params.weak_radius,
                   weak_increment=params.weak_increment,
                   use_sa=bool(params.use_sa))
    n = 0 if weak_x is None else weak_x.shape[0]
    if shard is None:
        cost_map = torch.empty((h, w), dtype=torch.float32,
                               device=data.device)
        selected = torch.empty((h, w, s), dtype=torch.bool,
                               device=data.device)
        step = max(h * w, 1) if card else CHUNK
        for i in range(0, h * w, step):
            k2.init_stage_select_fused(data, planes, i, min(i + step, h * w),
                                       state.valid, params.top_k, cost_map,
                                       selected, **window)
        for i in range(0, n, WEAK_CHUNK):
            k6.rescore_select_fused(data, planes, state.selected, weak_x,
                                    weak_y, anchors, i,
                                    min(i + WEAK_CHUNK, n), state.valid,
                                    params.top_k, cost_map, selected,
                                    **rescore)
        return state.replace(costs=cost_map, selected=selected)
    sl, counts = shard.row_part(h, w)
    lo, hi = sl.start, sl.stop
    costs = torch.empty((hi - lo, s), dtype=torch.float32,
                        device=data.device)
    step = max(hi - lo, 1) if card else CHUNK
    for i in range(lo, hi, step):
        k2.init_stage_fused(data, planes, i, min(i + step, hi), costs,
                            view_major=False, col0=lo, **window)
    costs = shard.gather(costs, counts)
    if weak_x is not None:
        wsl, wcounts = shard.list_part(n)
        part = torch.empty((wsl.stop - wsl.start, s), dtype=torch.float32,
                           device=data.device)
        for i in range(wsl.start, wsl.stop, WEAK_CHUNK):
            k6.rescore_fused(data, planes, state.selected, weak_x, weak_y,
                             anchors, i, min(i + WEAK_CHUNK, wsl.stop), part,
                             view_major=False, col0=wsl.start, **rescore)
        costs.view(h, w, s)[weak_y, weak_x] = shard.gather(part, wcounts)
    cost_map, selected = k11.select_fused(costs, False, state.valid,
                                          params.top_k)
    return state.replace(costs=cost_map, selected=selected)
