"""Per-pass state initialization (reference: RandomInitialization,
APD.cu:919-948): FIRST_INIT draws random plane hypotheses; later passes
convert the loaded (world normal, depth) maps into camera-frame planes. Both
then compute the initial multi-view cost and top-k view selection: K2's
and K6's plain stage forms, each with the selection."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import geometry as geo
from .cost import CostData
from .stages import ncc as k2
from .stages import weak as k6
from .state import PMState

# pixels per evaluation (the JAX engine's chunks): they bound the (chunk,
# S, taps) intermediates; the result does not depend on them
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
                 weak_y=None, anchors=None) -> PMState:
    """Initial cost + top-k selected views for the whole image (reference:
    ComputeMultiViewInitialCostandSelectedViews, APD.cu:723-774). Given a
    weak list (``weak_x``, ``weak_y`` (Nw,) int32, ``anchors`` (Nw, 9, 2)),
    those pixels are re-scored with the deformable NCC before the view
    selection (the APD passes): K2's plain stage form with the selection
    over CHUNK pixels at a time, then K6's plain re-score form with the
    selection a WEAK_CHUNK of the weak list at a time, over K2's."""
    h, w, s = data.height, data.width, data.num_src
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
    cost_map = torch.empty((h, w), dtype=torch.float32, device=data.device)
    selected = torch.empty((h, w, s), dtype=torch.bool, device=data.device)
    for i in range(0, h * w, CHUNK):
        hi = min(i + CHUNK, h * w)
        cost, sel = k2.init_stage_select_plain(
            data, planes, i, hi, state.valid, params.top_k, **window)
        cost_map.view(-1)[i:hi] = cost
        selected.view(-1, s)[i:hi] = sel
    for i in range(0, n, WEAK_CHUNK):
        hi = min(i + WEAK_CHUNK, n)
        cost, sel = k6.rescore_select_plain(
            data, planes, state.selected, weak_x[i:hi], weak_y[i:hi],
            anchors[i:hi], state.valid, params.top_k, **rescore)
        yl, xl = weak_y[i:hi].long(), weak_x[i:hi].long()
        cost_map[yl, xl] = cost
        selected[yl, xl] = sel
    return state.replace(costs=cost_map, selected=selected)
