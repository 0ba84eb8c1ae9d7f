"""Per-pass state initialization (reference: RandomInitialization,
APD.cu:919-948): FIRST_INIT draws random plane hypotheses; later passes
convert the loaded (world normal, depth) maps into camera-frame planes. Both
then compute the initial multi-view cost and top-k view selection."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import geometry as geo
from .cost import CostData, initial_cost_and_selection, ncc_strong, \
    precompute_ref_window
from .state import PMState


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


def initial_cost(data: CostData, state: PMState, params) -> PMState:
    """Initial cost + top-k selected views for the whole image (reference:
    ComputeMultiViewInitialCostandSelectedViews, APD.cu:723-774). Pixels are
    evaluated in chunks of 2^19 (the JAX engine's chunk) to bound the
    (chunk, S, taps) intermediates; the result does not depend on it."""
    h, w = data.height, data.width
    xs, ys = geo.pixel_grid(h, w, data.device)
    xf = xs.reshape(-1)
    yf = ys.reshape(-1)
    planes = state.planes.reshape(-1, 4)
    chunk = 1 << 19
    costs = torch.cat([
        ncc_strong(data, xf[i:i + chunk], yf[i:i + chunk],
                   planes[i:i + chunk],
                   precompute_ref_window(data, xf[i:i + chunk],
                                         yf[i:i + chunk],
                                         params.strong_radius,
                                         params.strong_increment))
        for i in range(0, h * w, chunk)])
    mean_cost, selected = initial_cost_and_selection(costs, params.top_k)
    return state.replace(
        costs=torch.where(state.valid, mean_cost.reshape(h, w), 1e9),
        selected=selected.reshape(h, w, -1) & state.valid[..., None])
