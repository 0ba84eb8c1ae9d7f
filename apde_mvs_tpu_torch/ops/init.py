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
from .deformable import WeakRefData, ncc_weak
from .state import PMState

# pixels per initial-cost evaluation (the JAX engine's chunks): they bound
# the (chunk, S, taps) intermediates; the result does not depend on them
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
    selection (the APD passes): one K6 launch a chunk of WEAK_CHUNK. ``shard`` (`parallel.tile_pass.RowShard`)
    scores only its rank's rows and slice of the weak list and all-gathers
    the costs; the selection then runs on the whole image on every rank."""
    h, w = data.height, data.width
    xs, ys = geo.pixel_grid(h, w, data.device)
    xf = xs.reshape(-1)
    yf = ys.reshape(-1)
    planes = state.planes.reshape(-1, 4)
    use_sa = bool(params.use_sa)
    sl, counts = (slice(0, h * w), None) if shard is None \
        else shard.row_part(h, w)

    def strong(lo, hi):
        return ncc_strong(data, xf[lo:hi], yf[lo:hi], planes[lo:hi],
                          precompute_ref_window(data, xf[lo:hi], yf[lo:hi],
                                                params.strong_radius,
                                                params.strong_increment,
                                                use_sa), site="init")
    costs = torch.cat([strong(i, min(i + CHUNK, sl.stop))
                       for i in range(sl.start, sl.stop, CHUNK)])
    if shard is not None:
        costs = shard.gather(costs, counts)
    if weak_x is not None:
        flat = weak_y.long() * w + weak_x.long()
        n = weak_x.shape[0]
        wsl, wcounts = (slice(0, n), None) if shard is None \
            else shard.list_part(n)

        def weak(lo, hi):
            wref = WeakRefData.build(
                data, weak_x[lo:hi].to(torch.float32),
                weak_y[lo:hi].to(torch.float32), anchors[lo:hi],
                state.selected, params)
            return ncc_weak(data, wref, planes[flat[lo:hi]], params)
        parts = [weak(i, min(i + WEAK_CHUNK, wsl.stop))
                 for i in range(wsl.start, wsl.stop, WEAK_CHUNK)]
        wcosts = torch.cat(parts) if parts else costs[:0]
        if shard is not None:
            wcosts = shard.gather(wcosts, wcounts)
        costs[flat] = wcosts
    mean_cost, selected = initial_cost_and_selection(costs, params.top_k)
    return state.replace(
        costs=torch.where(state.valid, mean_cost.reshape(h, w), 1e9),
        selected=selected.reshape(h, w, -1) & state.valid[..., None])
