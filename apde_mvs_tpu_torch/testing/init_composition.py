"""The initial cost as the port ran it before its stage kernels, kept as the
one witness that both the CPU tests and ``chip_smoke.py`` hold K2's stage
form, K6's re-score form, K11 and their plain versions against.

``init_composition`` is the old ``ops/init.py`` ``initial_cost``,
unchanged: the reference window as torch ops over CHUNK pixels at a time
(``cost.precompute_ref_window``: index tables, segment fetches, the SA
star's ``cumsum``, three ``where``s, a clamped fetch, three sums), one K2
launch of the sweep form a chunk at site "init"; for the weak list
``deformable.WeakRefData.build`` (~40 torch ops writing the (B, 36) and
(B, 8, 9) tap tables, SA weights, anchor masks, selections and sums) and
one K6 launch a WEAK_CHUNK, the scatter ``costs[flat] = wcosts``; then
``cost.initial_cost_and_selection`` (a ``torch.sort`` and a dozen torch
ops) and two ``where``s into the state. It differs from the stage's plain
versions only in the order of the reference window's sums (torch's
reductions against sums in tap order), so the two agree to float
tolerance, a pixel whose selection sits on a float tie aside.
"""

from __future__ import annotations

import torch

from ..core import geometry as geo
from ..ops.cost import CostData, initial_cost_and_selection, ncc_strong, \
    precompute_ref_window
from ..ops.deformable import WeakRefData, ncc_weak
from ..ops.init import CHUNK, WEAK_CHUNK
from ..ops.state import PMState


def init_composition(data: CostData, state: PMState, params, weak_x=None,
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
