"""The deformable NCC of the weak sweep as the port ran it before K6, kept as
the one witness that both the CPU tests and ``chip_smoke.py`` hold K6 and
its plain version against.

``weak_taps`` and ``ncc_weak`` are the old ``ops/deformable.py`` functions,
unchanged: each plane hypothesis warps the pixel, its centre window, its
anchors and their sparse windows into all S views as torch ops, samples
them with two K1 launches on the card (the (S, B, 36) centre taps at site
"weak_centre", the (S, B, 8, 9) anchor taps at "weak_anchor"), and combines
them with ``cost.window_sums``, ``cost.ncc_from_sums`` and
``deformable._softmax_weighted``: ~575 torch ops a plane.
``weak_composition`` runs it for each of P planes, with the torch-op
``cost.geom_cost`` beside it, as ``propagation._weak_body`` did. It differs
from K6's plain version only in the order of its sums (torch's reductions
against Kahan sums in tap order and ordered adds), so the two agree to
float tolerance.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import geometry as geo
from ..core.sampling import bilinear_sample_packed
from ..ops.cost import COST_MAX, CostData, geom_cost, ncc_from_sums, \
    square_taps, window_sums
from ..ops.deformable import WeakRefData, _softmax_weighted


class WeakTaps(NamedTuple):
    """One plane hypothesis per weak pixel warped into all S source views:
    the coordinates K1 samples and the out-of-image tests."""

    center_oob: torch.Tensor   # (S, B) the pixel leaves the image
    cwx: torch.Tensor          # (S, B, T) centre-window taps
    cwy: torch.Tensor
    anchor_oob: torch.Tensor   # (S, B, 8) the anchor leaves the image
    awx: torch.Tensor          # (S, B, 8, T') anchor-window taps
    awy: torch.Tensor


def weak_taps(data: CostData, wref: WeakRefData, plane, params) -> WeakTaps:
    """Warp the pixel, its centre window, its anchors and their sparse
    windows through the homographies of ``plane`` (B, 4)."""
    Hm = geo.homography(data.ref_cam, data.src_views, plane)   # (S, B, 3, 3)
    x, y = wref.x, wref.y
    cx, cy = geo.warp(Hm, x, y)                                 # (S, B)
    center_oob = (cx < 0) | (cx >= data.img_w) | (cy < 0) \
        | (cy >= data.img_h)
    win = wref.center_win
    cwx, cwy = geo.warp(Hm[..., None, :, :], x[:, None] + win.tap_dx,
                        y[:, None] + win.tap_dy)
    awx, awy = geo.warp(Hm[..., None, :, :], wref.anchor_x, wref.anchor_y)
    a_oob = (awx < 0) | (awx >= data.img_w) | (awy < 0) | (awy >= data.img_h)
    wk = torch.as_tensor(square_taps(params.weak_radius,
                                     params.weak_increment),
                         device=x.device).to(torch.float32)
    wx, wy = geo.warp(Hm[..., None, None, :, :],
                      wref.anchor_x[..., None] + wk[:, 0],
                      wref.anchor_y[..., None] + wk[:, 1])
    return WeakTaps(center_oob, cwx.contiguous(), cwy.contiguous(), a_oob,
                    wx.contiguous(), wy.contiguous())


def ncc_weak(data: CostData, wref: WeakRefData, plane, params
             ) -> torch.Tensor:
    """Multi-view deformable NCC cost vector (B, S) of one plane (B, 4) per
    weak pixel (reference: ComputeMultiViewCostVectorNew, APD.cu:809-818,
    over ComputeBilateralNCCNew for every view)."""
    t = weak_taps(data, wref, plane, params)

    # anchor 0 (the pixel) with the strong window: (S, B, T) taps
    win = wref.center_win
    csv = bilinear_sample_packed(data.src_quads, data.width, data.quad_h,
                                 t.cwx, t.cwy, site="weak_centre")
    center_cost = ncc_from_sums(win.sum_ref, win.sum_rr,
                                *window_sums(win.tap_w, win.tap_val, csv),
                                win.wsum)                       # (S, B)

    # anchors 1..8 with sparse windows: (S, B, 8, T') taps
    sv = bilinear_sample_packed(data.src_quads, data.width, data.quad_h,
                                t.awx, t.awy, site="weak_anchor")
    a_cost = ncc_from_sums(wref.sum_ref, wref.sum_rr,
                           *window_sums(wref.tap_w, wref.tap_val, sv),
                           wref.wsum)                           # (S, B, 8)

    # contribution rules (APD.cu:488-571): invalid anchors skip; anchors
    # whose warp leaves the image contribute COST_MAX iff that anchor
    # selected this source view; degenerate windows (wsum == 0) skip
    sel_here = wref.anchor_sel.permute(2, 0, 1)                 # (S, B, 8)
    computable = wref.anchor_valid & ~t.anchor_oob & (wref.wsum > 0)
    contrib = computable | (wref.anchor_valid & t.anchor_oob & sel_here)
    vals = torch.where(computable, a_cost, COST_MAX)
    strong_cost = _softmax_weighted(vals, contrib)
    cost = torch.where(contrib.any(-1),
                       0.25 * center_cost + 0.75 * strong_cost, center_cost)
    return torch.where(t.center_oob, COST_MAX, cost).T


def weak_composition(data: CostData, wref: WeakRefData, planes, params,
                     geom: bool = False):
    """The (B, P, S) deformable NCC costs of P planes (B, P, 4) a pixel, one
    ``ncc_weak`` a plane, and with ``geom`` the (B, P, S) geometric costs,
    one ``cost.geom_cost`` a plane: returns (costs, geometric costs or
    None)."""
    p = planes.shape[1]
    costs = torch.stack([ncc_weak(data, wref, planes[:, c], params)
                         for c in range(p)], 1)
    if not geom:
        return costs, None
    return costs, torch.stack([geom_cost(data, wref.x, wref.y,
                                         planes[:, c]) for c in range(p)], 1)
