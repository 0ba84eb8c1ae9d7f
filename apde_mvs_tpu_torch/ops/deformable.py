"""Deformable (anchor-based) NCC for weak-texture pixels.

The reference's ComputeBilateralNCCNew (APD.cu:448-593): a weak pixel's
cost against a source view aggregates NCC over up to 9 anchors — anchor 0
is the pixel itself with the dense strong window, anchors 1..8 are distant
strong supports with sparse windows — all warped by the *candidate
plane's* homography, combined with a focal softmax weighting so bad
anchors dominate, then blended 0.25*center + 0.75*strong.

All reference-side quantities (anchor positions, tap values, SA gating,
window sums) depend only on the pixel, so `WeakRefData.build` hoists them
out of the per-candidate / per-view loops. `ncc_weak` evaluates one plane
per pixel against all S views at once: one K1 launch samples the
(S, B, 36) centre taps and one the (S, B, 8, 9) anchor taps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import geometry as geo
from ..core.sampling import bilinear_sample_packed, clamped_fetch, fetch
from .cost import COST_MAX, CostData, RefWindow, ncc_from_sums, \
    precompute_ref_window, square_taps, window_sums


class WeakRefData(NamedTuple):
    """Pixel-batch precomputation for deformable NCC (B weak pixels)."""

    x: torch.Tensor            # (B,) f32 pixel coords
    y: torch.Tensor
    center_win: RefWindow      # strong square window (SA per-tap skip)
    anchor_x: torch.Tensor     # (B, 8) f32, -1 where missing
    anchor_y: torch.Tensor     # (B, 8)
    anchor_valid: torch.Tensor  # (B, 8) bool (exists + same SA segment)
    anchor_sel: torch.Tensor   # (B, 8, S) bool: selected views at the anchor
    tap_val: torch.Tensor      # (B, 8, T) ref values around anchors
    tap_w: Optional[torch.Tensor]  # (B, 8, T) SA 0/1 weights; None = all 1
    sum_ref: torch.Tensor      # (B, 8)
    sum_rr: torch.Tensor       # (B, 8)
    wsum: torch.Tensor         # (B, 8)

    @staticmethod
    def build(data: CostData, x, y, anchors, selected,
              params) -> "WeakRefData":
        """anchors: (B, 9, 2) int32 (x, y), -1 invalid; anchors[:, 0] is the
        pixel itself. selected: (H, W, S) bool selected-views state.
        ``params`` carries the window radii / increments and ``use_sa``."""
        use_sa = bool(params.use_sa) and data.sa_mask is not None
        dev = x.device
        xi = x.to(torch.int32)
        yi = y.to(torch.int32)

        # center window: strong square taps with SA per-tap skip (no star,
        # no truncation — NCC-New `continue` semantics, APD.cu:523-541)
        if use_sa:
            center_sa = fetch(data.sa_mask, xi, yi)
            in_seg = center_sa > 0

            def sa_weights(tx, ty):
                extra = (1,) * (tx.ndim - 1)
                keep = ~in_seg.reshape(in_seg.shape + extra) \
                    | (fetch(data.sa_mask, tx, ty)
                       == center_sa.reshape(center_sa.shape + extra))
                return keep.to(torch.float32)

            sq = torch.as_tensor(square_taps(params.strong_radius,
                                             params.strong_increment),
                                 device=dev)
            ctx = xi[..., None] + sq[:, 0]
            cty = yi[..., None] + sq[:, 1]
            cval = clamped_fetch(data.ref_image, ctx, cty)
            cw = sa_weights(ctx, cty)
            center_win = RefWindow(
                sq[:, 0].to(torch.float32), sq[:, 1].to(torch.float32), cval,
                (cw * cval).sum(-1), (cw * cval * cval).sum(-1), cw.sum(-1),
                cw)
        else:
            center_win = precompute_ref_window(data, x, y,
                                               params.strong_radius,
                                               params.strong_increment)

        ax = anchors[..., 1:, 0]
        ay = anchors[..., 1:, 1]
        exists = (ax >= 0) & (ay >= 0)
        axc = torch.clamp(ax, min=0)
        ayc = torch.clamp(ay, min=0)
        valid = exists
        if use_sa:
            valid = exists & (~in_seg[..., None]
                              | (fetch(data.sa_mask, axc, ayc)
                                 == center_sa[..., None]))
        sel = fetch(selected, axc, ayc)                       # (B, 8, S)

        wk = torch.as_tensor(square_taps(params.weak_radius,
                                         params.weak_increment), device=dev)
        tx = axc[..., None] + wk[:, 0]
        ty = ayc[..., None] + wk[:, 1]
        tval = clamped_fetch(data.ref_image, tx, ty)          # (B, 8, T)
        if use_sa:
            tw = sa_weights(tx, ty)
            sums = ((tw * tval).sum(-1), (tw * tval * tval).sum(-1),
                    tw.sum(-1))
        else:
            tw = None
            sums = (tval.sum(-1), (tval * tval).sum(-1),
                    torch.full(tval.shape[:-1], float(wk.shape[0]),
                               device=dev))
        return WeakRefData(
            x=x, y=y, center_win=center_win,
            anchor_x=ax.to(torch.float32), anchor_y=ay.to(torch.float32),
            anchor_valid=valid, anchor_sel=sel, tap_val=tval, tap_w=tw,
            sum_ref=sums[0], sum_rr=sums[1], wsum=sums[2])


def _softmax_weighted(costs, mask):
    """Focal weighting: softmax over contributing anchor costs times the
    costs (reference: Softmax + weighted sum, APD.cu:431-446, 576-585)."""
    neg = torch.where(mask, costs, -torch.inf)
    m = torch.amax(neg, dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(costs - m), 0.0)
    denom = e.sum(-1)
    strong_cost = torch.where(
        denom > 0, (e * costs).sum(-1) / torch.clamp(denom, min=1e-30), 0.0)
    return torch.clamp(strong_cost, max=COST_MAX)


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
