"""Deformable (anchor-based) NCC for weak-texture pixels.

The reference's ComputeBilateralNCCNew (APD.cu:448-593): a weak pixel's
cost against a source view aggregates NCC over up to 9 anchors — anchor 0
is the pixel itself with the dense strong window, anchors 1..8 are distant
strong supports with sparse windows — all warped by the *candidate
plane's* homography, combined with a focal softmax weighting so bad
anchors dominate, then blended 0.25*center + 0.75*strong.

All reference-side quantities (anchor positions, tap values, SA gating,
window sums) depend only on the pixel, so `WeakRefData.build` hoists them
out of the per-candidate / per-view loops. `ncc_weak_planes` evaluates P
planes per pixel against all S views in one launch of the deformable NCC
kernel K6 (ops/cuda/weak.py), with the geometric cost K4 inside when asked
for; `ncc_weak` is its one-plane form. No main path calls them since the
weak sweep's K7 and the initial cost's re-score form of K6 build the same
reference side in the kernel and run K6's per-pair code there
(ops/cuda/weak_sweep.py, `weak.rescore_fused`); the test harnesses and
the compositions those kernels replaced (`testing/weak_composition.py`,
`testing/init_composition.py`) still do.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.sampling import clamped_fetch, device_constant, fetch
from .cost import COST_MAX, CostData, RefWindow, precompute_ref_window, \
    square_taps


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

            sq = device_constant(
                ("square_taps", params.strong_radius,
                 params.strong_increment),
                lambda: square_taps(params.strong_radius,
                                    params.strong_increment), dev)
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

        wk = device_constant(("square_taps", params.weak_radius,
                              params.weak_increment),
                             lambda: square_taps(params.weak_radius,
                                                 params.weak_increment), dev)
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


def contiguous_ref(wref: WeakRefData) -> WeakRefData:
    """``wref`` with every tensor contiguous, as K6 takes it."""
    def c(v):
        return v.contiguous() if isinstance(v, torch.Tensor) else v
    return WeakRefData(*(RefWindow(*map(c, v)) if isinstance(v, RefWindow)
                         else c(v) for v in wref))


def ncc_weak_planes(data: CostData, wref: WeakRefData, planes, params,
                    geom: bool = False, view_weights=None):
    """Multi-view deformable NCC costs (B, P, S) of P planes (B, P, 4) per
    weak pixel (reference: ComputeMultiViewCostVectorNew, APD.cu:809-818,
    over ComputeBilateralNCCNew for every view): one K6 launch on CUDA
    tensors, its plain version on CPU tensors. Returns a
    ``cuda.weak.WeakCosts``: the costs and, with ``geom``, the geometric
    costs (B, P, S), else None. With ``view_weights`` (B, S) only the views
    weighing > 0 are evaluated, the others cost COST_MAX and geometric cost
    0."""
    from .cuda.weak import weak_fused
    return weak_fused(data, contiguous_ref(wref), planes.contiguous(),
                      params.weak_radius, params.weak_increment, geom=geom,
                      view_weights=None if view_weights is None
                      else view_weights.contiguous())


def ncc_weak(data: CostData, wref: WeakRefData, plane, params
             ) -> torch.Tensor:
    """Multi-view deformable NCC cost vector (B, S) of one plane (B, 4) per
    weak pixel: `ncc_weak_planes` with P = 1."""
    return ncc_weak_planes(data, wref, plane[:, None], params).ncc[:, 0]
