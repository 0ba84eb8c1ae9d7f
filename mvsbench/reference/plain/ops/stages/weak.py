"""K6's plain version: the deformable NCC of weak pixels, with the
geometric cost inside.

For each weak pixel of a chunk, each of its P plane hypotheses and each
source view (`weak_plain`): the plane homography, the centre's
out-of-image test (COST_MAX outside), the centre window's NCC (36 square
taps, SA 0/1 tap weights), each of the 8 anchors' 9-tap sparse window NCC
where the anchor is valid, stays in the image and its weight sum is > 0
(an anchor that leaves the image counts at COST_MAX iff it selected the
view), the focal softmax over the anchors that count and the 0.25 / 0.75
blend with the centre; with ``geom`` the geometric cost of the pair as a
second output. With ``view_weights`` only the views weighing > 0 are
evaluated: the others get COST_MAX and geometric cost 0. Every
operation's order is fixed: K2's plain NCC for the centre and each
anchor, the softmax's sums in anchor order as ordered adds with one true
division, ``cost.geom_cost``'s torch ops.

The reference's ComputeBilateralNCCNew (APD.cu:448-593): a weak pixel's
cost against a source view aggregates NCC over up to 9 anchors, anchor 0
the pixel itself with the dense strong window, anchors 1..8 distant strong
supports with sparse windows, all warped by the candidate plane's
homography. `weak_ref_plain` builds a weak pixel's reference side (its
windows, the anchors' masks and selections, a `WeakRefData`, which depends
only on the pixel); the re-score form (`rescore_plain`, with
the top-k selection `rescore_select_plain`) is the initial cost's
re-score of the weak list, each pixel under its own plane.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ...core import geometry as geo
from ...core.sampling import clamped_fetch, device_constant, fetch
from ..cost import COST_MAX, RefWindow, geom_cost, square_taps
from . import ncc
from .strong import ordered_sum, window_plain


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


class WeakCosts(NamedTuple):
    """The costs of a chunk's planes."""

    ncc: torch.Tensor              # (B, P, S) deformable NCC costs
    geom: Optional[torch.Tensor]   # (B, P, S) geometric costs, or None


@functools.lru_cache(maxsize=None)
def _anchor_offsets(radius: int, increment: int, device: str):
    taps = torch.as_tensor(square_taps(radius, increment),
                           device=device).to(torch.float32)
    return taps[:, 0].contiguous(), taps[:, 1].contiguous()


def anchor_offsets(radius: int, increment: int, device):
    """The anchors' sparse window offsets (dx, dy), (T',) f32 each:
    ``cost.square_taps(radius, increment)``, dy outer."""
    return _anchor_offsets(int(radius), int(increment), str(device))


def weak_ref_plain(data, x, y, anchors, selected, strong_radius: int,
                   strong_increment: int, weak_radius: int,
                   weak_increment: int, use_sa: bool) -> WeakRefData:
    """The reference side of weak pixels (x, y) f32 with their (B, 9, 2)
    anchors: the centre's and the anchors' taps, weights, the anchor masks
    and selections, every window's sums taken in tap order.
    The centre window is the square of (strong_radius, strong_increment);
    under SA a tap weighs 1 where the pixel is in no segment (id <= 0) or
    the tap's id is the pixel's (no star, no truncation), and the anchors'
    windows weigh against the weak pixel's segment too."""
    sa = bool(use_sa) and data.sa_mask is not None
    dev = x.device
    xi, yi = x.to(torch.int32), y.to(torch.int32)
    seg = fetch(data.sa_mask, xi, yi) if sa else None

    def weights(tx, ty):
        extra = (1,) * (tx.ndim - 1)
        keep = (seg <= 0).reshape(seg.shape + extra) \
            | (fetch(data.sa_mask, tx, ty) == seg.reshape(seg.shape + extra))
        return keep.to(torch.float32)

    def sums(val, w):
        """(sum_ref, sum_rr, weight sum) in tap order: the terms w v and
        (w v) v, the weights' count; T without weights."""
        wv = val if w is None else w * val
        count = torch.full(val.shape[:-1], float(val.shape[-1]), device=dev) \
            if w is None else w.sum(-1)
        return ordered_sum(wv), ordered_sum(wv * val), count

    if sa:
        sq = device_constant(
            ("square_taps", strong_radius, strong_increment),
            lambda: square_taps(strong_radius, strong_increment), dev)
        ctx, cty = xi[:, None] + sq[:, 0], yi[:, None] + sq[:, 1]
        cval = clamped_fetch(data.ref_image, ctx, cty)
        cw = weights(ctx, cty)
        centre = RefWindow(sq[:, 0].to(torch.float32),
                           sq[:, 1].to(torch.float32), cval, *sums(cval, cw),
                           cw)
    else:
        centre = window_plain(data, x, y, strong_radius,
                                     strong_increment, False)
    ax, ay = anchors[:, 1:, 0], anchors[:, 1:, 1]
    exists = (ax >= 0) & (ay >= 0)
    axc, ayc = torch.clamp(ax, min=0), torch.clamp(ay, min=0)
    valid = exists
    if sa:
        valid = exists & ((seg <= 0)[:, None]
                          | (fetch(data.sa_mask, axc, ayc) == seg[:, None]))
    wk = device_constant(("square_taps", weak_radius, weak_increment),
                         lambda: square_taps(weak_radius, weak_increment),
                         dev)
    tx, ty = axc[..., None] + wk[:, 0], ayc[..., None] + wk[:, 1]
    tval = clamped_fetch(data.ref_image, tx, ty)              # (B, 8, T')
    tw = weights(tx, ty) if sa else None
    sum_ref, sum_rr, wsum = sums(tval, tw)
    return WeakRefData(
        x=x, y=y, center_win=centre, anchor_x=ax.to(torch.float32),
        anchor_y=ay.to(torch.float32), anchor_valid=valid,
        anchor_sel=fetch(selected, axc, ayc), tap_val=tval, tap_w=tw,
        sum_ref=sum_ref, sum_rr=sum_rr, wsum=wsum)


def weak_plain(data, wref, planes_, radius: int, increment: int, *,
               geom: bool, view_weights=None) -> WeakCosts:
    """The (B, P, S) deformable NCC costs (and geometric costs) of
    ``planes_`` (B, P, 4) against every source view."""
    b, p = planes_.shape[:2]
    s = data.num_src
    n = b * p
    dev = planes_.device
    pix = torch.arange(b, device=dev).repeat_interleave(p)
    flat = planes_.reshape(n, 4)
    x, y = wref.x[pix], wref.y[pix]
    cw = wref.center_win

    wsum = cw.wsum[pix] if isinstance(cw.wsum, torch.Tensor) else cw.wsum
    centre = ncc.ncc_strong_plain(data, x, y, flat, RefWindow(
        cw.tap_dx, cw.tap_dy, cw.tap_val[pix], cw.sum_ref[pix],
        cw.sum_rr[pix], wsum,
        None if cw.tap_w is None else cw.tap_w[pix]))           # (N, S)

    # the anchors: one row a (pixel, plane, anchor)
    adx, ady = anchor_offsets(radius, increment, dev)
    ax, ay = wref.anchor_x[pix], wref.anchor_y[pix]             # (N, 8)
    k = ax.shape[1]

    def rows(v):
        return None if v is None else v[pix].reshape((n * k,) + v.shape[2:])
    acost = ncc.ncc_strong_plain(
        data, ax.reshape(-1), ay.reshape(-1),
        flat[:, None].expand(n, k, 4).reshape(n * k, 4),
        RefWindow(adx, ady, rows(wref.tap_val), rows(wref.sum_ref),
                  rows(wref.sum_rr), rows(wref.wsum),
                  rows(wref.tap_w))).reshape(n, k, s)

    # the warp tests: the centre's and each anchor's, against the real
    # bounds
    hom = geo.homography(data.ref_cam, data.src_views, flat)   # (S, N, 3, 3)

    def outside(wx, wy):
        return (wx < 0) | (wx >= data.img_w) | (wy < 0) | (wy >= data.img_h)
    centre_oob = outside(*geo.warp(hom, x, y)).T               # (N, S)
    anchor_oob = outside(*geo.warp(hom[..., None, :, :], ax, ay)).permute(
        1, 2, 0)                                                # (N, 8, S)

    # the contribution rules and the focal softmax, in anchor order
    valid = wref.anchor_valid[pix][..., None]
    computable = valid & ~anchor_oob & (wref.wsum[pix] > 0)[..., None]
    counts = computable | (valid & anchor_oob & wref.anchor_sel[pix])
    vals = torch.where(computable, acost, COST_MAX)
    top = torch.amax(torch.where(counts, vals, -torch.inf), dim=1)
    e = torch.where(counts, torch.exp(vals - top[:, None]), 0.0)
    denom = torch.zeros_like(top)
    num = torch.zeros_like(top)
    for a in range(k):
        denom = denom + e[:, a]
        num = num + e[:, a] * vals[:, a]
    anchored = torch.where(denom > 0,
                           num / torch.clamp(denom, min=1e-30), 0.0)
    anchored = torch.clamp(anchored, max=COST_MAX)
    cost = torch.where(counts.any(1), 0.25 * centre + 0.75 * anchored,
                       centre)
    cost = torch.where(centre_oob, COST_MAX, cost)
    g = geom_cost(data, x, y, flat) if geom else None
    if view_weights is not None:
        keep = view_weights[pix] > 0
        cost = torch.where(keep, cost, COST_MAX)
        g = torch.where(keep, g, 0.0) if geom else None
    return WeakCosts(cost.reshape(b, p, s),
                     g.reshape(b, p, s) if geom else None)


def rescore_plain(data, planes_map, selected, x, y, anchors, *,
                  strong_radius: int, strong_increment: int,
                  weak_radius: int, weak_increment: int,
                  use_sa: bool) -> torch.Tensor:
    """The (B, S) costs of the re-score form: weak pixels (x, y) int32
    with their (B, 9, 2) anchors, each against every view under its own
    plane of the (H, W, 4) map ``planes_map``, its reference side
    `weak_ref_plain`'s (the anchors' selections from the prior
    ``selected``), its cost `weak_plain`'s."""
    wref = weak_ref_plain(data, x.to(torch.float32), y.to(torch.float32),
                          anchors, selected, strong_radius, strong_increment,
                          weak_radius, weak_increment, use_sa)
    own = fetch(planes_map, x, y)[:, None]
    return weak_plain(data, wref, own, weak_radius, weak_increment,
                      geom=False).ncc[:, 0]


def rescore_select_plain(data, planes_map, selected, x, y, anchors, valid,
                         top_k: int, **windows):
    """The selection mode's plain version: the (B,) costs and (B, S)
    selections of weak pixels (x, y), K11's plain selection
    (``select.select_rows_plain``) of `rescore_plain`'s costs with the
    pixels' validity in the (H, W) map ``valid``."""
    from .select import select_rows_plain
    costs = rescore_plain(data, planes_map, selected, x, y, anchors,
                          **windows)
    return select_rows_plain(costs, fetch(valid, x, y), top_k)
