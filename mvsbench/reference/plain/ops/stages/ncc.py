"""K2's plain version: the strong multi-view NCC.

For each pixel of a batch, its plane hypothesis and every source view: the
plane homography (``geometry.homography``), the centre's out-of-image
test, the T warped window taps (``geometry.warp``) sampled bilinearly from
the view's quad table, the three window sums in tap order t = 0 .. T-1
from 0, compensated (Kahan, four elementwise ops a tap), then
``cost.ncc_from_sums``; COST_MAX where the centre leaves the image, a
variance or the weight sum is degenerate, or the cost is not finite.

The stage form (`init_stage_plain`, with the top-k selection
`init_stage_select_plain`) is the initial cost's strong NCC over a range
of the image's pixels under the state's planes map, each pixel's window
``strong.window_plain``'s.
"""

from __future__ import annotations

import torch

from ...core import geometry as geo
from ...core.sampling import sample_packed_plain
from ..cost import COST_MAX, ncc_from_sums


def ncc_strong_plain(data, x, y, plane, win) -> torch.Tensor:
    """The (B, S) strong NCC cost as torch ops on (S, B) tensors, in the
    kernel's operation order."""
    H = geo.homography(data.ref_cam, data.src_views, plane)   # (S, B, 3, 3)
    cx, cy = geo.warp(H, x, y)                                # (S, B)
    oob = (cx < 0) | (cx >= data.img_w) | (cy < 0) | (cy >= data.img_h)
    tx = x[:, None] + win.tap_dx                              # (B, T)
    ty = y[:, None] + win.tap_dy
    wx, wy = geo.warp(H[..., None, :, :], tx, ty)             # (S, B, T)
    sv = sample_packed_plain(data.src_quads, data.width, data.height, wx,
                             wy)
    if win.tap_w is None:
        terms = (sv, sv * sv, win.tap_val * sv)
    else:
        wsv = win.tap_w * sv
        terms = (wsv, wsv * sv, (win.tap_w * win.tap_val) * sv)
    # (T, 3, S, B): one contiguous (3, S, B) slab a tap
    per_tap = torch.stack(terms).permute(3, 0, 1, 2).contiguous()
    # compensated (Kahan) sums in tap order, as the kernel takes them
    sums = torch.zeros_like(per_tap[0])
    comp = torch.zeros_like(sums)
    for t in range(per_tap.shape[0]):
        term = per_tap[t] - comp
        total = sums + term
        comp = (total - sums) - term
        sums = total
    cost = ncc_from_sums(win.sum_ref, win.sum_rr, sums[0], sums[1], sums[2],
                         win.wsum)
    return torch.where(oob, COST_MAX, cost).T


def init_stage_plain(data, planes, lo: int, hi: int, radius: int,
                     increment: int, use_sa: bool) -> torch.Tensor:
    """The (hi - lo, S) strong NCC costs of the stage form: pixels lo ..
    hi - 1 in raster order, each with its plane of the (H, W, 4) map
    ``planes`` and its window of ``strong.window_plain`` (sums in tap
    order; under SA the star cut at the segment's edge)."""
    from .strong import window_plain
    flat = torch.arange(lo, hi, device=planes.device)
    x = (flat % data.width).to(torch.float32)
    y = torch.div(flat, data.width, rounding_mode="floor").to(torch.float32)
    win = window_plain(data, x, y, radius, increment, use_sa)
    return ncc_strong_plain(data, x, y, planes.reshape(-1, 4)[lo:hi], win)


def init_stage_select_plain(data, planes, lo: int, hi: int, valid,
                            top_k: int, radius: int, increment: int,
                            use_sa: bool):
    """The selection mode's plain version: the (hi - lo,) costs and
    (hi - lo, S) selections of pixels lo .. hi - 1, K11's plain selection
    (``select.select_rows_plain``) of `init_stage_plain`'s costs with the
    pixels' validity."""
    from .select import select_rows_plain
    costs = init_stage_plain(data, planes, lo, hi, radius, increment, use_sa)
    return select_rows_plain(costs, valid.reshape(-1)[lo:hi], top_k)
