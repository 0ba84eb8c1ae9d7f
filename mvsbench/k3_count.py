"""The least time of one launch of K3, the strong sweep's colour update: a
frozen copy of the port's count (`chip_smoke.py`'s ``k3_bound`` with its
``K3_*`` and ``K5_GEOM_*`` constants and their reasons), applied to a
launch's own inputs and outputs.

The count is made of device tensors and reads nothing back to the host, so
that a traced window can count each launch as it goes without a
synchronising call; `bound_seconds` gives a launch's least time as a 0-d
float64 tensor, the larger of its operations over the float32 peak and its
bytes over the memory peak.
"""

from __future__ import annotations

import torch

from .reference.plain.core.sampling import fetch
from .reference.plain.ops.cost import square_taps
from .reference.plain.ops.propagation import _REGIONS

# H100 SXM peaks (NVIDIA data sheet): the device memory rate, and the
# float32 rate outside the tensor cores (K3's arithmetic is plain f32).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# operations of the geometric cost as the disparity sweep counts them: per
# (pixel, view, probe) 115 (projection into the source view 35, the texel
# index 10, back-projection 24, projection into the reference 35,
# distance, clamp and checks 9, the factor and its add 2); per (pixel,
# probe) 36 (depth from the plane 12, back-projection 24).
K5_GEOM_OPS_PER_PAIR = 115
K5_GEOM_OPS_PER_PIXEL = 36
# operations of the strong sweep's colour update K3 as the function needs
# them, beside the per tap and per pair counts below for every valid
# (candidate, view) pair and every (plane, weighted view) pair of the
# current plane and the 5 hypotheses, and with the geometric cost the
# 115 a (plane, weighted view) and 36 a (pixel, plane) above: per (pixel,
# view) 80 for the selection (8 candidates' threshold, square, division,
# exponential, weight sum and counts, the prior's 4 adds, the probability,
# the CDF's add and division, 15 sample comparisons); per (pixel, weighted
# view) 28 (a product and an add for each of the 8 candidates' and 6
# planes' sums); per pixel 300 (the candidate scan's 8 regions of 7-11
# positions, the adoption, the 5 hypotheses' normals, rotation, norms,
# planes and depths, the commit). A pair whose weight is 0 needs nothing:
# its term is +0.
K3_SELECT_OPS_PER_VIEW = 80
K3_OPS_PER_WEIGHTED_PAIR = 28
K3_OPS_PER_PIXEL = 300
K3_PLANES = 6                # the current plane and the 5 hypotheses
# K3's strong NCC forms each offset's warp products once a pair: a tap 6
# adds for the 3 warp rows, 2 divisions, one bilinear sample (17), 2
# products and 3 sums (an SA tap 2 products more); a pair 90 (the
# homography: 3 + 6 divisions, 27 multiplies, 21 adds; the centre warp
# and test 18; the NCC from the sums ~15) and, on the square window, the
# 6 x- and 6 y-offsets' adds and their 3 rows' products (48; the star's 4
# quadrants form theirs each: 96). The window itself: 4 a (pixel, tap)
# for the weight-value product, its square and the two sums.
K3_OPS_PER_TAP = 30
K3_OPS_PER_PAIR = 138
K3_STAR_OPS_PER_PAIR = 48
K3_WINDOW_OPS_PER_TAP = 4


def candidate_flags(h: int, x: torch.Tensor, y: torch.Tensor, w: int,
                    row_bounds=None) -> torch.Tensor:
    """(B, 8) validity of the 8 candidate regions: a region counts where
    its base offset lies inside the rows and columns."""
    lo, hi = (0, h - 1) if row_bounds is None else row_bounds
    flags = []
    for region in _REGIONS:
        dx, dy = (int(v) for v in region[0])
        px, py = x + dx, y + dy
        flags.append((px >= 0) & (px < w) & (py >= lo) & (py <= hi))
    return torch.stack(flags, -1)


def bound_seconds(data, x, y, kw: dict, view_weights: torch.Tensor,
                  commit: bool) -> torch.Tensor:
    """A launch's least time on the card: ``data`` its cost data (the
    tables, the reference image and segment ids, the source depths),
    ``x``, ``y`` its pixels, ``kw`` its keywords, ``view_weights`` (B, S)
    the view weights it gave its pixels; with ``commit`` the committed
    maps are read and written whole and the weak and valid maps read."""
    s, b = data.num_src, x.numel()
    gh, gw = data.height, data.width
    geom = kw["geom"]
    t = len(square_taps(kw["radius"], kw["increment"]))
    sa = kw["use_sa"] and data.sa_mask is not None
    flags = candidate_flags(gh, x, y, gw, kw.get("row_bounds"))
    f64 = dict(dtype=torch.float64)
    n_flags = flags.sum(-1).to(**f64)
    n_weighted = (view_weights != 0).sum(-1).to(**f64)
    star = (fetch(data.sa_mask, x, y) > 0) if sa \
        else torch.zeros_like(x, dtype=torch.bool)
    per_pair = t * K3_OPS_PER_TAP + K3_OPS_PER_PAIR
    pairs = n_flags.sum() * s
    weighted = n_weighted.sum()
    star_pairs = torch.where(star, n_flags * s + K3_PLANES * n_weighted,
                             0.0).sum()
    ops = pairs * per_pair \
        + K3_PLANES * weighted * (per_pair + (K5_GEOM_OPS_PER_PAIR if geom
                                              else 0)) \
        + star_pairs * (2 * t + K3_STAR_OPS_PER_PAIR) \
        + weighted * K3_OPS_PER_WEIGHTED_PAIR \
        + b * s * K3_SELECT_OPS_PER_VIEW \
        + b * (K3_OPS_PER_PIXEL + t * K3_WINDOW_OPS_PER_TAP
               + (K3_PLANES * K5_GEOM_OPS_PER_PIXEL if geom else 0))
    cells = gh * gw
    nbytes = b * (4 * (2 + 15 + 8) + 4 * 5 + 5 * s) \
        + cells * (4 + 16 + s) + 4 * cells * (2 if sa else 1) \
        + data.src_quads.numel() * data.src_quads.element_size() \
        + (s + 1) * 40 * 4
    if geom:
        nbytes += 4 * data.src_depths.numel()
    if commit:
        # the maps in and out, and the weak and valid maps, in place of
        # the batch's rows
        nbytes += cells * (2 * (16 + 4 + 5 * s) + 5) - b * (4 * 5 + 5 * s)
    return torch.maximum(ops / F32_FLOPS_PER_S,
                         torch.full_like(ops, nbytes / HBM_BYTES_PER_S))

