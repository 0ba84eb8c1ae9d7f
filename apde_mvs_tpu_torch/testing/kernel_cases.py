"""Inputs that hold K2 and K5 against their plain versions beyond the main
path's own: view-weight patterns, sources cycled to a view count, and a
25-tap window (the kernels' generic tap loop; the main path runs 36 taps).
One copy for the CPU tests, ``chip_smoke.py`` and
``tools/kernel_times.py``."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cost import RefWindow, precompute_ref_window

WEIGHT_PATTERNS = ("none", "one", "every", "nan", "neg-zero")


def weight_pattern(px, pattern: str):
    """The sweep pixels ``px`` (a ``sweep.SweepPixels``) with their view
    weights replaced by ``pattern``: ``none`` (every weight 0, the weight
    sums kept, so a pixel's costs are 0 / wnorm), ``one`` (view b mod S
    only, weighing 1-3), ``every`` (1-5 on every view), ``nan`` (a NaN
    weight on every 7th pixel's view 1, whose costs are then NaN) or
    ``neg-zero`` (the 0 weights as -0). Except for ``none`` the weight sums
    are the non-NaN weights' sums."""
    vw = px.vw.clone()
    b, s = vw.shape
    rows = torch.arange(b, device=vw.device)
    if pattern == "none":
        return px._replace(vw=torch.zeros_like(vw))
    if pattern == "one":
        vw = torch.zeros_like(vw)
        vw[rows, rows % s] = 1.0 + (rows % 3).float()
    elif pattern == "every":
        cols = torch.arange(s, device=vw.device)
        vw = (1 + (rows[:, None] + cols) % 5).float()
    elif pattern == "nan":
        vw[::7, min(1, s - 1)] = float("nan")
    elif pattern == "neg-zero":
        vw = torch.where(vw == 0, -0.0, vw)
    else:
        raise ValueError(f"unknown weight pattern {pattern!r}")
    return px._replace(vw=vw.contiguous(), wnorm=torch.nansum(vw, -1))


def cycled_views(data, n: int):
    """``data`` (a ``cost.CostData``) with its source views repeated in turn
    to ``n`` views, and the source index of each."""
    idx = [i % data.num_src for i in range(n)]
    depths = data.src_depths
    return data.replace(
        src_quads=data.src_quads[idx].contiguous(),
        src_cams=data.src_cams.map(lambda a: a[idx]),
        src_depths=depths[idx].contiguous() if depths.ndim == 3 else depths,
        num_src=n), idx


def window_25(data, x, y, per_pixel: bool = False,
              seed: int = 3) -> RefWindow:
    """A 25-tap square window (radius 4, step 2) at pixels (x, y); with
    ``per_pixel`` its offsets per pixel and seeded tap weights of 0, 0.5 and
    1, the form an SA window takes."""
    win = precompute_ref_window(data, x, y, 4, 2)
    if not per_pixel:
        return win
    b, t = win.tap_val.shape
    w = torch.as_tensor(np.random.default_rng(seed).choice(
        [0.0, 0.5, 1.0], (b, t)).astype(np.float32), device=x.device)
    return RefWindow(
        win.tap_dx.expand(b, t).contiguous(),
        win.tap_dy.expand(b, t).contiguous(), win.tap_val,
        (w * win.tap_val).sum(-1), (w * win.tap_val * win.tap_val).sum(-1),
        w.sum(-1), w)
