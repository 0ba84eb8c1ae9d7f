"""Inputs that hold K2, K5, K3 and K6 against their plain versions beyond
the main path's own: view-weight patterns, sources cycled to a view count,
a 25-tap window (the kernels' generic tap loop; the main path runs 36
taps), for K3 selection draws that weight one view or many and the state
of a tile route's halo row block, and for K6 a weak chunk's plane
hypotheses with the degenerate ones among them and the probes' view
weights. One copy for the CPU tests, ``chip_smoke.py`` and
``tools/kernel_times.py``."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import geometry as geo
from ..ops.cost import RefWindow, precompute_ref_window
from ..ops.state import PMState

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


# K3's selection draws: the generator's, one uniform a pixel for all 15
# samples (one view weighted), or the 15 stratified (as many views as the
# probabilities allow)
SELECTION_PATTERNS = ("random", "one", "spread")


def strong_draws(n: int, pattern: str, seed: int, device):
    """A colour update's draws for ``n`` pixels (a
    ``propagation.SweepDraws``): the refinement draws from a generator
    seeded with ``seed``, the 15 selection uniforms by ``pattern`` (one of
    SELECTION_PATTERNS)."""
    from ..ops.propagation import sweep_draws
    draws = sweep_draws(torch.Generator(device=device).manual_seed(seed), n,
                        device)
    k = draws.sel_u.shape[1]
    if pattern == "one":
        return draws._replace(
            sel_u=draws.sel_u[:, :1].expand(n, k).contiguous())
    if pattern == "spread":
        return draws._replace(sel_u=((torch.arange(
            k, dtype=torch.float32, device=device) + 0.5) / k).expand(
                n, k).contiguous())
    if pattern != "random":
        raise ValueError(f"unknown selection pattern {pattern!r}")
    return draws


def block_state(state: PMState, row0: int, height: int) -> PMState:
    """The ``height`` rows of ``state`` that a row block whose row 0 is
    image row ``row0`` holds (``parallel.tiles.halo_block``), zeros where a
    row lies outside the image, as a halo exchange leaves the chain's ends
    (``parallel.tiles._extend``)."""
    h = state.costs.shape[0]
    rows = torch.arange(height, device=state.costs.device) + row0
    outside = (rows < 0) | (rows >= h)

    def take(a):
        out = a[torch.clamp(rows, 0, h - 1)].clone()
        out[outside] = 0
        return out
    return PMState(**{f.name: take(getattr(state, f.name))
                      for f in dataclasses.fields(PMState)})


# K6's probes: no view weighted, one, every view, or Monte-Carlo-like counts
VIEW_PATTERNS = ("none", "one", "all", "random")


def weak_planes(cam, x, y, depth, normal, p: int, seed: int):
    """(B, P, 4) plane hypotheses for the weak pixels (x, y) f32 of a K6
    case, from their depths (B,) and camera-frame normals (B, 3) seen by
    ``cam``: plane 0 through the depth with the normal, the others with the
    depth scaled by a seeded factor in [0.9, 1.1] and the normal tilted,
    every third random (depth 0.5-2 times the pixel's, normal along
    (0.1, -0.1, -1)), which sends centres and anchors out of the image; then
    the degenerate ones: plane 2 of every 13th pixel NaN, w = 0 on plane 1
    of every 29th, and the last plane of every 7th the zero plane (a weak
    pixel without a RANSAC fit)."""
    rng = np.random.default_rng(seed)
    b = x.shape[0]
    dev = x.device
    scale = rng.uniform(0.9, 1.1, (b, p))
    scale[:, 0] = 1.0
    random = (np.arange(p) % 3 == 2) & (np.arange(p) > 0)
    scale[:, random] = rng.uniform(0.5, 2.0, (b, int(random.sum())))
    tilt = rng.normal(0.0, 0.15, (b, p, 3))
    tilt[:, 0] = 0.0
    n = normal.cpu().numpy()[:, None, :] + tilt
    n[:, random] = np.array([0.1, -0.1, -1.0])
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d = depth[:, None] * torch.as_tensor(scale.astype(np.float32),
                                         device=dev)
    nt = torch.as_tensor(n.astype(np.float32), device=dev)
    planes = torch.stack([geo.make_plane(cam, x, y, d[:, i], nt[:, i])
                          for i in range(p)], 1)
    if p > 2:
        planes[::13, 2] = float("nan")
    if p > 1:
        planes[::29, 1, 3] = 0.0
    planes[::7, p - 1] = 0.0
    return planes.contiguous()


def weak_view_weights(b: int, s: int, pattern: str, seed: int, device):
    """(B, S) f32 view weights of K6's probes by ``pattern``: ``none``
    (every weight 0), ``one`` (view b mod S only, weighing 1-3), ``all``
    (1-5 on every view) or ``random`` (counts 0-3, about half of them 0, as
    the Monte-Carlo selection gives)."""
    rows = np.arange(b)
    if pattern == "none":
        vw = np.zeros((b, s))
    elif pattern == "one":
        vw = np.zeros((b, s))
        vw[rows, rows % s] = 1 + rows % 3
    elif pattern == "all":
        vw = 1 + (rows[:, None] + np.arange(s)) % 5
    elif pattern == "random":
        rng = np.random.default_rng(seed)
        vw = np.where(rng.random((b, s)) < 0.5, 0,
                      rng.integers(1, 4, (b, s)))
    else:
        raise ValueError(f"unknown view pattern {pattern!r}")
    return torch.as_tensor(np.asarray(vw, np.float32), device=device)
