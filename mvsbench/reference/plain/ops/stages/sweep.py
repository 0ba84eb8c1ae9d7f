"""K5's plain version: the disparity sweeps of DepthToWeak and
LocalRefine, with the geometric cost inside.

For a chunk of B pixels with fixed camera-frame normals, and every source
view, each probe depth gives a plane; its cost is the selection-gated
weighted mean over the views of K2's strong NCC (plus ``geom_factor``
times the geometric cost), COST_MAX where the weight sum is 0 or the probe
depth leaves ``[depth_min, depth_max]`` (`sweep_plain`). Two modes:

- classify (DepthToWeak): 61 probes at disparity offsets -30 .. 30, each
  cost clamped at COST_MAX: the (B, 61) reliability curve;
- refine (LocalRefine): the current depth first (never depth-masked), then
  11 probes at offsets -5 .. 5: (B, 12) costs.

Every operation's order is fixed: the probe depth of `probe_depths`, the
plane's w with its three products summed in order, K2's plain NCC,
``cost.geom_cost``'s torch ops, then the view sum as ordered adds over
s = 0 .. S-1. The stage form (`stage_plain`, ``filters.depth_to_weak``
and ``filters.local_refine``) is the whole stage: the setup from the
state's maps (``filters._sweep_scalars``), ``strong.window_plain``'s
window, the sweep and the decision rule (``filters._classify_peaks``,
``filters._refine_depths``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ...config import RELIABLE_CURVE_SAMPLE_NUM
from ...core.sampling import device_constant, fetch
from ..cost import COST_MAX, geom_cost
from . import ncc


# disparity offsets of the swept probes: DepthToWeak's 61, LocalRefine's 11
CLASSIFY_OFFSETS = tuple(range(-(RELIABLE_CURVE_SAMPLE_NUM // 2),
                               RELIABLE_CURVE_SAMPLE_NUM // 2 + 1))
REFINE_OFFSETS = tuple(range(-5, 6))


class SweepPixels(NamedTuple):
    """A chunk's per-pixel inputs of the sweep."""

    x: torch.Tensor          # (B,) f32
    y: torch.Tensor          # (B,) f32
    plane: torch.Tensor      # (B, 4) camera-frame normal, current depth
    disp: torch.Tensor       # (B,) current disparity f * baseline / depth
    base_line: torch.Tensor  # (B,)
    vw: torch.Tensor         # (B, S) selection-gated view weights
    wnorm: torch.Tensor      # (B,) their sum


def view_distances(data) -> torch.Tensor:
    """(S,) f32 distances |c_ref - c_src| of the source cameras from the
    reference's, whose selection-gated mean is a pixel's baseline."""
    return torch.linalg.vector_norm(
        data.ref_cam.c[None, :] - data.src_cams.c, dim=-1).contiguous()


def _f32(v) -> float:
    """A scalar parameter as the float32 value the sweep computes with."""
    return float(np.float32(float(v)))


def probe_depths(fx, disp, base_line, offsets) -> torch.Tensor:
    """(B, len(offsets)) depths at the disparity offsets from the current
    disparity: f * baseline / (disp + offset), 1e-20 for a zero
    denominator (reference: APD.cu:2165-2171)."""
    d = disp[:, None] + device_constant(
        ("probe_offsets", tuple(offsets)),
        lambda: np.asarray(offsets, np.float32), disp.device)
    return (fx * base_line)[:, None] / torch.where(d != 0, d, 1e-20)


def sweep_plain(data, px: SweepPixels, win, *, refine: bool, geom: bool,
                geom_factor, depth_min, depth_max) -> torch.Tensor:
    """The sweep's (B, 61) classify curve or (B, 12) refine costs as torch
    ops, in the kernel's operation order."""
    cam = data.ref_cam
    offsets = REFINE_OFFSETS if refine else CLASSIFY_OFFSETS
    depths = probe_depths(cam.fx, px.disp, px.base_line, offsets)
    lo, hi = _f32(depth_min), _f32(depth_max)
    probes = [(depths[:, i], lo, hi) for i in range(len(offsets))]
    if refine:
        probes.insert(0, (px.plane[:, 3], -math.inf, math.inf))
    gf = _f32(geom_factor)
    n0, n1, n2 = px.plane[:, 0], px.plane[:, 1], px.plane[:, 2]
    cols = []
    for pd, lo, hi in probes:
        X = pd * (px.x - cam.cx) / cam.fx
        Y = pd * (px.y - cam.cy) / cam.fy
        w = -((n0 * X + n1 * Y) + n2 * pd)
        plane = torch.stack([n0, n1, n2, w], -1)
        cv = ncc.ncc_strong_plain(data, px.x, px.y, plane, win)   # (B, S)
        if geom:
            cv = cv + gf * geom_cost(data, px.x, px.y, plane)
        acc = torch.zeros_like(pd)
        for s in range(cv.shape[1]):
            acc = acc + px.vw[:, s] * cv[:, s]
        cost = acc / torch.clamp(px.wnorm, min=1e-20)
        cost = torch.where(px.wnorm > 0, cost, COST_MAX)
        cost = torch.where((pd >= lo) & (pd <= hi), cost, COST_MAX)
        cols.append(cost if refine else torch.clamp(cost, max=COST_MAX))
    return torch.stack(cols, 1)


# DepthToWeak's margin: pixels within it come out UNKNOWN (the pipeline
# skips them)
MIN_MARGIN = 6


def stage_plain(data, state, x, y, *, refine: bool, radius: int,
                increment: int, use_sa: bool, geom: bool, geom_factor,
                depth_min, depth_max, weak_peak_radius=0,
                return_curve: bool = False):
    """DepthToWeak (``refine`` False: (int32 classes (B,), the (B, 61)
    curve with ``return_curve`` or None)) or LocalRefine (the (B,) new
    depths) of pixels (x, y) int32 as torch ops, in the stage kernel's
    operation order: ``filters._sweep_scalars``' setup (its sums in view
    order), ``strong.window_plain``'s window, ``sweep_plain``, then
    ``filters._classify_peaks`` or ``filters._refine_depths``."""
    from .. import filters
    from .strong import window_plain
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    sc = filters._sweep_scalars(data, state, x, y)
    win = window_plain(data, xf, yf, radius, increment, use_sa)
    px = SweepPixels(xf, yf, sc.plane_cam, sc.disp, sc.base_line, sc.vw,
                     sc.wnorm)
    costs = sweep_plain(data, px, win, refine=refine, geom=geom,
                        geom_factor=geom_factor, depth_min=depth_min,
                        depth_max=depth_max)
    if refine:
        ok = sc.ok & (sc.wnorm > 0) & fetch(state.valid, x, y)
        return torch.where(ok, filters._refine_depths(data, sc, costs),
                           sc.depth)
    weak = filters._classify_peaks(data, state, x, y, costs,
                                   weak_peak_radius, sc.ok)
    return weak, (costs if return_curve else None)
