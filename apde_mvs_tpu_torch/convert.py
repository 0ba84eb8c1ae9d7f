"""Carry state across from the JAX package: its `CostData` and `PMState`
fields, its APD data (SA mask, weak list, anchors, fit planes, anchor
draws, `WeakRefData`), handed over as numpy arrays, become the port's
objects on a device. The system has no weights; this is what lets a test
give both implementations the same inputs and intermediate state.

Each argument is anything `np.asarray` accepts (a JAX array included),
so this module needs no JAX import.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .core.geometry import CameraArrays
from .ops.anchors import AnchorRaws
from .ops.cost import CostData, RefWindow
from .ops.deformable import WeakRefData
from .ops.state import PMState


def _t(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=dtype), device=device)


def camera_arrays(K, R, t, c, device="cuda") -> CameraArrays:
    """The four fields of a JAX `geometry.CameraArrays` (in that order)."""
    return CameraArrays(*(_t(a, np.float32, device) for a in (K, R, t, c)))


def cost_data(*, ref_cam: Sequence, src_cams: Sequence, ref_image,
              src_quads, src_depths, width: int, height: int,
              real_width: int = 0, real_height: int = 0, sa_mask=None,
              device="cuda") -> CostData:
    """A `CostData` from the JAX one's fields. ``ref_cam`` / ``src_cams``
    are (K, R, t, c) tuples; ``src_quads`` keeps its dtype (u8 or f32);
    ``sa_mask`` (H, W) segment ids, or None for no mask."""
    quads = np.asarray(src_quads)
    if quads.dtype not in (np.uint8, np.float32):
        raise TypeError(f"quad tables must be u8 or f32, got {quads.dtype}")
    return CostData(
        ref_cam=camera_arrays(*ref_cam, device=device),
        src_cams=camera_arrays(*src_cams, device=device),
        ref_image=_t(ref_image, np.float32, device),
        src_quads=_t(quads, quads.dtype, device),
        src_depths=_t(src_depths, np.float32, device),
        width=int(width), height=int(height), num_src=int(quads.shape[0]),
        real_width=int(real_width), real_height=int(real_height),
        sa_mask=None if sa_mask is None else _t(sa_mask, np.int32, device))


def pm_state(*, planes, costs, selected, view_weights, weak, confidence,
             valid, device="cuda") -> PMState:
    """A `PMState` from the JAX one's fields."""
    return PMState(
        planes=_t(planes, np.float32, device),
        costs=_t(costs, np.float32, device),
        selected=_t(selected, np.bool_, device),
        view_weights=_t(view_weights, np.float32, device),
        weak=_t(weak, np.int32, device),
        confidence=_t(confidence, np.float32, device),
        valid=_t(valid, np.bool_, device))


def ints(a, device="cuda") -> torch.Tensor:
    """An int32 tensor: a weak-pixel coordinate list, (Nw, 9, 2) anchors,
    raw RANSAC triplets."""
    return _t(a, np.int32, device)


def floats(a, device="cuda") -> torch.Tensor:
    """A float32 tensor: (Nw, 4) fit planes, draws."""
    return _t(a, np.float32, device)


def anchor_raws(*, shift_x, shift_y, triplets, device="cuda") -> AnchorRaws:
    """`AnchorRaws` from the JAX one's fields."""
    return AnchorRaws(*(ints(a, device) for a in (shift_x, shift_y,
                                                   triplets)))


def _weights(w, full_shape, device):
    """A JAX window weight array: the shared all-ones constant of the plain
    window becomes None, per-tap SA weights a tensor."""
    w = np.asarray(w)
    if w.shape != tuple(full_shape) and np.all(w == 1.0):
        return None
    return _t(np.broadcast_to(w, full_shape), np.float32, device)


def weak_ref_data(*, x, y, center_win, anchor_x, anchor_y, anchor_valid,
                  anchor_sel, tap_val, tap_w, sum_ref, sum_rr, wsum,
                  device="cuda") -> WeakRefData:
    """A `WeakRefData` from the JAX one's fields (its ``center_win`` is a
    JAX `RefWindow`)."""
    cw = center_win
    c_val = np.asarray(cw.tap_val)
    c_w = _weights(cw.tap_w, c_val.shape, device)
    c_wsum = float(np.asarray(cw.wsum)) if c_w is None \
        else _t(cw.wsum, np.float32, device)
    # the centre window's offsets are the shared (1, T) square taps
    win = RefWindow(
        _t(np.asarray(cw.tap_dx).reshape(-1), np.float32, device),
        _t(np.asarray(cw.tap_dy).reshape(-1), np.float32, device),
        _t(c_val, np.float32, device), _t(cw.sum_ref, np.float32, device),
        _t(cw.sum_rr, np.float32, device), c_wsum, c_w)
    return WeakRefData(
        x=floats(x, device), y=floats(y, device), center_win=win,
        anchor_x=floats(anchor_x, device), anchor_y=floats(anchor_y, device),
        anchor_valid=_t(anchor_valid, np.bool_, device),
        anchor_sel=_t(anchor_sel, np.bool_, device),
        tap_val=floats(tap_val, device),
        tap_w=_weights(tap_w, np.asarray(tap_val).shape, device),
        sum_ref=floats(sum_ref, device), sum_rr=floats(sum_rr, device),
        wsum=floats(wsum, device))
