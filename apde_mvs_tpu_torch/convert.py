"""Carry state across from the JAX package: its `CostData` and `PMState`
fields, handed over as numpy arrays, become the port's objects on a
device. The system has no weights; this is what lets a test give both
implementations the same inputs and intermediate state.

Each argument is anything `np.asarray` accepts (a JAX array included),
so this module needs no JAX import.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .core.geometry import CameraArrays
from .ops.cost import CostData
from .ops.state import PMState


def _t(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=dtype), device=device)


def camera_arrays(K, R, t, c, device="cuda") -> CameraArrays:
    """The four fields of a JAX `geometry.CameraArrays` (in that order)."""
    return CameraArrays(*(_t(a, np.float32, device) for a in (K, R, t, c)))


def cost_data(*, ref_cam: Sequence, src_cams: Sequence, ref_image,
              src_quads, src_depths, width: int, height: int,
              real_width: int = 0, real_height: int = 0,
              device="cuda") -> CostData:
    """A `CostData` from the JAX one's fields. ``ref_cam`` / ``src_cams``
    are (K, R, t, c) tuples; ``src_quads`` keeps its dtype (u8 or f32)."""
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
        real_width=int(real_width), real_height=int(real_height))


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
