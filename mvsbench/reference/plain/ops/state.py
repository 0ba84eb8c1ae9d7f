"""PatchMatch per-view state as a dataclass of tensors.

The reference's per-pixel buffers (plane_hypotheses float4, costs,
selected_views bitmask, view_weight uchar[32], weak_info, confidence;
APD.h:150-189) become dense tensors. Pixel-state byte values (WEAK=0,
STRONG=1, UNKNOWN=2) match the on-disk ABI of weak.bin.

`valid` marks real image pixels: the pipeline pads images to a multiple of
8, and padded pixels must never update or contribute.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import STRONG, UNKNOWN


@dataclasses.dataclass(frozen=True)
class PMState:
    planes: torch.Tensor        # (H, W, 4) f32 — camera-frame (n, w) during PM
    costs: torch.Tensor         # (H, W) f32
    selected: torch.Tensor      # (H, W, S) bool
    view_weights: torch.Tensor  # (H, W, S) f32 Monte-Carlo vote counts
    weak: torch.Tensor          # (H, W) int32 pixel states
    confidence: torch.Tensor    # (H, W) f32 (uchar semantics, 0..255)
    valid: torch.Tensor         # (H, W) bool — real (non-padding) pixels

    @staticmethod
    def create(height: int, width: int, num_src: int, valid=None, *,
               device) -> "PMState":
        """Initial state on ``device`` (``valid``'s device when given)."""
        if valid is None:
            valid = torch.ones((height, width), dtype=torch.bool,
                               device=device)
        device = valid.device
        return PMState(
            planes=torch.zeros((height, width, 4), device=device),
            costs=torch.full((height, width), 2.0, device=device),
            selected=torch.zeros((height, width, num_src), dtype=torch.bool,
                                 device=device),
            view_weights=torch.zeros((height, width, num_src), device=device),
            weak=torch.where(valid, STRONG, UNKNOWN).to(torch.int32),
            confidence=torch.ones((height, width), device=device),
            valid=valid,
        )

    def replace(self, **changes) -> "PMState":
        return dataclasses.replace(self, **changes)
