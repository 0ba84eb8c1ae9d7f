"""Red-black checkerboard layout transforms.

The reference serializes PatchMatch propagation into black/red half-grid
kernel launches so neighbor reads never race with same-color writes
(APD.cu:1617-1692; parity: black = (x + y) even). Each color phase works on
a dense (H, W/2) compaction of its pixels; these helpers move between that
layout and the full (H, W) grid. Width must be even (the pipeline pads
images to a multiple of 8).
"""

from __future__ import annotations

import torch


def _offsets(height: int, color: int, device) -> torch.Tensor:
    """Column offset (0 or 1) of the color's pixels in each row."""
    return (torch.arange(height, device=device) + color) % 2


def gather_color(arr: torch.Tensor, color: int) -> torch.Tensor:
    """(H, W, ...) -> (H, W//2, ...) copy of one color's pixels."""
    h, w = arr.shape[:2]
    if w % 2:
        raise ValueError("checkerboard layout requires even width")
    pairs = arr.reshape((h, w // 2, 2) + arr.shape[2:])
    off = _offsets(h, color, arr.device).reshape((h, 1) + (1,) * (arr.ndim - 2))
    return torch.where(off == 0, pairs[:, :, 0], pairs[:, :, 1])


def scatter_color(arr: torch.Tensor, vals: torch.Tensor,
                  color: int) -> torch.Tensor:
    """A copy of ``arr`` with (H, W//2, ...) ``vals`` written into the
    color's positions."""
    h, w = arr.shape[:2]
    if w % 2:
        raise ValueError("checkerboard layout requires even width")
    pairs = arr.reshape((h, w // 2, 2) + arr.shape[2:])
    off = _offsets(h, color, arr.device)
    sel = (torch.arange(2, device=arr.device).reshape(1, 1, 2)
           == off.reshape(h, 1, 1)).reshape((h, 1, 2) + (1,) * (arr.ndim - 2))
    out = torch.where(sel, vals[:, :, None], pairs)
    return out.reshape(arr.shape)


def color_coords(height: int, width: int, color: int, *, device):
    """Pixel coordinates (x, y) int32 of the compacted (H, W//2) cells, on
    ``device``."""
    ys = torch.arange(height, dtype=torch.int32,
                      device=device)[:, None].expand(height, width // 2)
    js = torch.arange(width // 2, dtype=torch.int32,
                      device=device)[None, :].expand(height, width // 2)
    return 2 * js + (ys + color) % 2, ys
