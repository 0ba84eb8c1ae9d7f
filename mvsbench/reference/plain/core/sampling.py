"""Image sampling primitives — the replacement for CUDA texture fetches.

The reference samples images through bilinear-filtered texture objects
(APD.cpp:687-734) and depth maps through integer-centered fetches
(APD.cu:885, 2319). Each source image is pre-packed into a (H*W, 4) "quad"
table holding the 2x2 bilinear footprint of every pixel, so one row load
per sample replaces four scalar loads; the tables are u8 by default (the
JAX package's default, texture-unit-grade precision) or f32 (the exact
oracle).

Out-of-range coordinates clamp to the edge (the reference configures wrap
addressing, but every cost path rejects out-of-image centers before
sampling; clamp only affects window taps past the border).

`sample_packed_plain` is the plain version of the port's sampler K1.
"""

from __future__ import annotations

import torch


def pack_bilinear(img: torch.Tensor) -> torch.Tensor:
    """Pack (..., H, W) -> (..., H*W, 4) rows [v00, v01, v10, v11] with
    clamped edges."""
    right = torch.cat([img[..., :, 1:], img[..., :, -1:]], dim=-1)
    down = torch.cat([img[..., 1:, :], img[..., -1:, :]], dim=-2)
    downright = torch.cat([down[..., :, 1:], down[..., :, -1:]], dim=-1)
    quad = torch.stack([img, right, down, downright], dim=-1)
    return quad.reshape(img.shape[:-2] + (-1, 4))


def pack_bilinear_u8(img: torch.Tensor) -> torch.Tensor:
    """Pack (..., H, W) 0..255 values -> (..., H*W, 4) u8 quad rows.
    Fractional values are rounded (half to even) to the integer grid."""
    return pack_bilinear(torch.clamp(torch.round(img), 0.0, 255.0)
                         .to(torch.uint8))


def _index(v: torch.Tensor) -> torch.Tensor:
    """Integer part of an already-clamped, floored coordinate; NaN maps to 0
    (its sample is NaN whatever row it reads)."""
    return torch.nan_to_num(v, nan=0.0).long()


def quad_coords(width: int, height: int, x, y):
    """Shared clamp/floor/fraction decomposition for quad-table sampling.
    Returns (row_index int64, fx, fy). NaN coordinates keep NaN fractions."""
    x = torch.clamp(x, 0.0, width - 1.0)
    y = torch.clamp(y, 0.0, height - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    return _index(y0) * width + _index(x0), x - x0, y - y0


def lerp_quad_rows(rows: torch.Tensor, fx, fy):
    """Bilinear lerp of gathered (..., 4) quad rows [v00, v01, v10, v11]."""
    v = rows.to(torch.float32)
    top = v[..., 0] * (1.0 - fx) + v[..., 1] * fx
    bot = v[..., 2] * (1.0 - fx) + v[..., 3] * fx
    return top * (1.0 - fy) + bot * fy


def sample_packed_plain(quads: torch.Tensor, width: int, height: int, x, y):
    """Bilinear sample of S quad tables (S, N, 4) at (S, ...) coordinates:
    `quad_coords` and `lerp_quad_rows` over the S tables at once."""
    s = quads.shape[0]
    idx, fx, fy = quad_coords(width, height, x, y)
    view = torch.arange(s, device=quads.device).reshape(
        (s,) + (1,) * (idx.ndim - 1))
    return lerp_quad_rows(quads[view, idx], fx, fy)


def trunc_index(v: torch.Tensor, size: int) -> torch.Tensor:
    """Truncate toward zero and clamp to [0, size-1], with the saturating
    semantics of XLA's float->int32 conversion (NaN -> 0, out-of-range
    values saturate) so huge or non-finite coordinates clamp to the same
    edge as in the JAX package."""
    v = torch.clamp(torch.nan_to_num(v, nan=0.0), -1.0, float(size))
    return torch.clamp(v.long(), 0, size - 1)


def texel_fetch(img: torch.Tensor, x, y):
    """Integer pixel fetch at truncated coordinates with clamped edges —
    the reference's `tex2D(img, (int)x + 0.5, (int)y + 0.5)` idiom used for
    depth-map lookups (APD.cu:885, 2319). ``img`` is one (H, W) map with
    x, y of any shape, or S maps (S, H, W) with x, y (S, ...)."""
    h, w = img.shape[-2:]
    idx = trunc_index(y, h) * w + trunc_index(x, w)
    if img.ndim == 2:
        return img.reshape(-1)[idx]
    flat = img.reshape(img.shape[0], h * w)
    return torch.gather(flat, 1, idx.reshape(idx.shape[0], -1)
                        ).reshape(idx.shape)


def clamped_fetch(arr: torch.Tensor, xi, yi):
    """Integer fetch from a 2-D (or 2-D + trailing dims) array with the
    indices clamped to its edges."""
    h, w = arr.shape[:2]
    flat = arr.reshape((h * w,) + arr.shape[2:])
    return flat[(torch.clamp(yi, 0, h - 1) * w
                 + torch.clamp(xi, 0, w - 1)).long()]


def fetch(arr: torch.Tensor, xi, yi, fill=0):
    """Integer fetch from a 2-D (or 2-D + trailing dims) array with
    out-of-bounds fill. The result keeps ``arr``'s dtype."""
    h, w = arr.shape[:2]
    inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    v = clamped_fetch(arr, xi, yi)
    inb = inb.reshape(inb.shape + (1,) * (arr.ndim - 2))
    if arr.dtype == torch.bool:
        fill = bool(fill)
    elif not arr.dtype.is_floating_point:
        fill = int(fill)
    return v.masked_fill(~inb, fill)


_constants: dict = {}   # (key, device) -> the table on that device


def device_constant(key, make, device) -> torch.Tensor:
    """``torch.as_tensor(make())`` on ``device``, copied from the host once
    a (key, device) and kept: a host copy made at every call waits for the
    device. The table is shared, so callers never write to it."""
    device = torch.device(device)
    table = _constants.get((key, device))
    if table is None:
        table = _constants[(key, device)] = torch.as_tensor(make(),
                                                            device=device)
    return table
