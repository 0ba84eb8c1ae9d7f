"""Image reading / writing / resizing.

The reference reads grayscale via OpenCV and keeps raw 0-255 float32 values
with no normalization (APD.cpp:137-160); images are downscaled with bilinear
interpolation for pyramid rounds (APD.cpp:564-588) and auxiliary maps with
nearest (APD.cpp:592-652). Both resize kernels are numpy and match OpenCV's
pixel-center convention (src = (dst + 0.5) * scale - 0.5).

8-bit gray / gray+alpha / RGB / RGBA PNG (non-interlaced, filters 0-4) is
read and written with the standard library's zlib, so a scan of PNG images
needs no imaging package. Other formats (JPEG) go through PIL, which is
optional: `pil_available()` says whether it imports, and reading or writing
such a file without it raises a clear error.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np


_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def write_png(path, img: np.ndarray) -> None:
    """Encode (H, W) gray or (H, W, 3|4) RGB(A) uint8 as PNG (filter 0)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    raw = np.zeros((h, w * c + 1), np.uint8)
    raw[:, 1:] = img.reshape(h, w * c)

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0,
                                           0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


def _resize_axis_coords(dst_size: int, src_size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    scale = src_size / dst_size
    x = (np.arange(dst_size, dtype=np.float64) + 0.5) * scale - 0.5
    x0 = np.floor(x).astype(np.int64)
    frac = (x - x0).astype(np.float32)
    x0c = np.clip(x0, 0, src_size - 1)
    x1c = np.clip(x0 + 1, 0, src_size - 1)
    return x0c, x1c, frac


def resize_bilinear(img: np.ndarray, new_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize with OpenCV INTER_LINEAR pixel-center convention."""
    h, w = img.shape[:2]
    nh, nw = new_hw
    if (nh, nw) == (h, w):
        return img.copy()
    y0, y1, fy = _resize_axis_coords(nh, h)
    x0, x1, fx = _resize_axis_coords(nw, w)
    img_f = img.astype(np.float32)
    top = img_f[y0][:, x0] * (1 - fx)[None, :, *([None] * (img.ndim - 2))] \
        + img_f[y0][:, x1] * fx[None, :, *([None] * (img.ndim - 2))]
    bot = img_f[y1][:, x0] * (1 - fx)[None, :, *([None] * (img.ndim - 2))] \
        + img_f[y1][:, x1] * fx[None, :, *([None] * (img.ndim - 2))]
    fy_b = fy[:, None] if img.ndim == 2 else fy[:, None, None]
    out = top * (1 - fy_b) + bot * fy_b
    if np.issubdtype(img.dtype, np.integer):
        out = np.clip(np.rint(out), np.iinfo(img.dtype).min,
                      np.iinfo(img.dtype).max).astype(img.dtype)
    else:
        out = out.astype(img.dtype)
    return out


def resize_nearest(img: np.ndarray, new_hw: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbor resize (OpenCV INTER_NEAREST convention: floor of
    dst * scale)."""
    h, w = img.shape[:2]
    nh, nw = new_hw
    if (nh, nw) == (h, w):
        return img.copy()
    ys = np.minimum((np.arange(nh) * (h / nh)).astype(np.int64), h - 1)
    xs = np.minimum((np.arange(nw) * (w / nw)).astype(np.int64), w - 1)
    return img[ys][:, xs].copy()


def scaled_size(h: int, w: int, scale_size: int) -> Tuple[int, int]:
    """Target size for a pyramid scale factor (reference: APD.cpp:566-568,
    round(size / scale))."""
    factor = 1.0 / float(scale_size)
    return int(round(h * factor)), int(round(w * factor))
