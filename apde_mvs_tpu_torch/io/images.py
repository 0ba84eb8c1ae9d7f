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
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

SUPPORTED_EXTS = (".jpg", ".png", ".jpeg", ".JPG", ".PNG", ".JPEG")

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # color type -> channels


def pil_available() -> bool:
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return False
    return True


def _require_pil(path):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{path}: only 8-bit PNG is handled without PIL; install "
            "Pillow to read or write other image formats") from e
    return Image


def _is_png(path) -> bool:
    return Path(path).suffix.lower() == ".png"


def _unfilter(raw: bytes, h: int, w: int, c: int) -> np.ndarray:
    """Undo the per-row PNG filters (types 0-4) of 8-bit samples."""
    stride = w * c
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for r in range(h):
        ftype = int(rows[r, 0])
        line = rows[r, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:          # Sub: running sum along each channel
            cur = np.cumsum(line.reshape(w, c), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:          # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):     # Average, Paeth: sequential over pixels
            px = line.reshape(w, c)
            up = prev.reshape(w, c)
            cur2 = np.zeros((w, c), np.int32)
            zero = np.zeros(c, np.int32)
            for i in range(w):
                a = cur2[i - 1] if i else zero
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    cc = up[i - 1] if i else zero
                    p = a + b - cc
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
                    pred = np.where((pa <= pb) & (pa <= pc), a,
                                    np.where(pb <= pc, b, cc))
                cur2[i] = (px[i] + pred) & 0xFF
            cur = cur2.reshape(-1)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[r] = cur
        prev = cur
    return out.reshape(h, w, c)


def read_png(path) -> np.ndarray:
    """Decode an 8-bit non-interlaced PNG to (H, W, C) uint8, C in 1..4."""
    data = Path(path).read_bytes()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, _comp, _filt, interlace = hdr
    if depth != 8 or color not in _PNG_CHANNELS or interlace != 0:
        img = _require_pil(path)
        with img.open(path) as im:
            return np.asarray(im.convert("RGB"), np.uint8)
    c = _PNG_CHANNELS[color]
    return _unfilter(zlib.decompress(b"".join(idat)), h, w, c)


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


def _read_rgb(path) -> np.ndarray:
    """(H, W, 3) uint8 RGB, as PIL's convert("RGB") gives it."""
    if _is_png(path):
        px = read_png(path)
        c = px.shape[2]
        if c in (1, 2):
            return np.repeat(px[..., :1], 3, axis=2)
        return px[..., :3].copy()
    image = _require_pil(path)
    with image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def read_image_gray(path: Union[str, Path],
                    cache: Optional["MemoryCache"] = None) -> np.ndarray:
    """Grayscale float32 image with raw 0-255 values (reference: APD.cpp:137-160).

    Uses ITU-R 601-2 luma (0.299 R + 0.587 G + 0.114 B), the same weights as
    OpenCV's IMREAD_GRAYSCALE.
    """
    key = str(path)
    if cache is not None and key in cache.img_cache:
        return cache.img_cache[key]
    rgb = _read_rgb(path).astype(np.float32)
    gray = rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114
    gray = gray.astype(np.float32)
    if cache is not None:
        cache.img_cache[key] = gray
    return gray


def read_image_color(path: Union[str, Path]) -> np.ndarray:
    """BGR uint8 image (matches OpenCV IMREAD_COLOR channel order used in fusion,
    APD.cpp:1092)."""
    return _read_rgb(path)[..., ::-1].copy()


def write_image(path: Union[str, Path], img: np.ndarray) -> None:
    """Write a uint8 image; 3-channel input is interpreted as BGR."""
    if img.ndim == 3:
        img = img[..., ::-1]
    if _is_png(path):
        write_png(path, img)
        return
    image = _require_pil(path)
    image.fromarray(np.ascontiguousarray(img)).save(str(path))


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
