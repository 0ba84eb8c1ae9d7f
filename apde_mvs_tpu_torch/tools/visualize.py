"""Debug visualization writers (reference: Show*, APD.cpp:162-314)."""

from __future__ import annotations

import numpy as np

from ..config import STRONG, UNKNOWN, WEAK
from ..io.images import write_image


def _jet(gray: np.ndarray) -> np.ndarray:
    """OpenCV-style jet colormap on a uint8 grayscale image; returns BGR."""
    x = gray.astype(np.float32) / 255.0
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return (np.stack([b, g, r], -1) * 255).astype(np.uint8)


def show_depth_map(path, depth: np.ndarray, depth_min: float,
                   depth_max: float) -> None:
    """Depth -> jet colormap scaled to mean +/- 2 std of in-range depths."""
    ok = (depth >= depth_min) & (depth <= depth_max) & np.isfinite(depth)
    vals = depth[ok]
    if vals.size:
        mean, std = float(vals.mean()), float(vals.std())
    else:
        mean, std = 0.0, 1.0
    lo, hi = mean - 2 * std, mean + 2 * std
    norm = np.clip((depth - lo) / max(hi - lo, 1e-9), 0, 1)
    write_image(path, _jet((norm * 255).astype(np.uint8)))


def show_normal_map(path, normal: np.ndarray) -> None:
    n = np.linalg.norm(normal, axis=-1, keepdims=True)
    unit = np.where(n > 0, normal / np.maximum(n, 1e-12), 0.0)
    img = np.clip(unit * 127.5 + 127.5, 0, 255).astype(np.uint8)
    write_image(path, img)


def show_weak_image(path, weak: np.ndarray) -> None:
    img = np.zeros(weak.shape + (3,), np.uint8)
    img[weak == WEAK] = (255, 255, 255)
    img[weak == STRONG] = (0, 255, 0)
    img[weak == UNKNOWN] = (0, 0, 255)
    write_image(path, img)


def show_confidence_map(path, confidence: np.ndarray) -> None:
    c = confidence.astype(np.float32)
    lo, hi = float(c.min()), float(c.max())
    norm = (c - lo) / max(hi - lo, 1.0)
    write_image(path, (norm * 255).astype(np.uint8))
