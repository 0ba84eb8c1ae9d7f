"""Inputs that hold K8, K9 and K10 (``ops/cuda/anchors.py``) and their
plain versions in ``ops/anchors.py`` beyond the main path's own: a small
scene with a strong field, holes, weak blobs and random confidence, its
jitter and RANSAC draws at any ``rotate_time``, and crafted cases —
confidence ties and maps with no strong pixel for the flooding;
collinear, coincident and degenerate anchors, pixels with fewer than 3
anchors and triangles whose RANSAC costs tie for the fit; a flat depth
map (every anchor weight ties), weak pixels at the probes' border and
maps with too few strong pixels for anchor generation. All numpy, made
from a seed. One copy for the CPU tests and ``chip_smoke.py``."""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from ..config import STRONG, UNKNOWN, WEAK
from ..core import geometry as geo
from ..ops import anchors as anc

H, W = 64, 80
DEPTH_MIN, DEPTH_MAX = 2.0, 6.0
THRESH = 0.004
FOCAL = 120.0


def camera(h: int = H, w: int = W, focal: float = FOCAL) -> dict:
    """A pinhole reference camera at the origin: fx, fy, cx, cy."""
    return {"fx": focal, "fy": focal, "cx": w / 2, "cy": h / 2}


def camera_arrays(cam: dict) -> tuple:
    """(K, R, t, c) float32 arrays of ``camera``'s camera."""
    K = np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]],
                  [0, 0, 1]], np.float32)
    return K, np.eye(3, dtype=np.float32), np.zeros(3, np.float32), \
        np.zeros(3, np.float32)


def data(device="cpu", h: int = H, w: int = W) -> SimpleNamespace:
    """``camera``'s camera and the image size: what the anchor functions
    read of a ``cost.CostData``."""
    K, R, t, c = camera_arrays(camera(h, w))
    return SimpleNamespace(
        ref_cam=geo.CameraArrays(*(torch.as_tensor(a, device=device)
                                   for a in (K, R, t, c))),
        img_h=h, img_w=w)


def scene(seed: int = 0, holes: float = 0.25, noise: float = 0.015,
          h: int = H, w: int = W) -> tuple:
    """(weak, confidence, depth, valid): a strong field with random
    UNKNOWN holes, a weak blob in the middle and one near the border,
    random confidence, and a noisy planar depth map (noise scaled to the
    depth range, so RANSAC inlier counts vary); the last 3 columns are
    padding (not valid)."""
    rng = np.random.default_rng(seed)
    weak = np.full((h, w), STRONG, np.int32)
    weak[rng.random((h, w)) < holes] = UNKNOWN
    cy, cx = h * 31 // 64, w * 38 // 80
    weak[cy - 5:cy + 5, cx - 8:cx + 8] = WEAK
    weak[h * 3 // 4:h * 7 // 8, 7:13] = WEAK
    conf = rng.integers(0, 256, (h, w)).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    depth = (4.0 + 0.004 * xs + 0.003 * ys
             + noise * (DEPTH_MAX - DEPTH_MIN)
             * rng.standard_normal((h, w))).astype(np.float32)
    valid = np.ones((h, w), bool)
    valid[:, -3:] = False
    return weak, conf, depth, valid


def depth_planes(depth) -> np.ndarray:
    """(H, W, 4) planes (0, 0, -1, d): `geometry.depth_from_plane` gives d
    at every pixel."""
    planes = np.zeros(depth.shape + (4,), np.float32)
    planes[..., 2] = -1.0
    planes[..., 3] = depth
    return planes


def draws(rng, n: int, rotate_time: int) -> dict:
    """`AnchorRaws` fields for n weak pixels as numpy int32 arrays."""
    sr = anc._shift_range(rotate_time)
    drj = 8 * rotate_time * len(anc._radius_schedule(anc.RADIUS_BUDGET)) \
        * anc.JITTER_SAMPLES
    return dict(
        shift_x=rng.integers(-sr + 1, sr, (n, drj)).astype(np.int32),
        shift_y=rng.integers(-sr + 1, sr, (n, drj)).astype(np.int32),
        triplets=triplets(rng, n))


def triplets(rng, n: int) -> np.ndarray:
    """(RANSAC_ITERS, n, 3) raw RANSAC draws."""
    return rng.integers(0, 1 << 30, (anc.RANSAC_ITERS, n, 3)
                        ).astype(np.int32)


# ---------------------------------------------------------------------------
# K10: the nearest-strong flooding
# ---------------------------------------------------------------------------

JFA_CASES = ("scene", "ties", "equal_confidence", "no_strong", "one_strong",
             "invalid_strong")


def jfa_case(name: str, seed: int = 0, h: int = H, w: int = W) -> tuple:
    """(weak, confidence, valid) for the flooding: ``scene``; ``ties``
    (strong pixels on a 4-pixel lattice, so many candidates lie equally
    far, confidences drawn from three values); ``equal_confidence`` (the
    lattice, one confidence everywhere); ``no_strong`` (every pixel weak:
    (-1, -1) everywhere); ``one_strong`` (a single strong pixel in a
    corner); ``invalid_strong`` (the scene with its strong pixels in the
    left half not valid)."""
    rng = np.random.default_rng(seed)
    if name in ("scene", "invalid_strong"):
        weak, conf, _, valid = scene(seed, h=h, w=w)
        if name == "invalid_strong":
            valid = valid.copy()
            valid[:, : w // 2] = False
        return weak, conf, valid
    valid = np.ones((h, w), bool)
    weak = np.full((h, w), WEAK, np.int32)
    conf = np.full((h, w), 100.0, np.float32)
    if name in ("ties", "equal_confidence"):
        weak[1::4, 2::4] = STRONG
        weak[rng.random((h, w)) < 0.2] = UNKNOWN
        if name == "ties":
            conf = rng.choice(np.float32([0, 128, 255]), (h, w))
    elif name == "one_strong":
        weak[h - 2, 1] = STRONG
        conf = rng.integers(0, 256, (h, w)).astype(np.float32)
        conf[h - 2, 1] = 255.0
    elif name != "no_strong":
        raise ValueError(f"unknown flooding case {name!r}")
    return weak, conf.astype(np.float32), valid


# ---------------------------------------------------------------------------
# K9: the fit-plane RANSAC
# ---------------------------------------------------------------------------

class FitCase(NamedTuple):
    planes: np.ndarray     # (H, W, 4) camera-frame planes
    wx: np.ndarray         # (N,) int32
    wy: np.ndarray
    anchors: np.ndarray    # (N, 9, 2) int32
    triplets: np.ndarray   # (50, N, 3) int32


# the crafted anchor sets of ``fit_crafted``, one a pixel, in order
FIT_KINDS = ("ring", "collinear", "coincident", "zero_planes", "nan_planes",
             "none", "one", "two", "three", "half_missing", "off_map",
             "border")


def _ring(x: int, y: int, k: int, radius: int, phase: float) -> list:
    return [(int(round(x + radius * math.cos(phase + 2 * math.pi * i / k))),
             int(round(y + radius * math.sin(phase + 2 * math.pi * i / k))))
            for i in range(k)]


def fit_crafted(seed: int = 0, h: int = H, w: int = W) -> FitCase:
    """Weak pixels, each with one kind of anchor set (``FIT_KINDS``, in
    turn over a grid of pixels): ``ring`` (8 anchors around the pixel on
    the slanted noisy scene plane), ``collinear`` (8 on a line through
    it), ``coincident`` (8 on one pixel), ``zero_planes`` / ``nan_planes``
    (8 around it where the planes are zero (every point at the origin) or
    NaN: degenerate planes), ``none`` / ``one`` / ``two`` (fewer than 3
    anchors), ``three`` (3 around it: every iteration's cost is 0, so the
    first usable one wins), ``half_missing`` (x >= 0 but y = -1 on some
    slots), ``off_map`` (anchors past the map's far edge, whose planes
    read 0) and ``border`` (the pixel on the image's first row)."""
    rng = np.random.default_rng(seed)
    _, _, depth, _ = scene(seed, h=h, w=w)
    planes = depth_planes(depth)
    # a slanted plane's (n, w) on the left third
    cam = camera(h, w)
    n = np.array([0.2, -0.1, -1.0], np.float32)
    n /= np.linalg.norm(n)
    ys, xs = np.mgrid[0:h, 0:w]
    d = depth
    X = d * (xs - cam["cx"]) / cam["fx"]
    Y = d * (ys - cam["cy"]) / cam["fy"]
    wv = -(n[0] * X + n[1] * Y + n[2] * d)
    left = xs < w // 3
    planes[left, :3] = n
    planes[left, 3] = wv[left]
    zero_rows = slice(h // 2, h // 2 + 8)
    planes[zero_rows, w // 3:2 * w // 3] = 0.0
    nan_rows = slice(h // 2 + 10, h // 2 + 18)
    planes[nan_rows, w // 3:2 * w // 3] = np.nan

    wx, wy, anchors = [], [], []
    for i in range(3 * len(FIT_KINDS)):
        kind = FIT_KINDS[i % len(FIT_KINDS)]
        x = int(rng.integers(10, w - 10))
        y = int(rng.integers(10, h - 10))
        if kind in ("ring", "three") and i // len(FIT_KINDS) == 0:
            x = int(rng.integers(8, w // 3 - 8))   # on the slanted plane
        if kind == "zero_planes":
            x, y = w // 2, h // 2 + 4
        if kind == "nan_planes":
            x, y = w // 2, h // 2 + 14
        if kind == "border":
            y = 0
        a = np.full((8, 2), -1, np.int32)
        if kind in ("ring", "zero_planes", "nan_planes", "border",
                    "half_missing"):
            pts = _ring(x, y, 8, 3 + i % 3, rng.random())
        elif kind == "collinear":
            pts = [(x - 8 + 2 * k + (k >= 4), y) for k in range(8)]
        elif kind == "coincident":
            pts = [(x + 3, y + 3)] * 8
        elif kind == "off_map":
            pts = _ring(x, y, 5, 4, 0.3) + [(w + 2, y), (w + 5, y + 1),
                                            (x, h + 3)]
        else:
            k = {"none": 0, "one": 1, "two": 2, "three": 3}[kind]
            pts = _ring(x, y, k, 4, rng.random()) if k else []
        for s, (px, py) in enumerate(pts):
            a[s] = (px, py)
        if kind == "half_missing":
            a[1::3, 1] = -1
        anchors.append(np.concatenate([[[x, y]], a]).astype(np.int32))
        wx.append(x)
        wy.append(y)
    anchors = np.stack(anchors)
    return FitCase(planes, np.int32(wx), np.int32(wy), anchors,
                   triplets(rng, len(wx)))


# ---------------------------------------------------------------------------
# K8: anchor generation
# ---------------------------------------------------------------------------

GEN_CASES = ("flat", "border", "no_strong", "sparse")


class GenCase(NamedTuple):
    weak: np.ndarray           # (H, W) int32
    confidence: np.ndarray     # (H, W) f32
    depth: np.ndarray          # (H, W) f32
    valid: np.ndarray          # (H, W) bool
    nearest_strong: np.ndarray  # (H, W, 2) int32, or None: flood it
    wx: np.ndarray             # (N,) int32
    wy: np.ndarray


def gen_case(name: str, seed: int = 0, h: int = H, w: int = W) -> GenCase:
    """Anchor generation beyond the scene: ``flat`` (the scene at one
    depth: every hit lies on the support plane, so every anchor weight
    ties and the lower direction must win), ``border`` (weak pixels at
    MIN_MARGIN from each edge and in the corners), ``no_strong`` (a
    nearest-strong map of (-1, -1): no hits) and ``sparse`` (three strong
    pixels: at most one hit each, so fewer than 4 hits a pixel)."""
    weak, conf, depth, valid = scene(seed, h=h, w=w)
    ns = None
    if name == "flat":
        depth = np.full_like(depth, 4.0)
    elif name == "border":
        m = anc.MIN_MARGIN
        for x, y in ((m, m), (w - 1 - m, m), (m, h - 1 - m),
                     (w - 1 - m, h - 1 - m), (0, h // 2), (w - 1, h // 3),
                     (w // 2, 0), (w // 3, h - 1), (m + 1, h // 2),
                     (w // 2, m - 1)):
            weak[y, x] = WEAK
    elif name == "no_strong":
        ns = np.full((h, w, 2), -1, np.int32)
    elif name == "sparse":
        weak = np.where(weak == STRONG, UNKNOWN, weak).astype(np.int32)
        for x, y in ((10, 10), (w - 12, h // 2), (w // 3, h - 9)):
            weak[y, x] = STRONG
    else:
        raise ValueError(f"unknown anchor case {name!r}")
    wy, wx = np.nonzero(weak == WEAK)
    return GenCase(weak, conf, depth, valid, ns, wx.astype(np.int32),
                   wy.astype(np.int32))
