"""K8, K9 and K10 — the APD setup of a pass as CUDA kernels: anchor
generation, the fit-plane RANSAC and the nearest-strong jump flooding
(``csrc/anchors.cu``, with ``csrc/ransac_common.cuh``).

Replace the torch-op compositions of ``ops/anchors.py`` (the JAX package's
XLA-compiled ``apde_mvs_tpu/ops/anchors.py``: ``nearest_strong_jfa``
:44-99, ``gen_anchors`` :191-373, ``ransac_fit_planes`` :386-467): K10 is
one launch a (step, neighbour) sub-pass of the flooding (96 at 600x800),
K8 one launch a chunk of weak pixels (a warp a pixel, a lane a direction),
K9 one launch a call (a thread a pixel). What bounds them on the H100:
bytes (K9: the 50 RANSAC draws of a pixel; K8: those and the probes'
jitter draws and nearest-strong texels), operations for K10's flooding;
the source says what each design does about it.

The plain versions stay in ``ops/anchors.py`` (``nearest_strong_jfa_plain``,
``gen_anchors_chunk_plain``, ``ransac_fit_planes_plain``), which picks
between them and these wrappers by the tensors' device: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel here or raises; these
wrappers raise on any other device. Every kernel equals its plain version
bit for bit on the card. ``jfa_launches``, ``anchor_launches`` and
``fit_launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import torch

from ...config import ANCHOR_NUM, STRONG
from . import build as _build
from .ncc import _raise_on, read_kernel_info

jfa_launches = 0      # K10 launches since the last reset (8 a step)
anchor_launches = 0   # K8 launches (one a chunk)
fit_launches = 0      # K9 launches (one a call)

MAX_DIRECTIONS = 32   # K8 runs a direction a lane of one warp
SLOTS = ANCHOR_NUM - 1  # anchors besides the pixel itself
_SOURCES = ("anchors.cu",)
_KERNELS = {"K10": 0, "K9": 1, "K8": 2}


class Camera(NamedTuple):
    """The reference camera's intrinsics as float32 values."""

    fx: float
    fy: float
    cx: float
    cy: float


def reset_launches() -> None:
    global jfa_launches, anchor_launches, fit_launches
    jfa_launches = anchor_launches = fit_launches = 0


@functools.lru_cache(maxsize=None)
def library() -> _build.Built:
    """Build (once per source hash) and load the kernel library, with its
    entry points' ctypes signatures declared."""
    built = _build.build("apde_anchors", _SOURCES)
    lib = built.lib
    ptr = ctypes.c_void_p
    i32 = ctypes.c_int
    i64 = ctypes.c_int64
    f32 = ctypes.c_float
    lib.apde_jfa.argtypes = [ptr, ptr, ptr, i32, i32, i32,
                             ctypes.POINTER(ctypes.c_int), i32, ptr, ptr,
                             ptr]
    lib.apde_fit_planes.argtypes = ([ptr, i32, i32, ptr, ptr, ptr, ptr, i64,
                                     i32, i32] + [f32] * 4 + [ptr, ptr])
    lib.apde_gen_anchors.argtypes = (
        [ptr, ptr, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, i64, i32,
         i32, ptr, ptr, i32, i32, i32, i32] + [f32] * 7
        + [ptr, ptr, ptr, ptr])
    for fn in (lib.apde_jfa, lib.apde_fit_planes, lib.apde_gen_anchors):
        fn.restype = i32
    consts = (lib.apde_anchor_max_directions, lib.apde_anchor_slots)
    for fn in consts:
        fn.argtypes = []
        fn.restype = i32
    lib.apde_anchor_kernel_info.argtypes = [i32, ptr, ptr, ptr]
    lib.apde_anchor_kernel_info.restype = i32
    if tuple(fn() for fn in consts) != (MAX_DIRECTIONS, SLOTS):
        raise RuntimeError("csrc/anchors.cu's direction limit or slots "
                           "differ from the wrapper's")
    return built


def kernel_info(name: str) -> dict:
    """``name`` ("K8", "K9" or "K10")'s registers, local memory (spill)
    bytes and resident blocks an SM, from the CUDA runtime."""
    return read_kernel_info(library().lib.apde_anchor_kernel_info,
                            _KERNELS[name])


def camera(cam) -> Camera:
    """A ``geometry.CameraArrays`` (one camera)'s intrinsics on the host."""
    k = cam.K.detach().to("cpu", torch.float32)
    return Camera(float(k[0, 0]), float(k[1, 1]), float(k[0, 2]),
                  float(k[1, 2]))


def _check(name: str, a: torch.Tensor, shape, dtype, dev,
           align: int = 4) -> None:
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{name} is {tuple(a.shape)}, expected "
                         f"{tuple(shape)}")
    if a.dtype != dtype:
        raise TypeError(f"{name} has dtype {a.dtype}, expected {dtype}")
    if a.device != dev:
        raise ValueError(f"{name} is on {a.device}, expected {dev}")
    if not a.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if a.data_ptr() % align:
        raise ValueError(f"{name} must be aligned to {align} bytes")


def _cuda_device(a: torch.Tensor) -> torch.device:
    if a.device.type != "cuda":
        raise ValueError(f"the anchor kernels take CUDA tensors, not "
                         f"{a.device}")
    return a.device


def _triplets(triplets: torch.Tensor, n: int, dev) -> tuple:
    """The raw RANSAC draws (iterations, n, 3) int32 on ``dev``, each
    (n, 3) block contiguous (a column slice of a longer draw is taken as it
    is); returns the stride between iterations and their count."""
    if triplets.ndim != 3 or tuple(triplets.shape[1:]) != (n, 3):
        raise ValueError(f"triplets are {tuple(triplets.shape)}, expected "
                         f"(iterations, {n}, 3)")
    if triplets.dtype != torch.int32 or triplets.device != dev:
        raise ValueError(f"triplets must be int32 on {dev}, got "
                         f"{triplets.dtype} on {triplets.device}")
    if (n > 1 and triplets.stride(1) != 3) or triplets.stride(2) != 1:
        raise ValueError("each iteration's (n, 3) triplets must be "
                         "contiguous")
    return triplets.stride(0), triplets.shape[0]


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def nearest_strong(weak: torch.Tensor, confidence: torch.Tensor,
                   valid: torch.Tensor, steps: Sequence[int]) -> torch.Tensor:
    """K10: the (H, W, 2) int32 nearest-strong map of ``weak`` (H, W)
    int32, ``confidence`` (H, W) f32 and ``valid`` (H, W) bool, flooded
    with the jump ``steps`` in order, 8 neighbours a step."""
    dev = _cuda_device(weak)
    h, w = weak.shape
    _check("weak", weak, (h, w), torch.int32, dev)
    _check("confidence", confidence, (h, w), torch.float32, dev)
    _check("valid", valid, (h, w), torch.bool, dev, 1)
    if not steps or min(steps) < 1:
        raise ValueError(f"jump steps must be >= 1, got {list(steps)}")
    out = torch.empty((h, w, 2), dtype=torch.int32, device=dev)
    if h * w == 0:
        return out
    scratch = torch.empty_like(out)
    host_steps = (ctypes.c_int * len(steps))(*steps)
    global jfa_launches
    jfa_launches += 8 * len(steps)
    _raise_on(library().lib.apde_jfa(
        weak.data_ptr(), confidence.data_ptr(), valid.data_ptr(), STRONG, h,
        w, host_steps, len(steps), out.data_ptr(), scratch.data_ptr(),
        _stream(dev)), "apde_jfa")
    return out


def fit_planes(planes: torch.Tensor, weak_x: torch.Tensor,
               weak_y: torch.Tensor, anchors: torch.Tensor,
               triplets: torch.Tensor, cam: Camera) -> torch.Tensor:
    """K9: the (N, 4) fit planes of the weak pixels (``weak_x``,
    ``weak_y``) (N,) int32 from their ``anchors`` (N, 9, 2) int32 on the
    camera-frame ``planes`` (H, W, 4) f32, with the raw draws ``triplets``
    (iterations, N, 3) int32; zeros where no fit."""
    dev = _cuda_device(planes)
    n = weak_x.shape[0]
    h, w = planes.shape[:2]
    _check("planes", planes, (h, w, 4), torch.float32, dev, 16)
    _check("weak_x", weak_x, (n,), torch.int32, dev)
    _check("weak_y", weak_y, (n,), torch.int32, dev)
    _check("anchors", anchors, (n, SLOTS + 1, 2), torch.int32, dev, 8)
    stride, iters = _triplets(triplets, n, dev)
    out = torch.empty((n, 4), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    global fit_launches
    fit_launches += 1
    _raise_on(library().lib.apde_fit_planes(
        planes.data_ptr(), h, w, weak_x.data_ptr(), weak_y.data_ptr(),
        anchors.data_ptr(), triplets.data_ptr(), stride, iters, n, *cam,
        out.data_ptr(), _stream(dev)), "apde_fit_planes")
    return out


def gen_anchors(nearest_strong_map: torch.Tensor, planes: torch.Tensor,
                img_h: int, img_w: int, weak_x: torch.Tensor,
                weak_y: torch.Tensor, shift_x: torch.Tensor,
                shift_y: torch.Tensor, triplets: torch.Tensor,
                dirs: torch.Tensor, radii: torch.Tensor, jitter: int,
                cam: Camera, cone_cos: float, threshold: float,
                depth_diff: float, margin: int) -> tuple:
    """K8: (anchors (N, 9, 2) int32, reliable (N,) bool, hit counts (N,)
    int32) of the weak pixels (``weak_x``, ``weak_y``) (N,) int32 over the
    D directions ``dirs`` (D, 2) f32 (8 <= D <= 32) and the radii
    ``radii`` (Rn,) f32 with ``jitter`` probes each, from the
    nearest-strong map (H, W, 2) int32, the depths at ``planes[..., 3]``
    (H, W, 4) f32, the jitter draws (N, D * Rn * jitter) int32 and the
    RANSAC draws (iterations, N, 3) int32. ``cone_cos``, ``threshold`` and
    ``depth_diff`` are float32 values; ``img_h`` x ``img_w`` bounds the
    probes, which keep ``margin`` from its edges."""
    dev = _cuda_device(planes)
    n = weak_x.shape[0]
    d, rn = dirs.shape[0], radii.shape[0]
    if not SLOTS <= d <= MAX_DIRECTIONS:
        raise ValueError(f"{d} directions: the anchor kernel runs a "
                         f"direction a lane of one warp, {SLOTS} to "
                         f"{MAX_DIRECTIONS}")
    h, w = planes.shape[:2]
    drj = d * rn * jitter
    _check("nearest_strong", nearest_strong_map, (h, w, 2), torch.int32,
           dev, 8)
    _check("planes", planes, (h, w, 4), torch.float32, dev, 16)
    _check("weak_x", weak_x, (n,), torch.int32, dev)
    _check("weak_y", weak_y, (n,), torch.int32, dev)
    _check("shift_x", shift_x, (n, drj), torch.int32, dev)
    _check("shift_y", shift_y, (n, drj), torch.int32, dev)
    _check("dirs", dirs, (d, 2), torch.float32, dev)
    _check("radii", radii, (rn,), torch.float32, dev)
    stride, iters = _triplets(triplets, n, dev)
    anchors = torch.empty((n, SLOTS + 1, 2), dtype=torch.int32, device=dev)
    reliable = torch.empty((n,), dtype=torch.bool, device=dev)
    hits = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return anchors, reliable, hits
    global anchor_launches
    anchor_launches += 1
    _raise_on(library().lib.apde_gen_anchors(
        nearest_strong_map.data_ptr(), planes.data_ptr(), h, w, img_h, img_w,
        weak_x.data_ptr(), weak_y.data_ptr(), shift_x.data_ptr(),
        shift_y.data_ptr(), triplets.data_ptr(), stride, iters, margin,
        dirs.data_ptr(), radii.data_ptr(), n, d, rn, jitter, *cam, cone_cos, threshold,
        depth_diff, anchors.data_ptr(), reliable.data_ptr(), hits.data_ptr(),
        _stream(dev)), "apde_gen_anchors")
    return anchors, reliable, hits
