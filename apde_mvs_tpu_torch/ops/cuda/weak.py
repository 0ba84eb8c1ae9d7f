"""K6 — the deformable NCC of weak pixels, with the geometric cost K4
inside: CUDA kernel, its plain PyTorch version, and the wrapper that picks
between them by the tensors' device.

Replaces the weak sites of K1 (``apde_mvs_tpu/ops/pallas/sampler.py:38``)
and the torch ops around them: the JAX package's ``deformable.ncc_weak``
(``apde_mvs_tpu/ops/deformable.py:124-198``) and the weak sweep's
``cost.geom_cost``. For each weak pixel of a chunk, each of its P plane
hypotheses and each source view: the plane homography, the centre's
out-of-image test (COST_MAX outside), the centre window's NCC (36 square
taps, SA 0/1 tap weights), each of the 8 anchors' 9-tap sparse window NCC
where the anchor is valid, stays in the image and its weight sum is > 0
(an anchor that leaves the image counts at COST_MAX iff it selected the
view), the focal softmax over the anchors that count and the 0.25 / 0.75
blend with the centre; with ``geom`` the geometric cost of the pair as a
second output. With ``view_weights`` only the views weighing > 0 are
evaluated: the others get COST_MAX and geometric cost 0, which change no
weighted sum (every cost is finite). ``deformable.ncc_weak_planes`` is one
call of ``weak_fused``; the torch-op composition it replaced (two K1
launches and ~575 torch ops a plane, a torch-op ``geom_cost``) is
``testing/weak_composition.py``.

The kernel (``csrc/weak.cu``) runs a chunk's P planes in one launch: a
warp a pixel, its reference side staged once in shared memory, its
(plane, view) pairs across the lanes; only the outputs are written. What
bounds it on the H100: operations (K2's 38 a tap and 90 a pair for the
centre, the same a tap and ~33 an anchor for every anchor that counts, K4's
115 a pair).

The plain version fixes every operation's order: the centre's and each
anchor's window through K2's plain NCC (``ncc.ncc_strong_plain``: the
homography, the warp, K1's plain sample, Kahan sums in tap order,
``cost.ncc_from_sums`` with the float32 1 / T of a float weight sum), the
warp tests of ``geometry.warp``, the softmax's sums in anchor order as
ordered adds with one true division, ``cost.geom_cost``'s torch ops. The
kernel computes the same sequence with every operation rounded on its own,
so the two agree bit for bit on the card.

The re-score form is the initial cost's re-score of the weak list: the
kernel builds each pixel's reference side itself, from the weak list, its
anchors, the state's planes and prior selections: a block takes 4 G
pixels, G = `rescore_pixels` a warp, and builds their sides together (the
taps and sums of K7's reference side, only the parts the costs read: the
centres and the valid anchors), then costs each (pixel, view) on a lane.
Its
selection mode, ``rescore_select_fused`` (plain version
``rescore_select_plain``: K11's plain selection of ``rescore_plain``'s
costs), runs the pixel's top-k view selection in an epilogue and writes
the state's new cost map and selections at the pixel (the serial and
view-parallel routes); its cost-out mode, ``rescore_fused`` (plain version
``rescore_plain``: ``weak_ref_plain`` and ``weak_plain`` on the pixel's
own plane), writes the S costs into the pixels' columns of a block (the
tile route's compact block). Since K7 it is the only form a main path
launches.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises — there is no fallback. ``launches`` counts kernel launches and
``planes`` the plane hypotheses a pixel they evaluated (P each; 1 a
re-score launch).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ...core import geometry as geo
from ...core.sampling import clamped_fetch, device_constant, fetch
from ..cost import COST_MAX, RefWindow, geom_cost, square_taps
from ..deformable import WeakRefData
from . import build as _build
from . import ncc, sweep
from .strong import ordered_sum, window_plain

launches = 0      # kernel launches since the last reset (plain runs excluded)
planes = 0        # plane hypotheses a pixel those launches evaluated

MAX_VIEWS = ncc.MAX_VIEWS
CAM_STRIDE = sweep.CAM_STRIDE   # the camera table is K5's
ANCHORS = 8
SMEM_LIMIT = ncc.SMEM_LIMIT
WARPS = 4            # a block's warps (csrc/weak.cu kWarps)
RESCORE_MAX = 8      # a warp's pixels in the re-score form, at most
_SOURCES = ("weak.cu",)


class WeakCosts(NamedTuple):
    """A launch's outputs."""

    ncc: torch.Tensor              # (B, P, S) deformable NCC costs
    geom: Optional[torch.Tensor]   # (B, P, S) geometric costs, or None


def reset_launches() -> None:
    global launches, planes
    launches = 0
    planes = 0


@functools.lru_cache(maxsize=None)
def library() -> _build.Built:
    """Build (once per source hash) and load the kernel library, with its
    entry points' ctypes signatures declared."""
    built = _build.build("apde_weak", _SOURCES)
    lib = built.lib
    ptr = ctypes.c_void_p
    i32 = ctypes.c_int
    lib.apde_weak.argtypes = (
        [ptr, i32, ptr, ptr, i32, i32, ptr, ptr, ptr, i32, ptr]
        + [ptr] * 7 + [ctypes.c_float] + [ptr] * 11 + [ptr, ptr]
        + [ctypes.c_int64] + [i32] * 7 + [ptr])
    lib.apde_weak.restype = i32
    for fn in (lib.apde_weak_max_views, lib.apde_weak_cam_stride,
               lib.apde_weak_anchors):
        fn.argtypes = []
        fn.restype = i32
    lib.apde_weak_smem_bytes.argtypes = [i32, i32, i32, i32]
    lib.apde_weak_smem_bytes.restype = ctypes.c_longlong
    lib.apde_weak_kernel_info.argtypes = [i32] * 6 + [ptr] * 3
    lib.apde_weak_kernel_info.restype = i32
    i64 = ctypes.c_int64
    lib.apde_weak_rescore.argtypes = (
        [ptr, i32, ptr, ptr, ptr, i32, i32, ptr, ptr, ptr, ptr, i32, ptr]
        + [i32] * 4 + [ptr, i64, i64, i32, ptr, ptr, ptr, i32, i64]
        + [i32] * 5 + [ptr])
    lib.apde_weak_rescore.restype = i32
    lib.apde_weak_rescore_smem_bytes.argtypes = [i32] * 6
    lib.apde_weak_rescore_smem_bytes.restype = ctypes.c_longlong
    lib.apde_weak_rescore_kernel_info.argtypes = [i32] * 7 + [ptr] * 3
    lib.apde_weak_rescore_kernel_info.restype = i32
    if (lib.apde_weak_max_views(), lib.apde_weak_cam_stride(),
            lib.apde_weak_anchors()) != (MAX_VIEWS, CAM_STRIDE, ANCHORS):
        raise RuntimeError("csrc/weak.cu's view limit, camera table or "
                           "anchor count differs from the wrapper's")
    return built


def kernel_info(quads_u8: bool, weighted: bool, geom: bool, num_taps: int,
                num_anchor_taps: int, num_views: int) -> dict:
    """The kernel instantiation's registers, local memory (spill) bytes and
    resident blocks an SM at ``num_views`` views, from the CUDA runtime:
    u8 or f32 tables, SA tap weights or none, geometric cost or none, the
    centre's and the anchors' tap counts."""
    return ncc.read_kernel_info(library().lib.apde_weak_kernel_info,
                                quads_u8, weighted, geom, num_taps,
                                num_anchor_taps, num_views)


def rescore_kernel_info(quads_u8: bool, sa: bool, num_views: int,
                        windows=(5, 2, 5, 5)) -> dict:
    """The re-score form's registers, local memory (spill) bytes and
    resident blocks an SM at ``num_views`` views: u8 or f32 tables, SA
    windows or not, the windows (strong radius, increment, weak radius,
    increment)."""
    return ncc.read_kernel_info(library().lib.apde_weak_rescore_kernel_info,
                                quads_u8, sa, *windows, num_views)


def rescore_pixels(num_views: int) -> int:
    """G, a warp's pixels in the re-score form (csrc/weak.cu's
    `rescore_pixels`): as many as fill its 32 lanes with their S views, at
    most RESCORE_MAX; a block takes WARPS G."""
    return min(32 // num_views, RESCORE_MAX)


def rescore_smem_bytes(num_views: int, windows=(5, 2, 5, 5),
                       sa: bool = True) -> int:
    """The re-score form's shared memory a block (csrc/weak.cu's
    `rescore_smem_floats`) at S views with the windows (strong radius,
    increment, weak radius, increment): the camera table, the two windows'
    offsets, a warp's G reference sides (`weak_common.cuh`'s
    `WeakRefSlice`: the centre's and 8 anchors' tap values, SA weights,
    the anchors' 8 words of coordinates, sums and selections) and its (8,
    32) anchor costs, and the block builder's scratch (15 words a pixel
    and a count)."""
    r, inc, ar, ainc = windows
    t = len(square_taps(r, inc))
    ta = len(square_taps(ar, ainc))
    g = rescore_pixels(num_views)
    side = (t + ANCHORS * ta) * (2 if sa else 1) + 8 * ANCHORS
    return 4 * ((num_views + 1) * CAM_STRIDE + 2 * (t + ta)
                + WARPS * (g * side + ANCHORS * 32) + 15 * WARPS * g + 1)


@functools.lru_cache(maxsize=None)
def _anchor_offsets(radius: int, increment: int, device: str):
    taps = torch.as_tensor(square_taps(radius, increment),
                           device=device).to(torch.float32)
    return taps[:, 0].contiguous(), taps[:, 1].contiguous()


def anchor_offsets(radius: int, increment: int, device):
    """The anchors' sparse window offsets (dx, dy), (T',) f32 each:
    ``cost.square_taps(radius, increment)``, dy outer."""
    return _anchor_offsets(int(radius), int(increment), str(device))


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def weak_ref_plain(data, x, y, anchors, selected, strong_radius: int,
                   strong_increment: int, weak_radius: int,
                   weak_increment: int, use_sa: bool) -> WeakRefData:
    """The reference side K7 and K6's re-score form build for weak pixels
    (x, y) f32 with their (B, 9, 2) anchors (csrc/weak_common.cuh,
    `build_weak_ref`): ``deformable.WeakRefData.build``'s taps, weights,
    anchor masks and selections, every window's sums taken in tap order.
    The centre window is the square of (strong_radius, strong_increment);
    under SA a tap weighs 1 where the pixel is in no segment (id <= 0) or
    the tap's id is the pixel's (no star, no truncation), and the anchors'
    windows weigh against the weak pixel's segment too."""
    sa = bool(use_sa) and data.sa_mask is not None
    dev = x.device
    xi, yi = x.to(torch.int32), y.to(torch.int32)
    seg = fetch(data.sa_mask, xi, yi) if sa else None

    def weights(tx, ty):
        extra = (1,) * (tx.ndim - 1)
        keep = (seg <= 0).reshape(seg.shape + extra) \
            | (fetch(data.sa_mask, tx, ty) == seg.reshape(seg.shape + extra))
        return keep.to(torch.float32)

    def sums(val, w):
        """(sum_ref, sum_rr, weight sum) in tap order: the terms w v and
        (w v) v, the weights' count; T without weights."""
        wv = val if w is None else w * val
        count = torch.full(val.shape[:-1], float(val.shape[-1]), device=dev) \
            if w is None else w.sum(-1)
        return ordered_sum(wv), ordered_sum(wv * val), count

    if sa:
        sq = device_constant(
            ("square_taps", strong_radius, strong_increment),
            lambda: square_taps(strong_radius, strong_increment), dev)
        ctx, cty = xi[:, None] + sq[:, 0], yi[:, None] + sq[:, 1]
        cval = clamped_fetch(data.ref_image, ctx, cty)
        cw = weights(ctx, cty)
        centre = RefWindow(sq[:, 0].to(torch.float32),
                           sq[:, 1].to(torch.float32), cval, *sums(cval, cw),
                           cw)
    else:
        centre = window_plain(data, x, y, strong_radius,
                                     strong_increment, False)
    ax, ay = anchors[:, 1:, 0], anchors[:, 1:, 1]
    exists = (ax >= 0) & (ay >= 0)
    axc, ayc = torch.clamp(ax, min=0), torch.clamp(ay, min=0)
    valid = exists
    if sa:
        valid = exists & ((seg <= 0)[:, None]
                          | (fetch(data.sa_mask, axc, ayc) == seg[:, None]))
    wk = device_constant(("square_taps", weak_radius, weak_increment),
                         lambda: square_taps(weak_radius, weak_increment),
                         dev)
    tx, ty = axc[..., None] + wk[:, 0], ayc[..., None] + wk[:, 1]
    tval = clamped_fetch(data.ref_image, tx, ty)              # (B, 8, T')
    tw = weights(tx, ty) if sa else None
    sum_ref, sum_rr, wsum = sums(tval, tw)
    return WeakRefData(
        x=x, y=y, center_win=centre, anchor_x=ax.to(torch.float32),
        anchor_y=ay.to(torch.float32), anchor_valid=valid,
        anchor_sel=fetch(selected, axc, ayc), tap_val=tval, tap_w=tw,
        sum_ref=sum_ref, sum_rr=sum_rr, wsum=wsum)


def weak_plain(data, wref, planes_, radius: int, increment: int, *,
               geom: bool, view_weights=None) -> WeakCosts:
    """The (B, P, S) deformable NCC costs (and geometric costs) of
    ``planes_`` (B, P, 4) as torch ops, in the kernel's operation order."""
    b, p = planes_.shape[:2]
    s = data.num_src
    n = b * p
    dev = planes_.device
    pix = torch.arange(b, device=dev).repeat_interleave(p)
    flat = planes_.reshape(n, 4)
    x, y = wref.x[pix], wref.y[pix]
    cw = wref.center_win

    wsum = cw.wsum[pix] if isinstance(cw.wsum, torch.Tensor) else cw.wsum
    centre = ncc.ncc_strong_plain(data, x, y, flat, RefWindow(
        cw.tap_dx, cw.tap_dy, cw.tap_val[pix], cw.sum_ref[pix],
        cw.sum_rr[pix], wsum,
        None if cw.tap_w is None else cw.tap_w[pix]))           # (N, S)

    # the anchors: one row a (pixel, plane, anchor)
    adx, ady = anchor_offsets(radius, increment, dev)
    ax, ay = wref.anchor_x[pix], wref.anchor_y[pix]             # (N, 8)
    k = ax.shape[1]

    def rows(v):
        return None if v is None else v[pix].reshape((n * k,) + v.shape[2:])
    acost = ncc.ncc_strong_plain(
        data, ax.reshape(-1), ay.reshape(-1),
        flat[:, None].expand(n, k, 4).reshape(n * k, 4),
        RefWindow(adx, ady, rows(wref.tap_val), rows(wref.sum_ref),
                  rows(wref.sum_rr), rows(wref.wsum),
                  rows(wref.tap_w))).reshape(n, k, s)

    # the warp tests: the centre's and each anchor's, against the real
    # bounds
    hom = geo.homography(data.ref_cam, data.src_views, flat)   # (S, N, 3, 3)

    def outside(wx, wy):
        return (wx < 0) | (wx >= data.img_w) | (wy < 0) | (wy >= data.img_h)
    centre_oob = outside(*geo.warp(hom, x, y)).T               # (N, S)
    anchor_oob = outside(*geo.warp(hom[..., None, :, :], ax, ay)).permute(
        1, 2, 0)                                                # (N, 8, S)

    # the contribution rules and the focal softmax, in anchor order
    valid = wref.anchor_valid[pix][..., None]
    computable = valid & ~anchor_oob & (wref.wsum[pix] > 0)[..., None]
    counts = computable | (valid & anchor_oob & wref.anchor_sel[pix])
    vals = torch.where(computable, acost, COST_MAX)
    top = torch.amax(torch.where(counts, vals, -torch.inf), dim=1)
    e = torch.where(counts, torch.exp(vals - top[:, None]), 0.0)
    denom = torch.zeros_like(top)
    num = torch.zeros_like(top)
    for a in range(k):
        denom = denom + e[:, a]
        num = num + e[:, a] * vals[:, a]
    anchored = torch.where(denom > 0,
                           num / torch.clamp(denom, min=1e-30), 0.0)
    anchored = torch.clamp(anchored, max=COST_MAX)
    cost = torch.where(counts.any(1), 0.25 * centre + 0.75 * anchored,
                       centre)
    cost = torch.where(centre_oob, COST_MAX, cost)
    g = geom_cost(data, x, y, flat) if geom else None
    if view_weights is not None:
        keep = view_weights[pix] > 0
        cost = torch.where(keep, cost, COST_MAX)
        g = torch.where(keep, g, 0.0) if geom else None
    return WeakCosts(cost.reshape(b, p, s),
                     g.reshape(b, p, s) if geom else None)


def rescore_plain(data, planes_map, selected, x, y, anchors, *,
                  strong_radius: int, strong_increment: int,
                  weak_radius: int, weak_increment: int,
                  use_sa: bool) -> torch.Tensor:
    """The (B, S) costs of the re-score form: weak pixels (x, y) int32
    with their (B, 9, 2) anchors, each against every view under its own
    plane of the (H, W, 4) map ``planes_map``, its reference side
    `weak_ref_plain`'s (the anchors' selections from the prior
    ``selected``), its cost `weak_plain`'s."""
    wref = weak_ref_plain(data, x.to(torch.float32), y.to(torch.float32),
                          anchors, selected, strong_radius, strong_increment,
                          weak_radius, weak_increment, use_sa)
    own = fetch(planes_map, x, y)[:, None]
    return weak_plain(data, wref, own, weak_radius, weak_increment,
                      geom=False).ncc[:, 0]


def rescore_select_plain(data, planes_map, selected, x, y, anchors, valid,
                         top_k: int, **windows):
    """The selection mode's plain version: the (B,) costs and (B, S)
    selections of weak pixels (x, y), K11's plain selection
    (``select.select_rows_plain``) of `rescore_plain`'s costs with the
    pixels' validity in the (H, W) map ``valid``."""
    from .select import select_rows_plain
    costs = rescore_plain(data, planes_map, selected, x, y, anchors,
                          **windows)
    return select_rows_plain(costs, fetch(valid, x, y), top_k)


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------

def _check_args(data, wref, planes_, radius: int, increment: int,
                geom: bool, view_weights) -> tuple:
    """Shapes, dtypes, devices, contiguity and the view limit, on every
    device. Returns (B, P, T, T', SA weights)."""
    ncc.check_tables(data)
    s = data.num_src
    b = wref.x.shape[0] if wref.x.ndim == 1 else -1
    if planes_.ndim != 3 or planes_.shape[0] != b or planes_.shape[1] < 1 \
            or planes_.shape[2] != 4:
        raise ValueError(f"planes must be ({b}, P, 4), got "
                         f"{tuple(planes_.shape)}")
    p = planes_.shape[1]
    cw = wref.center_win
    t = cw.tap_val.shape[-1] if cw.tap_val.ndim == 2 else 0
    ta = len(square_taps(radius, increment))
    weighted = cw.tap_w is not None
    if t < 1 or (wref.tap_w is not None) != weighted:
        raise ValueError("the centre window needs (B, T) values, and SA "
                         "weights on both windows or on neither")
    floats = {
        "x": (wref.x, (b,)), "y": (wref.y, (b,)), "planes": (planes_, None),
        "tap_dx": (cw.tap_dx, (t,)), "tap_dy": (cw.tap_dy, (t,)),
        "tap_val": (cw.tap_val, (b, t)), "sum_ref": (cw.sum_ref, (b,)),
        "sum_rr": (cw.sum_rr, (b,)),
        "anchor_x": (wref.anchor_x, (b, ANCHORS)),
        "anchor_y": (wref.anchor_y, (b, ANCHORS)),
        "anchor tap_val": (wref.tap_val, (b, ANCHORS, ta)),
        "anchor sum_ref": (wref.sum_ref, (b, ANCHORS)),
        "anchor sum_rr": (wref.sum_rr, (b, ANCHORS)),
        "anchor wsum": (wref.wsum, (b, ANCHORS))}
    if weighted:
        floats["tap_w"] = (cw.tap_w, (b, t))
        floats["anchor tap_w"] = (wref.tap_w, (b, ANCHORS, ta))
    if isinstance(cw.wsum, torch.Tensor):
        floats["wsum"] = (cw.wsum, (b,))
    if view_weights is not None:
        floats["view_weights"] = (view_weights, (b, s))
    if geom:
        depths = data.src_depths
        if depths.ndim != 3:
            raise ValueError(f"src_depths must be (S, H, W), got "
                             f"{tuple(depths.shape)}")
        floats["src_depths"] = (depths, (s,) + tuple(depths.shape[1:]))
    want = {name: (a, tuple(a.shape) if shape is None else shape,
                   torch.float32) for name, (a, shape) in floats.items()}
    want["anchor_valid"] = (wref.anchor_valid, (b, ANCHORS), torch.bool)
    want["anchor_sel"] = (wref.anchor_sel, (b, ANCHORS, s), torch.bool)
    dev = data.src_quads.device
    for name, (a, shape, dtype) in want.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} is {tuple(a.shape)}, expected {shape}")
        if a.dtype != dtype:
            raise TypeError(f"{name} has dtype {a.dtype}, expected {dtype}")
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, the quad tables on "
                             f"{dev}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return b, p, t, ta, weighted


def weak_fused(data, wref, planes_, radius: int, increment: int, *,
               geom: bool, view_weights=None) -> WeakCosts:
    """The deformable NCC of ``planes_`` (B, P, 4), P plane hypotheses for
    each weak pixel of ``wref`` (a ``deformable.WeakRefData``), against
    every source view of ``data`` (a ``cost.CostData``): (B, P, S) costs.
    The anchors' windows are ``cost.square_taps(radius, increment)``. With
    ``geom`` also the (B, P, S) geometric costs against
    ``data.src_depths``; with ``view_weights`` (B, S) only the views
    weighing > 0 are evaluated, the others get COST_MAX and geometric cost
    0. Every tensor must be contiguous."""
    b, p, t, ta, weighted = _check_args(
        data, wref, planes_, radius, increment, geom, view_weights)
    quads = data.src_quads
    if quads.device.type == "cpu":
        return weak_plain(data, wref, planes_, radius, increment, geom=geom,
                          view_weights=view_weights)
    if quads.device.type != "cuda":
        raise ValueError(f"unsupported device {quads.device}")
    if not quads.is_contiguous():
        raise ValueError("quads must be contiguous")
    if quads.data_ptr() % (4 * quads.element_size()):
        raise ValueError("quad table rows must be aligned to their size")
    s = data.num_src
    lib = library().lib
    smem = lib.apde_weak_smem_bytes(s, t, ta, int(weighted))
    if smem > SMEM_LIMIT:
        raise ValueError(f"{t}- and {ta}-tap windows at {s} views need "
                         f"{smem} B of shared memory a block, more than "
                         f"{SMEM_LIMIT}")
    cams = sweep.cached_camera_table(data)
    if cams.device != quads.device:
        raise ValueError(f"cameras on {cams.device}, the quad tables on "
                         f"{quads.device}")
    adx, ady = anchor_offsets(radius, increment, quads.device)
    cw = wref.center_win
    if isinstance(cw.wsum, torch.Tensor):
        wsum_ptr, inv = cw.wsum.data_ptr(), 0.0
    else:
        wsum_ptr, inv = None, float(np.float32(1.0) / np.float32(cw.wsum))
    out = WeakCosts(
        torch.empty((b, p, s), dtype=torch.float32, device=quads.device),
        torch.empty((b, p, s), dtype=torch.float32, device=quads.device)
        if geom else None)
    if b == 0:
        return out
    global launches, planes
    launches += 1
    planes += p
    depths = data.src_depths

    def ptr(a):
        return None if a is None else a.data_ptr()
    ncc._raise_on(lib.apde_weak(
        quads.data_ptr(), int(quads.dtype == torch.uint8), cams.data_ptr(),
        depths.data_ptr() if geom else None,
        depths.shape[1] if geom else 0, depths.shape[2] if geom else 0,
        wref.x.data_ptr(), wref.y.data_ptr(), planes_.data_ptr(), p,
        ptr(view_weights), cw.tap_dx.data_ptr(), cw.tap_dy.data_ptr(),
        cw.tap_val.data_ptr(), ptr(cw.tap_w), cw.sum_ref.data_ptr(),
        cw.sum_rr.data_ptr(), wsum_ptr, inv, adx.data_ptr(), ady.data_ptr(),
        wref.anchor_x.data_ptr(), wref.anchor_y.data_ptr(),
        wref.anchor_valid.data_ptr(), wref.anchor_sel.data_ptr(),
        wref.tap_val.data_ptr(), ptr(wref.tap_w), wref.sum_ref.data_ptr(),
        wref.sum_rr.data_ptr(), wref.wsum.data_ptr(), out.ncc.data_ptr(),
        ptr(out.geom), b, s, t, ta, data.width, data.quad_h, data.img_w,
        data.img_h, torch.cuda.current_stream(quads.device).cuda_stream),
        "apde_weak")
    return out


def _check_rescore(data, planes_map, selected, x, y, anchors, lo: int,
                   hi: int, use_sa: bool, strong_radius: int,
                   strong_increment: int) -> tuple:
    """The re-score form's shared checks. Returns (N, the SA segment ids or
    None)."""
    ncc.check_tables(data)
    ncc.check_planes_map(data, planes_map)
    s = data.num_src
    dev = data.src_quads.device
    n = x.shape[0] if x.ndim == 1 else -1
    h, w = data.height, data.width
    for name, a, shape, dtype in (
            ("x", x, (n,), torch.int32), ("y", y, (n,), torch.int32),
            ("anchors", anchors, (n, ANCHORS + 1, 2), torch.int32),
            ("selected", selected, (h, w, s), torch.bool)):
        if tuple(a.shape) != shape or a.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{a.dtype} {tuple(a.shape)}")
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, the quad tables on "
                             f"{dev}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 0 <= lo <= hi <= n:
        raise ValueError(f"items {lo} .. {hi} of a {n}-item list")
    sa = ncc.sa_ids(data, use_sa,
                    len(square_taps(strong_radius, strong_increment)))
    return n, sa


def _launch_rescore(data, planes_map, selected, x, y, anchors, lo: int,
                    hi: int, sa, windows: tuple, out=None, strides=(0, 0),
                    scatter: bool = False, valid=None, maps=(None, None),
                    top_k: int = 0) -> None:
    """One launch of the re-score form on CUDA tensors (list items lo ..
    hi - 1): the cost-out mode into ``out`` (its address the block's first
    column: item ``lo``'s where not ``scatter``) with ``strides``, or the
    selection mode into ``maps`` (the cost map and the selections)."""
    quads = data.src_quads
    dev = quads.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not quads.is_contiguous():
        raise ValueError("quads must be contiguous")
    if quads.data_ptr() % (4 * quads.element_size()):
        raise ValueError("quad table rows must be aligned to their size")
    s = data.num_src
    lib = library().lib
    smem = rescore_smem_bytes(s, windows, sa is not None)
    if smem > SMEM_LIMIT:
        raise ValueError(f"the re-score form's windows at {s} views need "
                         f"{smem} B of shared memory a block, more than "
                         f"{SMEM_LIMIT}")
    cams = sweep.cached_camera_table(data)
    if hi == lo:
        return
    global launches, planes
    launches += 1
    planes += 1
    ncc._raise_on(lib.apde_weak_rescore(
        quads.data_ptr(), int(quads.dtype == torch.uint8), cams.data_ptr(),
        planes_map.data_ptr(), selected.data_ptr(), data.height, data.width,
        x.data_ptr() + 4 * lo, y.data_ptr() + 4 * lo,
        anchors.data_ptr() + 4 * (ANCHORS + 1) * 2 * lo,
        data.ref_image.data_ptr(), data.height,
        None if sa is None else sa.data_ptr(), *windows, out, strides[0],
        strides[1], int(scatter), None if valid is None else valid.data_ptr(),
        None if maps[0] is None else maps[0].data_ptr(),
        None if maps[1] is None else maps[1].data_ptr(), int(top_k), hi - lo,
        s, data.width, data.quad_h, data.img_w, data.img_h,
        torch.cuda.current_stream(dev).cuda_stream), "apde_weak_rescore")


def rescore_fused(data, planes_map, selected, x, y, anchors, lo: int,
                  hi: int, out, *, strong_radius: int, strong_increment: int,
                  weak_radius: int, weak_increment: int, use_sa: bool,
                  view_major: bool, col0=None) -> None:
    """K6's re-score form, the cost-out mode (the tile route's): the
    deformable NCC of weak pixels lo .. hi - 1 of the list (x, y) (N,)
    int32 with their (N, 9, 2) int32 anchors, each under its own plane of
    the state's (H, W, 4) map ``planes_map`` against every view, the
    reference side built in the kernel (the anchors' selected views from
    the prior (H, W, S) ``selected``). Writes the S costs of a pixel into
    ``out``, an (S, n) view-major or (n, S) pixel-major float32 block: into
    the pixel's raster column y W + x where ``col0`` is None (n = H W),
    else into column i - ``col0`` for list item i. One launch on CUDA
    tensors, the plain version on CPU tensors."""
    windows = (strong_radius, strong_increment, weak_radius, weak_increment)
    n, sa = _check_rescore(data, planes_map, selected, x, y, anchors, lo, hi,
                           use_sa, strong_radius, strong_increment)
    s = data.num_src
    h, w = data.height, data.width
    scatter = col0 is None
    if not (scatter or 0 <= col0 <= lo):
        raise ValueError(f"items {lo} .. {hi} from column {col0} of a "
                         f"{n}-item list")
    vs, ps = ncc.check_block(out, s, view_major,
                             h * w if scatter else hi - col0,
                             data.src_quads.device)
    if scatter and (out.shape[1] if view_major else out.shape[0]) != h * w:
        raise ValueError(f"costs block {tuple(out.shape)}: the scatter "
                         f"writes raster columns of {h}x{w}")
    if data.src_quads.device.type == "cpu":
        costs = rescore_plain(
            data, planes_map, selected, x[lo:hi], y[lo:hi], anchors[lo:hi],
            strong_radius=strong_radius, strong_increment=strong_increment,
            weak_radius=weak_radius, weak_increment=weak_increment,
            use_sa=use_sa)
        cols = y[lo:hi].long() * w + x[lo:hi].long() if scatter \
            else torch.arange(lo - col0, hi - col0)
        if view_major:
            out[:, cols] = costs.T
        else:
            out[cols] = costs
        return
    base = out.data_ptr() if scatter \
        else out.data_ptr() + (lo - col0) * ps * out.element_size()
    _launch_rescore(data, planes_map, selected, x, y, anchors, lo, hi, sa,
                    windows, out=base, strides=(vs, ps), scatter=scatter)


def rescore_select_fused(data, planes_map, selected, x, y, anchors, lo: int,
                         hi: int, valid, top_k: int, cost_map, sel_out, *,
                         strong_radius: int, strong_increment: int,
                         weak_radius: int, weak_increment: int,
                         use_sa: bool) -> None:
    """K6's re-score form with the selection in its epilogue (the serial
    and view-parallel routes): the costs of weak pixels lo .. hi - 1 as
    `rescore_fused` computes them from the prior selections ``selected``,
    and each pixel's top-k view selection (K11's,
    ``select.select_rows_plain``) with its validity in the state's (H, W)
    ``valid`` map, written into the state's new (H, W) float32
    ``cost_map`` and (H, W, S) bool ``sel_out`` at the pixel, over what K2's
    stage form wrote there. ``sel_out`` must not overlap ``selected``. One
    launch on CUDA tensors, the plain version on CPU
    tensors."""
    windows = (strong_radius, strong_increment, weak_radius, weak_increment)
    _, sa = _check_rescore(data, planes_map, selected, x, y, anchors, lo,
                           hi, use_sa, strong_radius, strong_increment)
    ncc.check_state_maps(data, valid, top_k, (cost_map, sel_out))
    a, b = sel_out.data_ptr(), selected.data_ptr()
    if a < b + selected.numel() and b < a + sel_out.numel():
        raise ValueError("the new selections overlap the prior selections "
                         "the re-score reads")
    if data.src_quads.device.type == "cpu":
        cost, sel = rescore_select_plain(
            data, planes_map, selected, x[lo:hi], y[lo:hi], anchors[lo:hi],
            valid, top_k, strong_radius=strong_radius,
            strong_increment=strong_increment, weak_radius=weak_radius,
            weak_increment=weak_increment, use_sa=use_sa)
        yl, xl = y[lo:hi].long(), x[lo:hi].long()
        cost_map[yl, xl] = cost
        sel_out[yl, xl] = sel
        return
    _launch_rescore(data, planes_map, selected, x, y, anchors, lo, hi, sa,
                    windows, valid=valid, maps=(cost_map, sel_out),
                    top_k=top_k)
