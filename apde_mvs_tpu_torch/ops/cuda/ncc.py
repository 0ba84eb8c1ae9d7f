"""K2 — the fused strong multi-view NCC: CUDA kernel, its plain PyTorch
version, and the wrapper that picks between them by the tensors' device.

Replaces the strong NCC the JAX package leaves to XLA
(``apde_mvs_tpu/ops/cost.py`` ``_per_view_ncc`` :248 and ``ncc_strong``
:276): for each pixel of a batch, its plane hypothesis and every source
view, the plane homography, the centre's out-of-image test, the T warped
window taps sampled from the view's quad table (K1's bilinear sample), the
three window sums and the NCC cost, COST_MAX where the centre leaves the
image, a variance or the weight sum is degenerate, or the cost is not
finite. ``cost.ncc_strong`` is one call of ``ncc_strong_fused``.

The kernel (``csrc/ncc.cu``) runs one thread per (pixel, view), a warp one
view of 32 pixels, 8 warps a block at any S, and keeps the (S, B, T)
coordinates and samples in registers; only the (S, B) costs are written.
What bounds it on the H100: operations (the function needs 38 f32
operations a tap and 90 a pair), not bytes: the window is read once, the
quad tables stay in L2.

The plain version fixes the operation order: the homography of
``geometry.homography``, the warp of ``geometry.warp``, K1's plain sample,
the window sums accumulated in tap order t = 0 .. T-1 from 0, compensated
(Kahan, four elementwise ops a tap: one running f32 sum drifts past the
1e-4 parity with the JAX package's sums), then ``cost.ncc_from_sums``.
The kernel computes the same sequence with every operation rounded on its
own, so the two agree bit for bit on the card.

The stage form, ``init_stage_fused`` (plain version ``init_stage_plain``),
is the initial cost's strong NCC: a range of the image's pixels under the
state's planes map, each pixel's window (``strong.window_plain``'s: the
square, or the SA star cut at the segment's edge, its sums in tap order)
built in the kernel, the costs written into a view-major (S, n) or
pixel-major (n, S) block. ``init.initial_cost`` is one launch of it, with
K6's re-score form and the selection K11.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises — there is no fallback. ``launches`` counts kernel launches, and
``site_launches`` splits them by the call site that asked for them
("init": the stage form, "debug_point": the debug tool, "strong": the
torch-op strong sweep of ``testing/strong_composition.py``; "other" for
any caller that names none). The strong sweep runs its NCC inside K3
(``ops/cuda/strong.py``), the disparity sweeps of DepthToWeak and
LocalRefine inside K5 (``ops/cuda/sweep.py``); both share K2's per-pixel
code (``csrc/ncc_common.cuh``).
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import numpy as np
import torch

from ...core import geometry as geo
from ..cost import COST_MAX, ncc_from_sums, square_taps
from . import build as _build
from .sampler import sample_packed_plain

launches = 0      # kernel launches since the last reset (plain runs excluded)
site_launches: dict = {}   # the same launches by call site

MAX_VIEWS = 32    # csrc/ncc_common.cuh kMaxViews: one warp's lanes (K5)
SMEM_LIMIT = 232448   # shared memory a block may use on Hopper (227 KB)
_SOURCES = ("ncc.cu",)


def reset_launches() -> None:
    global launches
    launches = 0
    site_launches.clear()


@functools.lru_cache(maxsize=None)
def library() -> _build.Built:
    """Build (once per source hash) and load the kernel library, with its
    entry points' ctypes signatures declared."""
    built = _build.build("apde_ncc", _SOURCES)
    lib = built.lib
    ptr = ctypes.c_void_p
    i32 = ctypes.c_int
    lib.apde_ncc_strong.argtypes = [
        ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr,
        ctypes.c_float, ptr, ctypes.c_int64, i32, i32, i32, i32, i32, i32,
        ptr]
    lib.apde_ncc_strong.restype = i32
    lib.apde_ncc_max_views.argtypes = []
    lib.apde_ncc_max_views.restype = i32
    lib.apde_ncc_smem_bytes.argtypes = [i32, i32, i32, i32]
    lib.apde_ncc_smem_bytes.restype = ctypes.c_longlong
    lib.apde_ncc_kernel_info.argtypes = [i32] * 5 + [ctypes.c_void_p] * 3
    lib.apde_ncc_kernel_info.restype = i32
    i64 = ctypes.c_int64
    lib.apde_ncc_stage.argtypes = [
        ptr, i32, ptr, i32, ptr, ptr, i32, ptr, i32, i32, ctypes.c_float,
        ptr, i64, i64, i64, i64, i32, i32, i32, i32, i32, ptr]
    lib.apde_ncc_stage.restype = i32
    lib.apde_ncc_stage_kernel_info.argtypes = [i32] * 5 + [ptr] * 3
    lib.apde_ncc_stage_kernel_info.restype = i32
    if lib.apde_ncc_max_views() != MAX_VIEWS:
        raise RuntimeError(f"csrc/ncc.cu takes {lib.apde_ncc_max_views()} "
                           f"views, the wrapper assumes {MAX_VIEWS}")
    return built


def read_kernel_info(fn, *args: int) -> dict:
    """Call a library's ``*_kernel_info`` entry point with the integers
    ``args`` that pick the instantiation: its registers, local memory
    (spill) bytes and resident blocks an SM."""
    out = [ctypes.c_int(0) for _ in range(3)]
    _raise_on(fn(*(int(a) for a in args),
                 *(ctypes.addressof(v) for v in out)), "kernel_info")
    return dict(zip(("regs", "local_bytes", "blocks_per_sm"),
                    (v.value for v in out)))


def kernel_info(quads_u8: bool, pixel_offsets: bool, weighted: bool,
                num_taps: int, num_views: int) -> dict:
    """The kernel instantiation's registers, local memory (spill) bytes and
    resident blocks an SM at ``num_views`` views, from the CUDA runtime."""
    return read_kernel_info(library().lib.apde_ncc_kernel_info, quads_u8,
                            pixel_offsets, weighted, num_taps, num_views)


def stage_kernel_info(quads_u8: bool, sa: bool, radius: int,
                      increment: int, num_views: int) -> dict:
    """The stage form's registers, local memory (spill) bytes and resident
    blocks an SM at ``num_views`` views: u8 or f32 tables, the SA window or
    the square of (radius, increment)."""
    return read_kernel_info(library().lib.apde_ncc_stage_kernel_info,
                            quads_u8, sa, radius, increment, num_views)


def camera_table(data) -> torch.Tensor:
    """(S + 1, 16) f32 per-view constants of the kernel: R_rel (9, row
    major), t_rel (3) of ``geometry.relative_pose`` and the source's fx,
    fy, cx, cy; row S holds the reference camera's fx, fy, cx, cy in
    columns 12-15."""
    ref, src = data.ref_cam, data.src_cams
    R_rel, t_rel = geo.relative_pose(ref, src)
    s = R_rel.shape[0]

    def intrinsics(cam):
        return torch.stack([cam.fx, cam.fy, cam.cx, cam.cy], -1)
    views = torch.cat([R_rel.reshape(s, 9), t_rel, intrinsics(src)], -1)
    ref_row = torch.cat([views.new_zeros(12), intrinsics(ref)])
    return torch.cat([views, ref_row[None]]).to(torch.float32).contiguous()


_tables: dict = {}    # id(CostData) -> (weak reference, camera table)


def cache_per_data(store: dict, data, make):
    """``make(data)``, kept in ``store`` once per CostData object and dropped
    with it."""
    key = id(data)
    hit = store.get(key)
    if hit is not None and hit[0]() is data:
        return hit[1]
    value = make(data)
    store[key] = (weakref.ref(data, lambda _: store.pop(key, None)), value)
    return value


def cached_camera_table(data) -> torch.Tensor:
    """``camera_table(data)``, built once per CostData object and dropped
    with it."""
    return cache_per_data(_tables, data, camera_table)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def ncc_strong_plain(data, x, y, plane, win) -> torch.Tensor:
    """The (B, S) strong NCC cost as torch ops on (S, B) tensors, in the
    kernel's operation order."""
    H = geo.homography(data.ref_cam, data.src_views, plane)   # (S, B, 3, 3)
    cx, cy = geo.warp(H, x, y)                                # (S, B)
    oob = (cx < 0) | (cx >= data.img_w) | (cy < 0) | (cy >= data.img_h)
    tx = x[:, None] + win.tap_dx                              # (B, T)
    ty = y[:, None] + win.tap_dy
    wx, wy = geo.warp(H[..., None, :, :], tx, ty)             # (S, B, T)
    sv = sample_packed_plain(data.src_quads, data.width, data.quad_h, wx, wy)
    if win.tap_w is None:
        terms = (sv, sv * sv, win.tap_val * sv)
    else:
        wsv = win.tap_w * sv
        terms = (wsv, wsv * sv, (win.tap_w * win.tap_val) * sv)
    # (T, 3, S, B): one contiguous (3, S, B) slab a tap
    per_tap = torch.stack(terms).permute(3, 0, 1, 2).contiguous()
    # compensated (Kahan) sums in tap order, as the kernel takes them
    sums = torch.zeros_like(per_tap[0])
    comp = torch.zeros_like(sums)
    for t in range(per_tap.shape[0]):
        term = per_tap[t] - comp
        total = sums + term
        comp = (total - sums) - term
        sums = total
    cost = ncc_from_sums(win.sum_ref, win.sum_rr, sums[0], sums[1], sums[2],
                         win.wsum)
    return torch.where(oob, COST_MAX, cost).T


def init_stage_plain(data, planes, lo: int, hi: int, radius: int,
                     increment: int, use_sa: bool) -> torch.Tensor:
    """The (hi - lo, S) strong NCC costs of the stage form: pixels lo ..
    hi - 1 in raster order, each with its plane of the (H, W, 4) map
    ``planes`` and its window of ``strong.window_plain`` (sums in tap
    order; under SA the star cut at the segment's edge)."""
    from .strong import window_plain
    flat = torch.arange(lo, hi, device=planes.device)
    x = (flat % data.width).to(torch.float32)
    y = torch.div(flat, data.width, rounding_mode="floor").to(torch.float32)
    win = window_plain(data, x, y, radius, increment, use_sa)
    return ncc_strong_plain(data, x, y, planes.reshape(-1, 4)[lo:hi], win)


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------

def _check_args(data, x, y, plane, win) -> tuple:
    """Shapes, dtypes, devices and the view limit, on every device.
    Returns (B, T, per-pixel offsets, {name: (tensor, shape)})."""
    b = x.shape[0] if x.ndim == 1 else -1
    t, pixel_offsets, want = check_window(data, b, win, x.shape)
    want.update({"x": (x, (b,)), "y": (y, (b,)), "plane": (plane, (b, 4))})
    _check_tensors(want, data.src_quads.device)
    return b, t, pixel_offsets, want


def check_tables(data) -> None:
    """The view limit and the source quad tables."""
    quads = data.src_quads
    s = data.num_src
    if s > MAX_VIEWS:
        raise ValueError(f"{s} source views; the fused NCC kernel takes at "
                         f"most {MAX_VIEWS}")
    if quads.ndim != 3 or quads.shape[0] != s or quads.shape[-1] != 4 \
            or quads.shape[1] != data.quad_h * data.width:
        raise ValueError(f"quads must be ({s}, {data.quad_h}*{data.width}, "
                         f"4), got {tuple(quads.shape)}")
    if quads.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"quad table dtype {quads.dtype} (u8 or f32)")


def check_window(data, b: int, win, pixels=None) -> tuple:
    """The view limit, the quad tables, and the window of ``b`` pixels
    (``pixels``: the pixel tensor's shape, for the message). Returns (T,
    per-pixel offsets, {name: (tensor, shape)}) for `_check_tensors`."""
    check_tables(data)
    t = win.tap_val.shape[-1] if win.tap_val.ndim == 2 else 0
    offsets = win.tap_dx.shape
    want = {"tap_val": (win.tap_val, (b, t)),
            "tap_dy": (win.tap_dy, offsets),
            "sum_ref": (win.sum_ref, (b,)), "sum_rr": (win.sum_rr, (b,))}
    if win.tap_w is not None:
        want["tap_w"] = (win.tap_w, (b, t))
    if isinstance(win.wsum, torch.Tensor):
        want["wsum"] = (win.wsum, (b,))
    if b < 0 or t < 1 or offsets not in ((t,), (b, t)):
        raise ValueError(f"pixels {tuple(pixels or (b,))}, window values "
                         f"{tuple(win.tap_val.shape)}, offsets "
                         f"{tuple(offsets)}: need (B,), (B, T) and (T,) or "
                         "(B, T)")
    want["tap_dx"] = (win.tap_dx, offsets)
    return t, len(offsets) == 2, want


def _check_tensors(want: dict, device) -> None:
    """Each of ``want``'s (tensor, shape) has that shape, float32, on
    ``device``."""
    for name, (a, shape) in want.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} is {tuple(a.shape)}, expected {shape}")
        if a.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {a.dtype}, expected float32")
        if a.device != device:
            raise ValueError(f"{name} is on {a.device}, the quad tables on "
                             f"{device}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def ncc_strong_fused(data, x, y, plane, win, site: str = "other"
                     ) -> torch.Tensor:
    """Multi-view NCC cost vector (B, S) of ``plane`` (B, 4) at pixels
    (x, y) (B,) f32 against every source view of ``data`` (a
    ``cost.CostData``), over the reference window ``win`` (a
    ``cost.RefWindow``). Every tensor must be contiguous on CUDA. ``site``
    names the caller in ``site_launches``."""
    b, t, pixel_offsets, tensors = _check_args(data, x, y, plane, win)
    quads = data.src_quads
    if quads.device.type == "cpu":
        return ncc_strong_plain(data, x, y, plane, win)
    if quads.device.type != "cuda":
        raise ValueError(f"unsupported device {quads.device}")
    for name, (a, _) in tensors.items():
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not quads.is_contiguous():
        raise ValueError("quads must be contiguous")
    if quads.data_ptr() % (4 * quads.element_size()):
        raise ValueError("quad table rows must be aligned to their size")
    weighted = win.tap_w is not None
    lib = library().lib
    smem = lib.apde_ncc_smem_bytes(data.num_src, t, int(pixel_offsets),
                                   int(weighted))
    if smem > SMEM_LIMIT:
        raise ValueError(f"a {t}-tap window needs {smem} B of shared memory "
                         f"a block, more than {SMEM_LIMIT}")
    cams = cached_camera_table(data)
    if cams.device != quads.device:
        raise ValueError(f"cameras on {cams.device}, the quad tables on "
                         f"{quads.device}")
    if isinstance(win.wsum, torch.Tensor):
        wsum_ptr, inv = win.wsum.data_ptr(), 0.0
    else:
        wsum_ptr, inv = None, float(np.float32(1.0) / np.float32(win.wsum))
    out = torch.empty((data.num_src, b), dtype=torch.float32,
                      device=quads.device)
    if b == 0:
        return out.T
    global launches
    launches += 1
    site_launches[site] = site_launches.get(site, 0) + 1
    _raise_on(lib.apde_ncc_strong(
        quads.data_ptr(), int(quads.dtype == torch.uint8), cams.data_ptr(),
        x.data_ptr(), y.data_ptr(), plane.data_ptr(), win.tap_dx.data_ptr(),
        win.tap_dy.data_ptr(), int(pixel_offsets), win.tap_val.data_ptr(),
        win.tap_w.data_ptr() if weighted else None, win.sum_ref.data_ptr(),
        win.sum_rr.data_ptr(), wsum_ptr, inv, out.data_ptr(), b,
        data.num_src, t, data.width, data.quad_h, data.img_w, data.img_h,
        torch.cuda.current_stream(quads.device).cuda_stream),
        "apde_ncc_strong")
    return out.T


def check_block(out: torch.Tensor, num_views: int, view_major: bool,
                columns: int, device) -> tuple:
    """An (S, n) view-major or (n, S) pixel-major float32 block of costs
    on ``device``, contiguous, with at least ``columns`` pixel columns.
    Returns the strides (a view's, a pixel's) in elements."""
    n = out.shape[1] if view_major else out.shape[0]
    want = (num_views, n) if view_major else (n, num_views)
    if out.ndim != 2 or tuple(out.shape) != want or n < columns:
        raise ValueError(f"costs block {tuple(out.shape)}: need "
                         f"{'(S, n)' if view_major else '(n, S)'} with S = "
                         f"{num_views} and n >= {columns}")
    if out.dtype != torch.float32:
        raise TypeError(f"costs block has dtype {out.dtype}, expected "
                        "float32")
    if out.device != device:
        raise ValueError(f"costs block on {out.device}, the quad tables on "
                         f"{device}")
    if not out.is_contiguous():
        raise ValueError("costs block must be contiguous")
    return (n, 1) if view_major else (1, num_views)


def check_planes_map(data, planes, what: str = "planes") -> None:
    """``planes``: the state's (H, W, 4) float32 map, contiguous, on the
    quad tables' device."""
    want = (data.height, data.width, 4)
    if tuple(planes.shape) != want or planes.dtype != torch.float32:
        raise ValueError(f"{what} must be a float32 {want} map, got "
                         f"{planes.dtype} {tuple(planes.shape)}")
    if planes.device != data.src_quads.device:
        raise ValueError(f"{what} on {planes.device}, the quad tables on "
                         f"{data.src_quads.device}")
    if not planes.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def sa_ids(data, use_sa: bool, num_taps: int):
    """The segment ids the SA window reads, or None (no SA, or no mask
    loaded); SA mixes the star with 36-tap squares only."""
    if not use_sa or data.sa_mask is None:
        return None
    if num_taps != 36:
        raise ValueError("SA mixing assumes 36-tap square windows")
    mask = data.sa_mask
    if tuple(mask.shape) != (data.height, data.width) \
            or mask.dtype != torch.int32 or not mask.is_contiguous():
        raise ValueError(f"sa_mask must be a contiguous int32 "
                         f"({data.height}, {data.width}) map")
    return mask


def init_stage_fused(data, planes, lo: int, hi: int, out, *, radius: int,
                     increment: int, use_sa: bool, view_major: bool,
                     col0=None) -> None:
    """K2's stage form: the strong NCC of pixels lo .. hi - 1 (raster
    indices of the H x W image) under their planes in the state's (H, W, 4)
    map ``planes``, over the window K2 builds from the reference image (the
    square of (radius, increment) or, with ``use_sa`` and a mask, the star
    cut at the segment's edge). Writes pixel f's S costs into column f -
    ``col0`` (default ``lo``) of ``out``, an (S, n) view-major or (n, S)
    pixel-major float32 block. One launch on CUDA tensors, counted under
    the site "init"; the plain version on CPU tensors."""
    check_tables(data)
    check_planes_map(data, planes)
    col0 = lo if col0 is None else col0
    if not 0 <= col0 <= lo <= hi <= data.height * data.width:
        raise ValueError(f"pixels {lo} .. {hi} from column {col0}: outside "
                         f"the {data.height}x{data.width} image")
    quads = data.src_quads
    s = data.num_src
    vs, ps = check_block(out, s, view_major, hi - col0, quads.device)
    t = len(square_taps(radius, increment))
    if t < 1:
        raise ValueError(f"no window of radius {radius}, increment "
                         f"{increment}")
    sa = sa_ids(data, use_sa, t)
    if quads.device.type == "cpu":
        costs = init_stage_plain(data, planes, lo, hi, radius, increment,
                                 use_sa)
        if view_major:
            out[:, lo - col0:hi - col0] = costs.T
        else:
            out[lo - col0:hi - col0] = costs
        return
    if quads.device.type != "cuda":
        raise ValueError(f"unsupported device {quads.device}")
    if not quads.is_contiguous():
        raise ValueError("quads must be contiguous")
    if quads.data_ptr() % (4 * quads.element_size()):
        raise ValueError("quad table rows must be aligned to their size")
    lib = library().lib
    smem = lib.apde_ncc_smem_bytes(s, t, int(sa is not None),
                                   int(sa is not None))
    if smem > SMEM_LIMIT:
        raise ValueError(f"a {t}-tap window needs {smem} B of shared memory "
                         f"a block, more than {SMEM_LIMIT}")
    from . import sweep
    cams = sweep.cached_camera_table(data)
    if hi == lo:
        return
    global launches
    launches += 1
    site_launches["init"] = site_launches.get("init", 0) + 1
    _raise_on(lib.apde_ncc_stage(
        quads.data_ptr(), int(quads.dtype == torch.uint8), cams.data_ptr(),
        cams.shape[1], planes.data_ptr(), data.ref_image.data_ptr(),
        data.height, None if sa is None else sa.data_ptr(), radius,
        increment, float(np.float32(1.0) / np.float32(t)),
        out.data_ptr() + (lo - col0) * ps * out.element_size(), vs, ps, lo,
        hi - lo, s, data.width, data.quad_h, data.img_w, data.img_h,
        torch.cuda.current_stream(quads.device).cuda_stream),
        "apde_ncc_stage")
