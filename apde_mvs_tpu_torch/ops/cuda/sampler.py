"""K1 — the bilinear sampler: CUDA kernel, its plain PyTorch version, and
the wrapper that picks between them by the tensors' device.

Replaces the TPU kernel ``apde_mvs_tpu/ops/pallas/sampler.py`` (
``_sampler_kernel``, launched by ``sample_blocks``): bilinear sampling with
edge clamp, written there as hat-weight matmuls over a 24x256 VMEM window
for the v5e's MXU. On Hopper the gather itself is cheap, so the kernel
(``csrc/sampler.cu``) is the plain definition: one thread per sample, a
float clamp that keeps NaN, one 4-byte (u8) or 16-byte (f32) quad-row load,
and the lerp. The Pallas window-edge clamp is a TPU artefact and is not
reproduced: both forms equal the JAX oracle (``core.sampling.quad_coords`` +
``lerp_quad_rows``; ``bilinear_sample``).

What bounds it on the H100: bytes. Each sample streams its two f32
coordinates in and its f32 sample out (12 bytes); the quad tables (4 bytes
a pixel and view for u8, ~19 MB at 600x800x10) stay resident in the 50 MB
L2 and are read from device memory about once. A few flops per sample put
it far below the card's compute roofline.

Forms:

- ``sample_packed(quads, width, height, x, y)``: quads (S, N, 4) u8 or f32
  in the ``pack_bilinear`` layout (N = height * width), x, y (S, ...) f32 ->
  (S, ...) f32: one launch samples all S source views of one plane
  hypothesis, the form the deformable NCC took before K6.
- ``sample_blocks(img, xs, ys)``: the Pallas entry's own contract, one (H, W)
  f32 image, coordinates of any shape.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises — there is no fallback. ``launches`` counts kernel launches, and
``site_launches`` splits the packed form's launches by the call site that
asked for them ("weak_centre" and "weak_anchor": the deformable NCC's
centre and anchor windows in ``testing/weak_composition.py``). No main
path launches K1: the strong NCC samples inside K2, K3 and K5, the
deformable NCC inside K6 (ops/cuda/weak.py), each repeating K1's sample
bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...core.sampling import lerp_quad_rows, pack_bilinear, quad_coords
from . import build as _build

launches = 0      # kernel launches since the last reset (plain runs excluded)
site_launches: dict = {}   # packed-form launches by call site, same rule

_SOURCES = ("sampler.cu",)


def reset_launches() -> None:
    global launches
    launches = 0
    site_launches.clear()


@functools.lru_cache(maxsize=None)
def library() -> _build.Built:
    """Build (once per source hash) and load the kernel library, with every
    entry point's ctypes signature declared."""
    built = _build.build("apde_sampler", _SOURCES)
    lib = built.lib
    ptr = ctypes.c_void_p
    i64 = ctypes.c_int64
    i32 = ctypes.c_int
    for fn in (lib.apde_sample_packed_u8, lib.apde_sample_packed_f32):
        fn.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i32, i32, ptr]
        fn.restype = i32
    lib.apde_sample_image_f32.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32,
                                          ptr]
    lib.apde_sample_image_f32.restype = i32
    lib.apde_sample_empty.argtypes = [i64, ptr]
    lib.apde_sample_empty.restype = i32
    return built


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def sample_packed_plain(quads: torch.Tensor, width: int, height: int, x, y):
    """quad_coords + lerp_quad_rows over S tables at once."""
    s = quads.shape[0]
    idx, fx, fy = quad_coords(width, height, x, y)
    view = torch.arange(s, device=quads.device).reshape(
        (s,) + (1,) * (idx.ndim - 1))
    return lerp_quad_rows(quads[view, idx], fx, fy)


def sample_blocks_plain(img: torch.Tensor, xs, ys):
    """Bilinear sample of a (H, W) image, edge-clamped (the JAX package's
    ``bilinear_sample``): the packed form on the image's own quad table."""
    h, w = img.shape
    return sample_packed_plain(pack_bilinear(img)[None], w, h, xs[None],
                               ys[None])[0]


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _check_cuda(t: torch.Tensor, name: str, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def sample_packed(quads: torch.Tensor, width: int, height: int, x, y,
                  site: str = "other"):
    """Bilinear sample of S quad tables at (S, ...) coordinates; ``site``
    names the caller in ``site_launches``."""
    if quads.ndim != 3 or quads.shape[-1] != 4 \
            or quads.shape[1] != width * height:
        raise ValueError(f"quads must be (S, {height}*{width}, 4), got "
                         f"{tuple(quads.shape)}")
    if x.shape != y.shape or x.shape[:1] != quads.shape[:1]:
        raise ValueError(f"coordinates {tuple(x.shape)} / {tuple(y.shape)} "
                         f"do not match {quads.shape[0]} tables")
    if quads.device.type == "cpu":
        return sample_packed_plain(quads, width, height, x, y)
    if quads.device.type != "cuda":
        raise ValueError(f"unsupported device {quads.device}")
    if quads.dtype == torch.uint8:
        fn_name = "apde_sample_packed_u8"
    elif quads.dtype == torch.float32:
        fn_name = "apde_sample_packed_f32"
        if quads.data_ptr() % 16:
            raise ValueError("f32 quad table must be 16-byte aligned")
    else:
        raise TypeError(f"quad table dtype {quads.dtype} (u8 or f32)")
    _check_cuda(quads, "quads", quads.dtype, quads.device)
    _check_cuda(x, "x", torch.float32, quads.device)
    _check_cuda(y, "y", torch.float32, quads.device)
    out = torch.empty_like(x)
    total = x.numel()
    per_view = max(total // quads.shape[0], 1)
    fn = getattr(library().lib, fn_name)
    global launches
    launches += 1
    site_launches[site] = site_launches.get(site, 0) + 1
    _raise_on(fn(quads.data_ptr(), x.data_ptr(), y.data_ptr(),
                 out.data_ptr(), per_view, total, width, height,
                 torch.cuda.current_stream(quads.device).cuda_stream),
              fn_name)
    return out


def sample_blocks(img: torch.Tensor, xs, ys):
    """Bilinear sample of one (H, W) f32 image, coordinates of any shape."""
    if img.ndim != 2 or xs.shape != ys.shape:
        raise ValueError("sample_blocks takes an (H, W) image and equal-shape "
                         "coordinates")
    if img.device.type == "cpu":
        return sample_blocks_plain(img, xs, ys)
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    _check_cuda(img, "img", torch.float32, img.device)
    _check_cuda(xs, "xs", torch.float32, img.device)
    _check_cuda(ys, "ys", torch.float32, img.device)
    h, w = img.shape
    out = torch.empty_like(xs)
    lib = library().lib
    global launches
    launches += 1
    _raise_on(lib.apde_sample_image_f32(
        img.data_ptr(), xs.data_ptr(), ys.data_ptr(), out.data_ptr(),
        xs.numel(), w, h,
        torch.cuda.current_stream(img.device).cuda_stream),
        "apde_sample_image_f32")
    return out


def launch_empty(total: int, device) -> None:
    """One launch of an empty kernel on K1's grid for ``total`` samples:
    the fixed cost under K1's time at that size. Not counted in
    ``launches``."""
    _raise_on(library().lib.apde_sample_empty(
        total, torch.cuda.current_stream(device).cuda_stream),
        "apde_sample_empty")
