"""K11 — the initial cost's top-k view selection: CUDA kernel, its plain
PyTorch version, and the wrapper that picks between them by the tensors'
device.

Replaces the view selection the JAX package leaves to XLA
(``apde_mvs_tpu/ops/cost.py:430`` ``initial_cost_and_selection``) and the
state update after it (``apde_mvs_tpu/ops/init.py:85-90``): for each pixel
of the image, k = min(#{cost < COST_MAX}, top_k), the mean of its k
smallest costs (COST_MAX where k = 0) and the views whose cost is <= the
k-th smallest; the state's cost map takes the mean where the pixel is
valid, else 1e9, its selections the views where it is valid. The port ran
it as a ``torch.sort`` of the (H W, S) costs and about a dozen torch ops.

The per-pixel code is ``csrc/select_common.cuh``'s, which K2's stage form
and K6's re-score form run in the epilogues of the launches that make the
costs on the serial and view-parallel routes (``ncc.init_stage_select_fused``,
``weak.rescore_select_fused``): K11's own launch (``csrc/select.cu``) runs
only on the tile route, a thread a pixel over the (H W, S) costs it gathers
(or an (S, H W) view-major block), and writes only the new maps, a block's
selections as 16-byte words. What bounds it on the H100: bytes (the costs
read once, the maps written once).

The plain version is ``cost.initial_cost_and_selection``, whose top-k sum
is taken in ascending order from +0 and whose mean is a true division, then
the two ``where``s of the state update (``select_rows_plain`` on a range of
pixels, ``select_plain`` on the image); the kernels compute the same, so
they agree bit for bit on the card.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises — there is no fallback. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..cost import initial_cost_and_selection
from . import build as _build
from . import ncc

launches = 0      # kernel launches since the last reset (plain runs excluded)

MAX_VIEWS = ncc.MAX_VIEWS
INVALID_COST = 1e9   # an invalid pixel's cost
_SOURCES = ("select.cu",)


def reset_launches() -> None:
    global launches
    launches = 0


@functools.lru_cache(maxsize=None)
def library() -> _build.Built:
    """Build (once per source hash) and load the kernel library, with its
    entry points' ctypes signatures declared."""
    built = _build.build("apde_select", _SOURCES)
    lib = built.lib
    ptr = ctypes.c_void_p
    i32 = ctypes.c_int
    i64 = ctypes.c_int64
    lib.apde_select.argtypes = [ptr, i64, i64, ptr, ptr, ptr, i64, i32, i32,
                                ptr]
    lib.apde_select.restype = i32
    lib.apde_select_max_views.argtypes = []
    lib.apde_select_max_views.restype = i32
    lib.apde_select_kernel_info.argtypes = [i32] + [ptr] * 3
    lib.apde_select_kernel_info.restype = i32
    if lib.apde_select_max_views() != MAX_VIEWS:
        raise RuntimeError(f"csrc/select.cu takes "
                           f"{lib.apde_select_max_views()} views, the "
                           f"wrapper assumes {MAX_VIEWS}")
    return built


def kernel_info(num_views: int) -> dict:
    """The instantiation's registers, local memory (spill) bytes and
    resident blocks an SM at ``num_views`` views, from the CUDA runtime."""
    return ncc.read_kernel_info(library().lib.apde_select_kernel_info,
                                num_views)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def select_rows_plain(costs: torch.Tensor, valid: torch.Tensor, top_k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The state's (n,) costs and (n, S) selections of n pixels from their
    (n, S) costs and (n,) validity."""
    mean, selected = initial_cost_and_selection(costs, top_k)
    return (torch.where(valid, mean, INVALID_COST),
            selected & valid[:, None])


def select_plain(costs: torch.Tensor, valid: torch.Tensor, top_k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The state's (H, W) cost map and (H, W, S) selections from the
    (H W, S) costs of the pixels and the (H, W) validity map."""
    h, w = valid.shape
    cost, selected = select_rows_plain(costs, valid.reshape(-1), top_k)
    return cost.reshape(h, w), selected.reshape(h, w, -1)


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------

def select_fused(costs: torch.Tensor, view_major: bool, valid: torch.Tensor,
                 top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-k view selection of every pixel of an (H, W) image from its
    costs, an (S, H W) view-major or (H W, S) pixel-major float32 block:
    the state's new (H, W) cost map (the mean of the k smallest where
    ``valid``, else 1e9) and (H, W, S) selections, fresh tensors. One launch
    on CUDA tensors, the plain version on CPU tensors."""
    if valid.ndim != 2 or valid.dtype != torch.bool:
        raise ValueError(f"valid must be an (H, W) bool map, got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    h, w = valid.shape
    s = costs.shape[0] if view_major else costs.shape[-1]
    if not 1 <= s <= MAX_VIEWS:
        raise ValueError(f"{s} views; the selection kernel takes 1 .. "
                         f"{MAX_VIEWS}")
    if top_k < 0:
        raise ValueError(f"top_k {top_k} < 0")
    dev = costs.device
    vs, ps = ncc.check_block(costs, s, view_major, h * w, dev)
    if costs.shape[1 if view_major else 0] != h * w:
        raise ValueError(f"costs {tuple(costs.shape)} for an {h}x{w} image")
    if valid.device != dev:
        raise ValueError(f"valid is on {valid.device}, the costs on {dev}")
    if not valid.is_contiguous():
        raise ValueError("valid must be contiguous")
    if dev.type == "cpu":
        return select_plain(costs.T if view_major else costs, valid, top_k)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = library().lib
    cost_map = torch.empty((h, w), dtype=torch.float32, device=dev)
    selected = torch.empty((h, w, s), dtype=torch.bool, device=dev)
    if h * w == 0:
        return cost_map, selected
    global launches
    launches += 1
    ncc._raise_on(lib.apde_select(
        costs.data_ptr(), vs, ps, valid.data_ptr(), cost_map.data_ptr(),
        selected.data_ptr(), h * w, s, int(top_k),
        torch.cuda.current_stream(dev).cuda_stream), "apde_select")
    return cost_map, selected
