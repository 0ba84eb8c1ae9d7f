"""Binary mat codec — the cross-language checkpoint ABI of the pipeline.

Format (reference: APD.cpp:58-83, tools/run_SAM.py:11-40):
    int32 version (=1), int32 rows, int32 cols, int32 cv_type,
    then `step * rows` raw bytes (row-major, tightly packed).

The cv_type is the OpenCV type code: depth + ((channels - 1) << 3) where
depth is 0=u8, 1=s8, 2=u16, 3=s16, 4=s32, 5=f32, 6=f64. Every artifact the
pipeline exchanges (depths/normals/weak/confidence/sa-mask/anchors_map) uses
this codec, so it is kept bit-compatible with the reference.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Optional, Union

import numpy as np

_DEPTH_TO_DTYPE = {
    0: np.uint8, 1: np.int8, 2: np.uint16, 3: np.int16,
    4: np.int32, 5: np.float32, 6: np.float64,
}
_DTYPE_TO_DEPTH = {np.dtype(v): k for k, v in _DEPTH_TO_DTYPE.items()}

_HEADER = struct.Struct("<iiii")
VERSION = 1


def cv_type(dtype, channels: int) -> int:
    depth = _DTYPE_TO_DEPTH[np.dtype(dtype)]
    return depth + ((channels - 1) << 3)


def write_bin_mat(path: Union[str, Path], mat: np.ndarray,
                  cache: Optional["MemoryCache"] = None, flush: bool = True) -> None:
    """Write an array as a bin-mat. (H, W) or (H, W, C) arrays accepted."""
    mat = np.ascontiguousarray(mat)
    if mat.ndim == 2:
        channels = 1
    elif mat.ndim == 3:
        channels = mat.shape[2]
    else:
        raise ValueError(f"bin mat must be 2-D or 3-D, got shape {mat.shape}")
    code = cv_type(mat.dtype, channels)
    if cache is not None:
        cache.mat_cache[str(path)] = mat
        if not flush:
            return
    with open(path, "wb") as f:
        f.write(_HEADER.pack(VERSION, mat.shape[0], mat.shape[1], code))
        f.write(mat.tobytes())


