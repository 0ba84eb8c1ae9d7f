"""PFM (portable float map) reader/writer (reference reader: APD.cpp:912-960)."""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np


def read_pfm(path: Union[str, Path]) -> np.ndarray:
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic == b"Pf":
            channels = 1
        elif magic == b"PF":
            channels = 3
        else:
            raise ValueError(f"invalid pfm magic in {path}: {magic!r}")
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        width, height = (int(v) for v in line.split())
        scale = float(f.readline().strip())
        count = width * height * channels
        dtype = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(count * 4), dtype=dtype, count=count)
    img = data.reshape((height, width) if channels == 1 else (height, width, channels))
    img = img.astype(np.float32)
    if scale < 0:  # negative scale => little-endian, rows bottom-up
        img = img[::-1].copy()
    return img


def write_pfm(path: Union[str, Path], img: np.ndarray, scale: float = -1.0) -> None:
    img = np.asarray(img, dtype=np.float32)
    channels = 1 if img.ndim == 2 else img.shape[2]
    with open(path, "wb") as f:
        f.write(b"Pf\n" if channels == 1 else b"PF\n")
        f.write(f"{img.shape[1]} {img.shape[0]}\n".encode())
        f.write(f"{scale}\n".encode())
        data = img[::-1] if scale < 0 else img
        f.write(np.ascontiguousarray(data, dtype="<f4" if scale < 0 else ">f4").tobytes())
