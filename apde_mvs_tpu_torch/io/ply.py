"""Binary little-endian PLY point-cloud export/import.

Writer matches the reference's output (APD.cpp:316-356): xyz float32 plus
optional uchar blue/green/red properties.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np


def export_point_cloud(path: Union[str, Path], coords: np.ndarray,
                       colors_bgr: Optional[np.ndarray] = None) -> None:
    """Write points (N, 3) float32 and optional colors (N, 3) uint8 (BGR)."""
    coords = np.ascontiguousarray(coords, dtype=np.float32)
    n = coords.shape[0]
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if colors_bgr is not None:
        header += ["property uchar blue", "property uchar green", "property uchar red"]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if colors_bgr is None:
            f.write(coords.tobytes())
        else:
            colors_bgr = np.ascontiguousarray(colors_bgr, dtype=np.uint8)
            rec = np.zeros(n, dtype=[("xyz", np.float32, 3), ("bgr", np.uint8, 3)])
            rec["xyz"] = coords
            rec["bgr"] = colors_bgr
            f.write(rec.tobytes())


def read_ply(path: Union[str, Path]) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read a binary little-endian PLY written by this module (or the
    reference binary). Returns (coords (N,3) f32, colors (N,3) u8 or None)."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").splitlines()
    if "format binary_little_endian 1.0" not in header:
        raise ValueError("only binary_little_endian PLY supported")
    n = 0
    props = []
    for line in header:
        if line.startswith("element vertex"):
            n = int(line.split()[-1])
        elif line.startswith("property"):
            props.append(tuple(line.split()[1:]))
    has_color = any(p[0] == "uchar" for p in props)
    if has_color:
        rec = np.frombuffer(data[end:], dtype=[("xyz", np.float32, 3),
                                               ("bgr", np.uint8, 3)], count=n)
        return rec["xyz"].copy(), rec["bgr"].copy()
    coords = np.frombuffer(data[end:], dtype=np.float32, count=n * 3).reshape(n, 3)
    return coords.copy(), None
