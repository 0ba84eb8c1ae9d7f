"""MVSNet camera / pair file codecs.

``_cam.txt`` format (reference reader: APD.cpp:85-135; writer:
tools/colmap2mvsnet.py:489-503):

    extrinsic
    r00 r01 r02 t0
    r10 r11 r12 t1
    r20 r21 r22 t2
    0 0 0 1

    intrinsic
    k00 k01 k02
    k10 k11 k12
    k20 k21 k22

    depth_min interval [depth_num depth_max]

If depth_num/depth_max are missing: depth_num=192,
depth_max = interval * depth_num + depth_min (reference: APD.cpp:121-124).

``pair.txt`` format (reference: main.cpp:44-102):
    num_images
    <ref_id>
    <num_src> id0 score0 id1 score1 ...
Neighbors with score <= 0 are dropped at load time.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Tuple, Union

import numpy as np


@dataclasses.dataclass
class Camera:
    """Pinhole camera (reference struct: main.h:50-61).

    R, t are world->camera; ``c = -R^T t`` is the camera center in world
    coordinates (computed on load, APD.cpp:113-119).
    """

    K: np.ndarray            # (3, 3) float64
    R: np.ndarray            # (3, 3)
    t: np.ndarray            # (3,)
    depth_min: float = 0.0
    interval: float = 0.0
    depth_num: float = 192.0
    depth_max: float = 0.0
    width: int = 0
    height: int = 0

    @property
    def c(self) -> np.ndarray:
        return -self.R.T @ self.t

    def scaled(self, scale_x: float, scale_y: float,
               width: int, height: int) -> "Camera":
        """Return a copy with intrinsics rescaled (reference: APD.cpp:580-585)."""
        K = self.K.copy()
        K[0, 0] *= scale_x
        K[0, 2] *= scale_x
        K[1, 1] *= scale_y
        K[1, 2] *= scale_y
        return dataclasses.replace(self, K=K, width=width, height=height)


def read_camera(path: Union[str, Path]) -> Camera:
    tokens: List[str] = []
    with open(path, "r") as f:
        tokens = f.read().split()
    it = iter(tokens)
    word = next(it)
    if word != "extrinsic":
        raise ValueError(f"expected 'extrinsic' header in {path}, got {word!r}")
    R = np.zeros((3, 3))
    t = np.zeros(3)
    for i in range(3):
        R[i, 0], R[i, 1], R[i, 2], t[i] = (float(next(it)) for _ in range(4))
    for _ in range(4):  # fourth homogeneous row, ignored
        next(it)
    word = next(it)
    if word != "intrinsic":
        raise ValueError(f"expected 'intrinsic' header in {path}, got {word!r}")
    K = np.array([[float(next(it)) for _ in range(3)] for _ in range(3)])
    depth_min = float(next(it))
    interval = float(next(it))
    try:
        depth_num = float(next(it))
        depth_max = float(next(it))
    except StopIteration:
        depth_num = 192.0
        depth_max = interval * depth_num + depth_min
    return Camera(K=K, R=R, t=t, depth_min=depth_min, interval=interval,
                  depth_num=depth_num, depth_max=depth_max)


def write_camera(path: Union[str, Path], cam: Camera) -> None:
    with open(path, "w") as f:
        f.write("extrinsic\n")
        for i in range(3):
            f.write(f"{cam.R[i, 0]} {cam.R[i, 1]} {cam.R[i, 2]} {cam.t[i]} \n")
        f.write("0.0 0.0 0.0 1.0 \n")
        f.write("\nintrinsic\n")
        for i in range(3):
            f.write(f"{cam.K[i, 0]} {cam.K[i, 1]} {cam.K[i, 2]} \n")
        f.write(f"\n{cam.depth_min} {cam.interval} {cam.depth_num} {cam.depth_max}\n")


def write_pair(path: Union[str, Path],
               entries: List[Tuple[int, List[Tuple[int, float]]]]) -> None:
    """Write pair.txt; entries are (ref_id, [(src_id, score), ...])."""
    with open(path, "w") as f:
        f.write(f"{len(entries)}\n")
        for ref_id, neighbors in entries:
            f.write(f"{ref_id}\n{len(neighbors)} ")
            for sid, score in neighbors:
                f.write(f"{sid} {score:g} ")
            f.write("\n")
