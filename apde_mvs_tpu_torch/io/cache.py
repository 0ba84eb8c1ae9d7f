"""In-process artifact cache (reference: MemoryCache, APD.h:192-201, APD.cpp:3-16).

A write-back cache over the bin-mat/camera/image file contract: iterations of
the multi-scale loop exchange their state through this cache instead of disk
when enabled; `flush()` writes pending mats out (reference: main.cpp:381-393).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional


class MemoryCache:
    _instance: Optional["MemoryCache"] = None
    _lock = threading.Lock()

    def __init__(self) -> None:
        self.img_cache: Dict[str, "np.ndarray"] = {}
        self.mat_cache: Dict[str, "np.ndarray"] = {}
        self.cam_cache: Dict[str, "Camera"] = {}

    @classmethod
    def get_instance(cls) -> "MemoryCache":
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    cls._instance = MemoryCache()
        return cls._instance

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._instance = None

    def flush(self) -> None:
        from .binmat import write_bin_mat
        for path, mat in self.mat_cache.items():
            write_bin_mat(path, mat, cache=None)

    def clear(self) -> None:
        self.img_cache.clear()
        self.mat_cache.clear()
        self.cam_cache.clear()
