"""Build and load the package's CUDA sources as plain-C shared libraries.

Each library is compiled by ``nvcc`` for ``sm_90a`` (Hopper) into
``build/kernels/`` at the repository root, on first use, under a name keyed
by a hash of its sources, the headers under ``csrc/`` (``*.cuh``, which the
sources include and nvcc is not given) and the flags, and loaded with
``ctypes``. Nothing here runs at import time: the CPU-only test environment
has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple, Tuple

from ...core import spans

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Built(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    seconds: float      # compile time; 0.0 when an up-to-date build existed
    log: str            # nvcc output (ptxas register / spill report)


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built on the machine with the "
                       "card")


def source_hash(sources: Tuple[str, ...]) -> str:
    """Hash of the flags, ``sources`` (file names under csrc/) and every
    header under csrc/: an edited header rebuilds each library."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / s for s in sources] + sorted(CSRC.glob("*.cuh")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    return digest.hexdigest()[:16]


def build(name: str, sources: Tuple[str, ...]) -> Built:
    """Compile ``sources`` (file names under csrc/) into lib<name>-<hash>.so
    unless that file exists, then load it."""
    with spans.span(spans.BUILD):
        paths = [CSRC / s for s in sources]
        out = BUILD_DIR / f"lib{name}-{source_hash(sources)}.so"
        seconds, log = 0.0, ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *map(str, paths)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) "
                                   f"building {name}:\n{log}")
            os.replace(tmp, out)
            out.with_suffix(".log").write_text(log)
        elif out.with_suffix(".log").exists():
            log = out.with_suffix(".log").read_text()
        return Built(ctypes.CDLL(str(out)), out, seconds, log)
