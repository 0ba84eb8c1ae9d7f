"""Device binding: the engine's computations run on one explicit
``torch.device``; a CUDA device is never silently replaced by the CPU."""

from __future__ import annotations

import contextlib
import os
import subprocess
from pathlib import Path

import torch


def bind_device(index: int = 0, kind: str = "cuda") -> torch.device:
    """The device this engine process computes on (reference mechanism:
    cudaSetDevice(gpu_index), main.cpp:264).

    ``kind="cuda"`` binds local card ``index`` (wrapping modulo the card
    count, like the JAX engine's slot arithmetic) and makes it current; it
    raises when no card is visible, so a run asked to use the card cannot
    carry on on the CPU. ``kind="cpu"`` is the explicit CPU choice (tests,
    debugging)."""
    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"unknown device kind {kind!r} (cuda or cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but torch sees none "
                           "(pass --device cpu to run on the CPU)")
    device = torch.device("cuda", index % torch.cuda.device_count())
    torch.cuda.set_device(device)
    return device


def card_line() -> str:
    """The first card's name and power limit as ``nvidia-smi`` gives them
    (``NVIDIA H100 80GB HBM3, 700.00 W``): written beside every device
    number, since a card set below its maximum power runs slower."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def profile_trace(out_dir, device="cuda"):
    """Context manager: a torch.profiler trace of the enclosed work, CPU
    activities plus, on a CUDA ``device``, the card's kernels and copies,
    written as a Chrome / Perfetto trace (``apd_<pid>.pt.trace.json``) into
    ``out_dir`` (reference: wall-clock-only tracing, main.cpp:151-161; view
    the file in ui.perfetto.dev or chrome://tracing). Yields the path the
    trace is written to on exit."""
    from torch.profiler import ProfilerActivity, profile

    path = Path(os.path.expanduser(str(out_dir)))
    path.mkdir(parents=True, exist_ok=True)
    trace = path / f"apd_{os.getpid()}.pt.trace.json"
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield trace
    prof.export_chrome_trace(str(trace))
    print(f"profiler trace -> {trace}", flush=True)
