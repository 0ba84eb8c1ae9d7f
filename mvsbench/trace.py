"""The traced run's records and their reduction.

`Tracer` wraps the measured window: the profiler (CPU and CUDA activities,
the chrome trace written under the run's `TMPDIR` and read back), the
synchronising calls (`torch.cuda.set_sync_debug_mode`, counted by the
warnings they raise), the port's launch counters before and after, and a
wrapper on K3's launch that counts each launch's least time
(`k3_count.bound_seconds`) on the device inside a profiler range of its
own. The counting is the benchmark's, not the pass's: its kernels count
for no metric, and the time in which it alone ran (its host range or its
kernels, with no kernel of the pass on the device) is cut out of the
window, so that it adds nothing to the idle share or the idle gaps.
`reduce` turns what it saw into `Records`, and fails where the profiler
lost a launch: every hand kernel's launches in the trace must equal the
port's counter, and every K3 launch the wrapper saw must have its device
record.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import json
import re
import warnings
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from . import k3_count, program

COUNT_RANGE = "mvsbench.k3_count"
WINDOW_RANGE = "mvsbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class TraceError(RuntimeError):
    """The trace disagrees with the program's own counts."""


@dataclasses.dataclass
class Records:
    steps: int
    window_s: float             # the window less `counting_s`
    busy_s: float
    syncs: int
    kernels: List[Tuple[str, str, float]]   # (kernel id or "", name, s)
    k3_bound_s: float
    device_ops: List[list]
    idle_gaps: List[list]
    counting_s: float = 0.0     # cut out: the counting alone ran

    def device_s(self, ids) -> float:
        return sum(s for k, _, s in self.kernels if k in ids)

    def torch_s(self) -> float:
        return sum(s for k, _, s in self.kernels if not k)


def _kernel_patterns() -> Dict[str, re.Pattern]:
    return {k: re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(names)
                          + r")(?![A-Za-z0-9_])")
            for k, (_, names) in program.KERNELS.items()}


def kernel_id(name: str, patterns) -> str:
    for k, pat in patterns.items():
        if pat.search(name):
            return k
    return ""


class Tracer:
    """Everything the traced window records; use as a context manager
    around the window, then `reduce`."""

    def __init__(self, trace_dir: Path):
        self.path = Path(trace_dir) / "window.pt.trace.json"
        self.syncs = 0
        self.k3_seen = 0
        self.k3_total = None
        self._stack = contextlib.ExitStack()

    def _on_warning(self, message, *args, **kwargs):
        if "synchroniz" in str(message):
            self.syncs += 1

    def _wrap_k3(self):
        from apde_mvs_tpu_torch.ops.cuda import strong
        inner = strong.strong_fused

        def counted(data, state, x, y, draws, **kw):
            out = inner(data, state, x, y, draws, **kw)
            if x.numel() and data.src_quads.device.type == "cuda":
                with torch.profiler.record_function(COUNT_RANGE):
                    commit = bool(kw.get("commit"))
                    vw = out.view_weights[y.long(), x.long()] if commit \
                        else out.view_weights
                    b = k3_count.bound_seconds(data, x, y, kw, vw, commit)
                    self.k3_total = b if self.k3_total is None \
                        else self.k3_total + b
                self.k3_seen += 1
            return out

        strong.strong_fused = counted
        self._stack.callback(setattr, strong, "strong_fused", inner)

    def __enter__(self):
        self.counts0 = program.launch_counts()
        self._wrap_k3()
        torch.cuda.synchronize()
        self.prof = self._stack.enter_context(torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]))
        self._stack.enter_context(warnings.catch_warnings())
        warnings.simplefilter("always")
        warnings.showwarning = self._on_warning
        self.window = torch.profiler.record_function(WINDOW_RANGE)
        self.window.__enter__()
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)
        self.window.__exit__(None, None, None)
        torch.cuda.synchronize()
        self._stack.close()
        self.counts1 = program.launch_counts()
        return False

    def reduce(self, steps: int) -> Records:
        self.prof.export_chrome_trace(str(self.path))
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        self.path.unlink()
        return reduce_events(events, steps, self.syncs,
                             {k: self.counts1[k] - self.counts0[k]
                              for k in self.counts0},
                             self.k3_seen,
                             0.0 if self.k3_total is None
                             else float(self.k3_total))


def _ranges(events, name):
    """The host ranges of ``name`` (the profiler also shows each on the
    device's timeline, as a "gpu_user_annotation")."""
    return sorted((e["ts"], e["ts"] + e["dur"], e.get("tid"))
                  for e in events if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"
                  and e.get("name") == name)


def reduce_events(events: list, steps: int, syncs: int, launched: dict,
                  k3_seen: int, k3_bound_s: float) -> Records:
    """The window's records from the chrome trace's events; raises
    `TraceError` where the trace lost a launch."""
    window = _ranges(events, WINDOW_RANGE)
    if len(window) != 1:
        raise TraceError(f"{len(window)} window ranges in the trace")
    w0, w1, main_tid = window[0]
    counting = _ranges(events, COUNT_RANGE)
    starts = [c[0] for c in counting]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime" and "args" in e
                 and "correlation" in e["args"]}

    def in_count_range(corr) -> bool:
        ts = launch_ts.get(corr)
        if ts is None or not starts:
            return False
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and counting[i][0] <= ts <= counting[i][1]

    patterns = _kernel_patterns()
    kernels, busy = [], []
    counted = [(a, b) for a, b, _ in counting]
    found = collections.Counter()
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        if not w0 <= e["ts"] <= w1:
            continue
        if in_count_range(e.get("args", {}).get("correlation")):
            counted.append((e["ts"], e["ts"] + e["dur"]))
            continue
        busy.append((e["ts"], e["ts"] + e["dur"]))
        if e["cat"] != "kernel":
            continue
        kid = kernel_id(e["name"], patterns)
        found[kid] += 1
        kernels.append((kid, e["name"], e["dur"] * 1e-6))
    for k, n in launched.items():
        if found.get(k, 0) != n:
            raise TraceError(f"the trace holds {found.get(k, 0)} launches of "
                             f"{k}, its counter {n}")
    if found.get("K3", 0) != k3_seen:
        raise TraceError(f"{k3_seen} K3 launches counted, "
                         f"{found.get('K3', 0)} device records")
    merged = _union(busy)
    busy_s = sum(b - a for a, b in merged) * 1e-6
    gaps, prev = [], w0
    for a, b in merged:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    idle = sum(b - a for a, b in gaps)
    gaps = _minus(gaps, _union(counted))
    counting_s = (idle - sum(b - a for a, b in gaps)) * 1e-6
    by_op = collections.Counter()
    for (a, b), name in zip(gaps, _host_ops(events, main_tid,
                                            [(a + b) / 2 for a, b in gaps])):
        by_op[name] += (b - a) * 1e-6
    ops = collections.Counter()
    for kid, name, s in kernels:
        ops[(f"{kid} " if kid else "") + name[:120]] += s
    return Records(
        steps=steps, window_s=(w1 - w0) * 1e-6 - counting_s, busy_s=busy_s,
        syncs=syncs, kernels=kernels, k3_bound_s=k3_bound_s,
        device_ops=[[n, s] for n, s in ops.most_common(10)],
        idle_gaps=[[n, s] for n, s in by_op.most_common(10)],
        counting_s=counting_s)


def _union(spans) -> list:
    """The union of intervals (a, b), as sorted disjoint [a, b]."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _minus(spans, cut) -> list:
    """The sorted disjoint intervals ``spans`` less the sorted disjoint
    intervals ``cut``."""
    out, j = [], 0
    for a, b in spans:
        while j < len(cut) and cut[j][1] <= a:
            j += 1
        k = j
        while k < len(cut) and cut[k][0] < b:
            if cut[k][0] > a:
                out.append((a, cut[k][0]))
            a = max(a, cut[k][1])
            k += 1
        if a < b:
            out.append((a, b))
    return out


def _host_ops(events, tid, times):
    """The innermost host range (an op or a profiler range) on thread
    ``tid`` running at each of ``times`` (ascending), or "host (no op)"."""
    spans = sorted(
        ((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
         if e.get("ph") == "X" and e.get("tid") == tid
         and e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime")
         and e.get("name") != WINDOW_RANGE),
        key=lambda s: (s[0], -s[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else "host (no op)")
    return out
