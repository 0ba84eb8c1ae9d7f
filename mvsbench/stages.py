"""The traced window's idle time split by the stage the host was in.

The port opens a profiler range (a span, `apde_mvs_tpu_torch.core.spans`)
around each stage of a step while a profiler records, and counts the
pixels its passes work on (`pipeline.full_pass`'s pass counters). This
module splits the traced window's idle time, after `trace`'s cut of the
time in which the K3 count alone ran, by exact intersection with the
innermost span on the window's thread:

- the step's ends: idle inside `run_patchmatch.priors` or
  `run_patchmatch.outputs` (the uploads of the priors, the maps copied to
  the host and the anchors map);
- the pass's stages: idle inside `run_patchmatch` but outside its ends
  (the drains after the pass's synchronising reads, the host's time to
  refill the queue);
- outside: idle outside every `run_patchmatch` span (the harness's loop
  between steps).

It fails, as `trace` does for a lost launch, where the window's
`run_patchmatch` spans are not exactly its steps. The readers below are
the per-layer metrics `step.ends_idle_ms`, `pass.stages_idle_ms` and
`weak_path.ns_per_pixel`; the harness does not report them yet (PERF.md,
Open questions). One traced run of a cell with the split:

    python3 -m mvsbench.stages --workload dtu.r1_geom_weak --seed 1234 --seconds 51

prints what `mvsbench.run --trace 1` prints, an info line more with the
idle time a step by span, and the result line with a `stages` object.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import dataclasses
import json
import math
import sys
from pathlib import Path
from typing import Dict, Optional

import torch

from . import manifest, program, run, trace

try:
    from apde_mvs_tpu_torch.core import spans as port_spans
except ImportError:             # a program that opens no span
    port_spans = None

COUNTERS = ("weak_pixels", "reliable_pixels", "classified_pixels",
            "refined_pixels")
OUTSIDE = "outside run_patchmatch"


def pass_counts() -> dict:
    """The port's pass counters that it has (none before it had them)."""
    from apde_mvs_tpu_torch.pipeline import full_pass
    return {k: getattr(full_pass, k) for k in COUNTERS
            if hasattr(full_pass, k)}


@dataclasses.dataclass
class StageSplit:
    steps: int
    idle_s: float               # the window's idle time after the cut
    ends_idle_s: float
    stages_idle_s: float
    outside_idle_s: float
    idle_by_span: Dict[str, float]      # by innermost span, or OUTSIDE
    host_by_span: Dict[str, float]      # each span's own wall, summed
    counts: Dict[str, int]              # the pass counters' growth


def idle_after_cut(events: list) -> tuple:
    """(the window's thread, its idle intervals less those in which the
    K3 count alone ran): the gaps `trace.reduce_events` counts."""
    (w0, w1, tid), = trace._ranges(events, trace.WINDOW_RANGE)
    counting = trace._ranges(events, trace.COUNT_RANGE)
    starts = [c[0] for c in counting]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime"
                 and "correlation" in e.get("args", {})}
    busy, counted = [], [(a, b) for a, b, _ in counting]
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in trace.DEVICE_CATS \
                or not w0 <= e["ts"] <= w1:
            continue
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        i = bisect.bisect_right(starts, ts) - 1 if ts is not None else -1
        in_count = i >= 0 and counting[i][0] <= ts <= counting[i][1]
        (counted if in_count else busy).append((e["ts"], e["ts"] + e["dur"]))
    gaps, prev = [], w0
    for a, b in trace._union(busy):
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    return tid, trace._minus(gaps, trace._union(counted))


def _innermost(ranges: list) -> list:
    """Nested ranges (start, end, name) as sorted disjoint segments
    (start, end, the names open there, outermost first)."""
    segs, stack, t = [], [], 0.0
    last = [(math.inf, math.inf, None)]     # closes every range
    for a, b, name in sorted(ranges, key=lambda r: (r[0], -r[1])) + last:
        while stack and stack[-1][1] <= a:
            end = stack[-1][1]
            if end > t:
                segs.append((t, end, tuple(r[2] for r in stack)))
            stack.pop()
            t = max(t, end)
        if stack and a > t:
            segs.append((t, a, tuple(r[2] for r in stack)))
        stack.append((a, b, name))
        t = a
    return segs


def split_events(events: list, steps: int, counts: dict) -> \
        Optional[StageSplit]:
    """The window's idle time by span; None for a program that opens no
    span. Raises `trace.TraceError` where the window's `run_patchmatch`
    spans are not its ``steps``."""
    if port_spans is None:
        return None
    tid, gaps = idle_after_cut(events)
    (w0, w1, _), = trace._ranges(events, trace.WINDOW_RANGE)
    own = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"
           and e.get("tid") == tid and e.get("name") in port_spans.STEP
           and w0 <= e["ts"] <= w1]
    runs = sum(name == port_spans.RUN for _, _, name in own)
    if runs != steps:
        raise trace.TraceError(f"{runs} {port_spans.RUN} spans in the "
                               f"window, {steps} steps")
    host = collections.Counter()
    for a, b, name in own:
        host[name] += (b - a) * 1e-6
    by_span, by_part = collections.Counter(), collections.Counter()
    segs, j = _innermost(own), 0
    for a, b in gaps:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k, t = j, a
        while t < b:
            seg = segs[k] if k < len(segs) and segs[k][0] < b else None
            lo = b if seg is None else max(t, seg[0])
            if lo > t:          # no span open from t to lo
                by_span[OUTSIDE] += (lo - t) * 1e-6
                by_part["outside"] += (lo - t) * 1e-6
            if seg is None:
                break
            hi = min(b, seg[1])
            names = seg[2]
            part = "ends" if set(names) & {port_spans.PRIORS,
                                           port_spans.OUTPUTS} else \
                "stages" if port_spans.RUN in names else "outside"
            by_span[names[-1] if part != "outside" else OUTSIDE] += \
                (hi - lo) * 1e-6
            by_part[part] += (hi - lo) * 1e-6
            t = hi
            k += 1
    return StageSplit(
        steps=steps, idle_s=sum(b - a for a, b in gaps) * 1e-6,
        ends_idle_s=by_part["ends"], stages_idle_s=by_part["stages"],
        outside_idle_s=by_part["outside"], idle_by_span=dict(by_span),
        host_by_span=dict(host), counts=dict(counts))


# the per-layer metrics' readers: ms a step, or ns a weak pixel

def ends_idle_ms(split: Optional[StageSplit]) -> Optional[float]:
    """`step.ends_idle_ms`: device-idle time a step inside the step's
    ends."""
    if split is None or not split.steps:
        return None
    return 1e3 * split.ends_idle_s / split.steps


def stages_idle_ms(split: Optional[StageSplit]) -> Optional[float]:
    """`pass.stages_idle_ms`: device-idle time a step inside
    `run_patchmatch` but outside its ends."""
    if split is None or not split.steps:
        return None
    return 1e3 * split.stages_idle_s / split.steps


def weak_ns_per_pixel(rec: trace.Records,
                      split: Optional[StageSplit]) -> Optional[float]:
    """`weak_path.ns_per_pixel`: the weak path's kernels' device time over
    the weak pixels the window's passes listed."""
    pixels = 0 if split is None else split.counts.get("weak_pixels", 0)
    if not pixels:
        return None
    return 1e9 * rec.device_s(program.WEAK_PATH) / pixels


class StageTracer(trace.Tracer):
    """`trace.Tracer` that also keeps the pass counters' growth over the
    window and splits the window's idle time by span in `reduce`."""

    split: Optional[StageSplit] = None

    def __enter__(self):
        self.pass0 = pass_counts()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self.pass1 = pass_counts()
        return out

    def reduce(self, steps: int) -> trace.Records:
        self.prof.export_chrome_trace(str(self.path))
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        self.path.unlink()
        rec = trace.reduce_events(
            events, steps, self.syncs,
            {k: self.counts1[k] - self.counts0[k] for k in self.counts0},
            self.k3_seen,
            0.0 if self.k3_total is None else float(self.k3_total))
        self.split = split_events(
            events, steps, {k: self.pass1[k] - self.pass0[k]
                            for k in self.pass0})
        self.rec = rec
        return rec


def report(rec: trace.Records, split: Optional[StageSplit]) -> tuple:
    """(the `stages` object of the result line, the info line)."""
    if split is None:
        return {}, "stages: the program opens no span"
    per = 1e3 / split.steps
    top = sorted(split.idle_by_span.items(), key=lambda kv: -kv[1])
    spans_ms = [[n, s * per] for n, s in top if n != OUTSIDE][:8]
    out = {"step.ends_idle_ms": ends_idle_ms(split),
           "pass.stages_idle_ms": stages_idle_ms(split),
           "weak_path.ns_per_pixel": weak_ns_per_pixel(rec, split),
           "outside_idle_ms": split.outside_idle_s * per,
           "idle_ms": split.idle_s * per,
           "idle_ms_by_span": spans_ms,
           "host_ms_by_span": sorted(
               ([n, s * per] for n, s in split.host_by_span.items()),
               key=lambda kv: -kv[1]),
           "counts_a_step": {k: v / split.steps
                             for k, v in split.counts.items()}}
    line = ("idle ms a step by span (top 8): " + ", ".join(
        f"{n} {ms:.3f}" for n, ms in spans_ms)
        + f"; {OUTSIDE} {out['outside_idle_ms']:.3f}; ends "
        f"{out['step.ends_idle_ms']:.3f} + stages "
        f"{out['pass.stages_idle_ms']:.3f} + outside "
        f"{out['outside_idle_ms']:.3f} of {out['idle_ms']:.3f} idle")
    return out, line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--benchmark", type=Path, default=manifest.MANIFEST)
    args = ap.parse_args(argv)
    cell = manifest.cell(args.benchmark, args.workload)
    if not torch.cuda.is_available():
        print("mvsbench.stages: needs a CUDA card: no result",
              file=sys.stderr)
        return 2
    made = []

    def tracer(trace_dir):
        made.append(StageTracer(trace_dir))
        return made[-1]

    inner, trace.Tracer = trace.Tracer, tracer
    try:
        result, info = run.run_cell(cell, args.seed, args.seconds, True,
                                    torch.device("cuda", 0))
    finally:
        trace.Tracer = inner
    result["stages"], line = report(made[0].rec, made[0].split)
    info.append(line)
    run.emit(result, info)
    return 0


if __name__ == "__main__":
    sys.exit(main())
