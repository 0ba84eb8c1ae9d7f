"""Run one cell of the benchmark once.

    python3 -m mvsbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the repository's root. One process: it renders the cell's scan from
the seed on the card, writes the scan folder into `TMPDIR`, loads every
view through the program's own loader, warms the cell's pass up on every
view once (each view's weak list has a size of its own; the first run in a
checkout builds the kernels into `build/kernels/` there), then replays the pass over the scan's views in order, cycle after
cycle, for ``--seconds``: each step is one view's `run_patchmatch`, ending
in its copies to the host, with a fresh pass seed each cycle and nothing
fed back. Then it compares a sample of the steps, drawn from the seed,
with the plain reference (`mvsbench.reference`) and prints the numbers
compared beside their limits as its last lines on standard error, and one
JSON line last on standard output. ``--trace 1`` measures the same window
under the profiler and reports the per-layer metrics instead of the
end-to-end ones. Without a card, or with fewer cards than the cell asks
for, it exits with 2 and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import judge, manifest  # noqa: E402

# top-level module names the run must not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "apde_mvs_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def scan_dir(cell_name: str) -> Path:
    """The scan folder: a fixed path under the run's `TMPDIR`."""
    return Path(tempfile.gettempdir()) / "mvsbench" / cell_name


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float = T0) -> tuple:
    """One run of ``cell``; returns (the result line's object, the lines
    compared for standard error)."""
    from . import program, scan, scene
    from .reference import pass_ref

    cfg, traffic = cell.config, cell.traffic
    root = scan_dir(cell.name)
    shutil.rmtree(root, ignore_errors=True)
    sc = scene.make_scene(cfg, float(traffic["weak_share"]), seed, device)
    raw = scan.write_scan(root, sc, traffic, seed, int(cfg["sources"]))
    gt_shape = tuple(sc.depths.shape)
    del sc
    written = scan.bytes_written(raw)
    spec = program.schedule_pass(cfg, traffic)
    prog = program.Program.load(raw, spec, device)
    views = len(prog.views)
    for i in range(views):
        prog.step(i, prog.seed(seed, -1, i))
    sync(device)

    tracer = None
    if trace:
        from .trace import Tracer
        tracer = Tracer(Path(tempfile.gettempdir()))
        tracer.__enter__()
    # a uniform sample of the window's steps, drawn from the seed as they
    # come (a reservoir), so that only the sampled steps' maps are kept
    rng = random.Random(seed)
    k = int(traffic["reference_steps"])
    kept, ends = [], []
    t_w0 = time.perf_counter()
    while not ends or ends[-1] - t_w0 < seconds:
        n = len(ends)
        i, cycle = n % views, n // views
        s = prog.seed(seed, cycle, i)
        out = prog.step(i, s)
        ends.append(time.perf_counter())
        if n < k:
            kept.append((i, s, out))
        else:
            j = rng.randrange(n + 1)
            if j < k:
                kept[j] = (i, s, out)
        del out
    t_w1 = ends[-1]
    if tracer is not None:
        tracer.__exit__(None, None, None)
    setup_s = t_w0 - t0
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0

    info = [f"card {device_name(device)} at {power_limit()}; scan "
            f"{gt_shape} written {written} B; {len(ends)} steps in "
            f"{t_w1 - t_w0:.3f} s"]
    walls = np.diff([t_w0] + ends) * 1e3
    per_view = [float(np.mean(walls[i::views]))
                for i in range(min(views, len(walls)))]
    info.append("step ms by view: " + " ".join(f"{v:.1f}" for v in per_view))
    slow = np.argsort(walls)[::-1][:5]
    info.append("slowest steps (step, view, ms): " + " ".join(
        f"({j}, {j % views}, {walls[j]:.1f})" for j in slow))
    weak_prior = [int((p["weak"] == 0).sum()) for p in raw.priors]
    weak_out = [round(float((o.weak == 0).mean()), 4) for _, _, o in kept]
    info.append(f"weak list a view (prior WEAK pixels): {weak_prior}; "
                f"WEAK share of the sampled steps' outputs: {weak_out}")

    metrics = {}
    result_device = {"platform": "gpu" if device.type == "cuda" else "cpu",
                     "kind": device_name(device), "count": 1,
                     "memory_peak_bytes": int(peak)}
    breakdown = None
    if tracer is not None:
        rec = tracer.reduce(len(ends))
        for m in cell.per_layer:
            value = manifest.reader(cell.root, m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result_device.update(busy_s=rec.busy_s, window_s=rec.window_s)
        info.append(f"traced window: {rec.counting_s:.4f} s in which the "
                    f"K3 count alone ran cut out of "
                    f"{rec.window_s + rec.counting_s:.4f} s")
        breakdown = {"device_ops": rec.device_ops,
                     "idle_gaps": rec.idle_gaps}
    else:
        own = {"view_ms": 1e3 * (t_w1 - t_w0) / len(ends),
               "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": own[m["name"]], "unit": m["unit"]}

    # the comparison: the program's state freed, the reference in its place
    problems = [p.ref_image_id for p in prog.problems]
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rspec = pass_ref.schedule_pass(cfg, traffic)
    per_step = []
    t_ref = time.perf_counter()
    for i, s, out in kept:
        want = pass_ref.run_pass(raw, problems[i], rspec, s, device)
        per_step.append(judge.compare(out, want))
    info.append(f"reference: {len(kept)} step(s) (views "
                f"{[problems[i] for i, _, _ in kept]}) in "
                f"{time.perf_counter() - t_ref:.1f} s")
    shutil.rmtree(root, ignore_errors=True)
    correct, failed, compared = judge.verdict(per_step)
    result = {"correct": correct, "attempted": len(ends),
              "failed": failed, "metrics": metrics, "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    return result, info


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def power_limit() -> str:
    """The card's power limit as `nvidia-smi` reads it: the peaks the
    roofline shares divide by are the card's at 700 W."""
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "an unread power limit"
    return proc.stdout.strip().splitlines()[0] if proc.stdout.strip() \
        else "an unread power limit"


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def emit(result: dict, info: list) -> None:
    """The run's report: ``info`` and then each number compared beside its
    limit as the last lines on standard error, the result as the last line
    on standard output."""
    for line in info:
        print(line, file=sys.stderr)
    for name, v in result["compared"].items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--benchmark", type=Path, default=manifest.MANIFEST,
                    help="the manifest (BENCHMARK.json at the root)")
    args = ap.parse_args(argv)
    cell = manifest.cell(args.benchmark, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"mvsbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": no result", file=sys.stderr)
        return 2
    result, info = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"mvsbench: the run loaded {found}: no result", file=sys.stderr)
        return 3
    emit(result, info)
    return 0

if __name__ == "__main__":
    sys.exit(main())
