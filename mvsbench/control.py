"""The readings the limits of `judge` are set from, at a cell's own size.

    python3 -m mvsbench.control --workload <cell> --seeds 1,2,3 [--out FILE]

For each seed: the cell's scan and the program's views as a run makes
them, one step of the pass (the view and pass seed a run's first cycle
gives that view), the plain reference of that step, and the control, the
reference with its planes and costs in bfloat16. Prints, a seed a line,
the program's numbers against the reference (the lower readings) and the
control's (the upper readings), and writes them as JSON to ``--out``. The
benchmark's own runs never run the control. Needs the card.
"""

from __future__ import annotations

import argparse
import gc
import json
import random
import shutil
import sys
import time
from pathlib import Path

import torch

from . import judge, manifest, program, run, scan, scene
from .reference import pass_ref


def readings(cell: manifest.Cell, seed: int, device) -> dict:
    cfg, traffic = cell.config, cell.traffic
    root = run.scan_dir(cell.name)
    shutil.rmtree(root, ignore_errors=True)
    sc = scene.make_scene(cfg, float(traffic["weak_share"]), seed, device)
    raw = scan.write_scan(root, sc, traffic, seed, int(cfg["sources"]))
    del sc
    prog = program.Program.load(raw, program.schedule_pass(cfg, traffic),
                                device)
    i = random.Random(seed).randrange(len(prog.views))
    s = prog.seed(seed, 0, i)
    out = prog.step(i, s)
    view = prog.problems[i].ref_image_id
    del prog
    gc.collect()
    torch.cuda.empty_cache()
    spec = pass_ref.schedule_pass(cfg, traffic)
    t = time.perf_counter()
    want = pass_ref.run_pass(raw, view, spec, s, device)
    ref_s = time.perf_counter() - t
    low = pass_ref.run_pass(raw, view, spec, s, device, lower=True)
    shutil.rmtree(root, ignore_errors=True)
    return {"seed": seed, "view": view, "reference_s": ref_s,
            "program": judge.compare(out, want),
            "control": judge.compare(low, want)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mvsbench.control needs the card", file=sys.stderr)
        return 2
    cell = manifest.cell(manifest.MANIFEST, args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        rows.append(readings(cell, seed, torch.device("cuda", 0)))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
