"""ETH3D training-split evaluation driver (reference: tools/eval_eth_train.py).

Runs the official `ETH3DMultiViewEvaluation` binary per scan (tolerances
0.01-0.5 m), parses completeness/accuracy/F1 from the result files and prints
tables at 2 cm and 10 cm.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import subprocess
import sys
from typing import Dict, List, Optional

from ..config import ETH3D_TRAIN_SCANS

TOLERANCES = "0.01,0.02,0.05,0.1,0.2,0.5"
REPORT_TOLERANCES = (0.02, 0.1)


def evaluate_scan(eval_bin: str, ply_path: str, gt_mlp: str,
                  result_path: str) -> None:
    cmd = [eval_bin, "--reconstruction_ply_path", ply_path,
           "--ground_truth_mlp_path", gt_mlp, "--tolerances", TOLERANCES]
    with open(result_path, "w") as out:
        subprocess.run(cmd, stdout=out, stderr=subprocess.STDOUT, check=False)


def parse_result(result_path: str) -> Optional[Dict[str, List[float]]]:
    """Parse 'Tolerances / Completenesses / Accuracies / F1-scores' rows
    (reference: tools/eval_eth_train.py:54-99)."""
    if not os.path.exists(result_path):
        return None
    metrics: Dict[str, List[float]] = {}
    keys = {"Tolerances": "tolerances", "Completenesses": "completeness",
            "Accuracies": "accuracy", "F1-scores": "f1"}
    with open(result_path) as f:
        for line in f:
            for label, key in keys.items():
                if line.startswith(label):
                    vals = line.split(":", 1)[1].strip().split()
                    metrics[key] = [float(v) for v in vals]
    if "f1" not in metrics:
        return None
    return metrics


def show(results: Dict[str, Optional[Dict[str, List[float]]]]) -> str:
    lines = []
    for tol in REPORT_TOLERANCES:
        lines.append(f"==== tolerance {tol * 100:.0f} cm ====")
        header = f"{'scan':<16}{'completeness':>14}{'accuracy':>10}{'f1':>8}"
        lines.append(header)
        sums = [0.0, 0.0, 0.0]
        count = 0
        for scan, m in results.items():
            if m is None or "tolerances" not in m:
                lines.append(f"{scan:<16}{'-':>14}{'-':>10}{'-':>8}")
                continue
            try:
                ti = m["tolerances"].index(tol)
            except ValueError:
                continue
            c, a, f1 = m["completeness"][ti], m["accuracy"][ti], m["f1"][ti]
            sums[0] += c
            sums[1] += a
            sums[2] += f1
            count += 1
            lines.append(f"{scan:<16}{c:>14.4f}{a:>10.4f}{f1:>8.4f}")
        if count:
            lines.append(f"{'AVERAGE':<16}{sums[0] / count:>14.4f}"
                         f"{sums[1] / count:>10.4f}{sums[2] / count:>8.4f}")
    text = "\n".join(lines)
    print(text)
    return text


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", required=True,
                   help="ETH3D train root (scan folders with APD/APD.ply)")
    p.add_argument("--gt_dir", required=True,
                   help="ground-truth root with <scan>/dslr_scan_eval/scan_alignment.mlp")
    p.add_argument("--eval_bin", default="ETH3DMultiViewEvaluation")
    p.add_argument("--work_num", type=int, default=4)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--scans", nargs="+", default=ETH3D_TRAIN_SCANS)
    args = p.parse_args(argv)

    jobs = []
    for scan in args.scans:
        ply = os.path.join(args.data_dir, scan, "APD", "APD.ply")
        gt = os.path.join(args.gt_dir, scan, "dslr_scan_eval",
                          "scan_alignment.mlp")
        result = os.path.join(args.data_dir, scan, "APD", "result.txt")
        if args.resume and os.path.exists(result):
            continue
        if os.path.exists(ply):
            jobs.append((args.eval_bin, ply, gt, result))
        else:
            print(f"missing {ply}")
    if jobs:
        with multiprocessing.get_context("spawn").Pool(
                min(args.work_num, max(len(jobs), 1))) as pool:
            pool.starmap(evaluate_scan, jobs)
    results = {scan: parse_result(
        os.path.join(args.data_dir, scan, "APD", "result.txt"))
        for scan in args.scans}
    show(results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
