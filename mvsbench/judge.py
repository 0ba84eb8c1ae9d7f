"""The comparison that decides `correct`.

A step's returned maps (depth, normal, weak class, confidence, cost) are
compared with the plain reference's maps of the same pass (same inputs,
same pass seed) pixel by pixel. Each number is the percent of the image's
pixels at which a map differs from the reference's: a float map where its
bits differ (NaN against NaN counts as equal), a normal where any of its
three components does. A number over its limit makes the run incorrect.
The limits and the readings they were set from are in PERF.md.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

MAPS = ("depth", "normal", "weak", "confidence", "cost")
# the program reads 0 on every number at both cells' sizes; the control
# (the reference in bfloat16) at least 99.9 (depth), 100 (normal), 3.75
# (weak), 42.8 (confidence) and 99.98 (cost): PERF.md section 2
LIMITS = {"depth_off_pct": 1.0, "normal_off_pct": 1.0, "weak_off_pct": 0.5,
          "confidence_off_pct": 1.0, "cost_off_pct": 1.0}


def off_pct(got: np.ndarray, want: np.ndarray) -> float:
    """Percent of pixels at which ``got`` differs from ``want``."""
    if got.shape != want.shape:
        return 100.0
    if got.dtype.kind == "f":
        same = (got == want) | (np.isnan(got) & np.isnan(want))
    else:
        same = got == want
    if same.ndim == 3:
        same = same.all(-1)
    return 100.0 * float((~same).mean())


def compare(got, want) -> Dict[str, float]:
    """The numbers of one step: ``got`` the program's maps, ``want`` the
    reference's (anything with the `MAPS` attributes, cropped alike)."""
    return {f"{m}_off_pct": off_pct(np.asarray(getattr(got, m)),
                                    np.asarray(getattr(want, m)))
            for m in MAPS}


def verdict(per_step: List[Dict[str, float]]) -> Tuple[bool, int, dict]:
    """(correct, steps failed, each number's worst reading beside its
    limit) over the compared steps."""
    failed = sum(any(v > LIMITS[k] for k, v in s.items()) for s in per_step)
    worst = {k: {"value": max(s[k] for s in per_step), "limit": LIMITS[k]}
             for k in LIMITS}
    return bool(per_step) and failed == 0, failed, worst
