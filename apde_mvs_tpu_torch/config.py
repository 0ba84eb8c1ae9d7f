"""Declarative configuration for the PatchMatch MVS pipeline.

Lifts every compile-time constant, parameter default, and hard-coded per-round
schedule of the reference into one place (reference: main.h:40-115,
main.cpp:129-146,288-367, APD.cpp:554-555). The values here ARE the reference
defaults; the multi-scale schedule is generated, not hand-unrolled.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

# ---------------------------------------------------------------------------
# Constants (reference: main.h:40-45)
# ---------------------------------------------------------------------------
MAX_IMAGES = 32          # max views per problem (ref + sources)
ANCHOR_NUM = 9           # anchors per weak pixel (self + 8 strong supports)
MAX_SEARCH_RADIUS = 4096 # anchor directional search bound (pixels)
RELIABLE_CURVE_SAMPLE_NUM = 61  # disparity samples in reliability sweep

# Pixel states (reference: main.h:74-78; the byte values are an on-disk ABI
# via weak.bin, so the ordering must not change).
WEAK = 0
STRONG = 1
UNKNOWN = 2

# Multi-scale pyramid base resolution (reference: main.cpp:141).
PYRAMID_BASE_MAX_DIM = 800

# Depth-range widening applied per problem (reference: APD.cpp:554-555).
DEPTH_MIN_FACTOR = 0.6
DEPTH_MAX_FACTOR = 1.2

# Geometric-consistency weight per dataset family (reference: main.cpp:293-299).
GEOM_FACTOR_DEFAULT = 0.2   # ETH3D / DTU / General
GEOM_FACTOR_TAT = 0.05      # Tanks and Temples

# Number of geometric-consistency passes per pyramid round
# (reference: main.cpp:304).
GEOM_ITERATIONS_PER_ROUND = 3


@dataclasses.dataclass(frozen=True)
class PatchMatchParams:
    """Per-pass PatchMatch parameters (reference: main.h:80-100).

    ``state`` is one of "first_init", "refine_init", "refine_iter"
    (reference enum RunState, main.h:68-72).
    """

    max_iterations: int = 3
    top_k: int = 4
    geom_consistency: bool = False
    use_impetus: bool = True
    strong_radius: int = 5
    strong_increment: int = 2
    weak_radius: int = 5
    weak_increment: int = 5
    use_apd: bool = True
    use_sa: bool = True
    weak_peak_radius: int = 2
    rotate_time: int = 4
    ransac_threshold: float = 0.005
    geom_factor: float = GEOM_FACTOR_DEFAULT
    state: str = "first_init"
    # TPU extension: sample source views from u8 quad tables (~2.4x gather
    # throughput, texture-unit-grade precision; core/sampling.py). The f32
    # quad path remains as the exact-parity oracle (--sampler f32).
    sampler_u8: bool = True

    @property
    def strong_window_offsets(self) -> List[Tuple[int, int]]:
        r, inc = self.strong_radius, self.strong_increment
        axis = list(range(-r, r + 1, inc))
        return [(dx, dy) for dy in axis for dx in axis]

    @property
    def weak_window_offsets(self) -> List[Tuple[int, int]]:
        r, inc = self.weak_radius, self.weak_increment
        axis = list(range(-r, r + 1, inc))
        return [(dx, dy) for dy in axis for dx in axis]


@dataclasses.dataclass(frozen=True)
class PassSpec:
    """One PatchMatch invocation of one view within the multi-scale schedule."""

    round_index: int
    iteration: int           # global iteration counter (0-based)
    scale_size: int          # image downsample factor 2^(round_num-1-round)
    params: PatchMatchParams
    is_last_iteration: bool  # last geometric pass of the last round
    show_medium_result: bool


def compute_round_num(max_image_dim: int, base: int = PYRAMID_BASE_MAX_DIM) -> int:
    """Number of coarse-to-fine rounds (reference: main.cpp:129-146).

    round_num = 1 + floor-steps of halving until max dim <= base
    (integer halving, matching the reference's `while (max_size > 800)`).
    """
    round_num = 1
    while max_image_dim > base:
        max_image_dim //= 2
        round_num += 1
    return round_num


def build_schedule(
    max_image_dim: int,
    dataset: str = "General",
    use_sa: bool = True,
    use_impetus: bool = True,
    base: int = PYRAMID_BASE_MAX_DIM,
    sampler_u8: bool = True,
) -> List[PassSpec]:
    """Generate the full multi-scale pass schedule.

    Mirrors the hard-coded loop of the reference (main.cpp:306-367): per round,
    one photometric pass (FIRST_INIT at round 0, else REFINE_INIT with APD on)
    followed by GEOM_ITERATIONS_PER_ROUND geometric passes (REFINE_ITER).
    """
    geom_factor = GEOM_FACTOR_TAT if dataset in ("TaT_a", "TaT_i") else GEOM_FACTOR_DEFAULT
    round_num = compute_round_num(max_image_dim, base)
    schedule: List[PassSpec] = []
    iteration = 0
    for i in range(round_num):
        scale_size = 2 ** (round_num - 1 - i)
        if i == 0:
            photo = PatchMatchParams(
                state="first_init", use_apd=False, geom_consistency=False,
                max_iterations=3, weak_peak_radius=6, use_sa=use_sa,
                use_impetus=use_impetus, geom_factor=geom_factor,
                sampler_u8=sampler_u8)
        else:
            photo = PatchMatchParams(
                state="refine_init", use_apd=True, geom_consistency=False,
                max_iterations=3, weak_peak_radius=6, use_sa=use_sa,
                use_impetus=use_impetus, geom_factor=geom_factor,
                ransac_threshold=0.01 - i * 0.00125,
                rotate_time=min(2 ** i, 4), sampler_u8=sampler_u8)
        schedule.append(PassSpec(i, iteration, scale_size, photo, False, False))
        iteration += 1
        for j in range(GEOM_ITERATIONS_PER_ROUND):
            is_last = (i == round_num - 1 and j == GEOM_ITERATIONS_PER_ROUND - 1)
            geom = PatchMatchParams(
                state="refine_iter",
                use_apd=(i != 0),
                geom_consistency=True,
                max_iterations=3,
                weak_peak_radius=max(4 - 2 * j, 2),
                use_sa=use_sa, use_impetus=use_impetus, geom_factor=geom_factor,
                ransac_threshold=(0.01 - i * 0.00125) if i != 0 else 0.005,
                rotate_time=min(2 ** i, 4) if i != 0 else 4,
                sampler_u8=sampler_u8)
            schedule.append(PassSpec(
                i, iteration, scale_size, geom, is_last,
                show_medium_result=(j == GEOM_ITERATIONS_PER_ROUND - 1)))
            iteration += 1
    return schedule


@dataclasses.dataclass(frozen=True)
class FusionParams:
    """Fusion thresholds per dataset variant (reference: APD.cpp:1051-1608)."""

    variant: str = "general"      # "general" | "tat_i" | "tat_a"
    # general-variant thresholds (APD.cpp:1189-1199)
    reproj_max: float = 2.0
    rel_depth_max: float = 0.01
    angle_max: float = 0.174533   # ~10 degrees
    dyn_factor_weak: float = 0.45
    dyn_factor_strong: float = 0.3
    # escalating-k thresholds (TaT variants, APD.cpp:1239-1243, 1443-1444)
    dist_base: float = 0.25
    depth_base_tat_i: float = 1.0 / 3500.0
    depth_base_tat_a: float = 1.0 / 3000.0
    angle_base: float = 0.06981317007977318   # 4 degrees
    angle_grad: float = 0.05235987755982988   # 3 degrees
    # visibility-conflict filter (APD.cpp:962-1049)
    weak_filter: bool = True
    vis_max_baseline_deg: float = 80.0
    vis_depth_margin: float = 0.01
    strong_occluded_max: int = 2
    weak_occluded_max: int = 4


def infer_dataset(data_dir: str, scan: str) -> str:
    """Dataset auto-detection from path substrings (reference: run.py:83-92)."""
    tat_advanced = {"Auditorium", "Ballroom", "Courtroom", "Museum", "Palace", "Temple"}
    if "DTU" in data_dir:
        return "DTU"
    if "TaT" in data_dir:
        return "TaT_a" if scan in tat_advanced else "TaT_i"
    if "ETH3D" in data_dir:
        return "ETH3D"
    return "General"


# Scan presets (reference: run.py:173-180).
ETH3D_TRAIN_SCANS = [
    "courtyard", "delivery_area", "electro", "facade", "kicker", "meadow",
    "office", "pipes", "playground", "relief", "relief_2", "terrace", "terrains",
]
ETH3D_TEST_SCANS = [
    "botanical_garden", "boulders", "bridge", "door", "exhibition_hall",
    "lecture_room", "living_room", "lounge", "observatory", "old_computer",
    "statue", "terrace_2",
]
TAT_INTERMEDIATE_SCANS = [
    "Family", "Francis", "Horse", "Lighthouse", "M60", "Panther", "Playground",
]
TAT_ADVANCED_SCANS = [
    "Auditorium", "Ballroom", "Courtroom", "Museum", "Palace", "Temple",
]
