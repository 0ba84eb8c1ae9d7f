"""The system under test: `apde_mvs_tpu_torch`, reached only at its entry
points (the scan driver's problem list, view loader and pass seed, the
per-view engine `run_patchmatch`, the memory cache and the schedule) and
its kernels' launch counters."""

from __future__ import annotations

import dataclasses
from typing import List

from apde_mvs_tpu_torch import config as port_config
from apde_mvs_tpu_torch.io.cache import MemoryCache
from apde_mvs_tpu_torch.ops.cuda import anchors, ncc, sampler, select, \
    strong, sweep, weak, weak_sweep
from apde_mvs_tpu_torch.pipeline import driver
from apde_mvs_tpu_torch.pipeline.patchmatch import run_patchmatch

from .scan import RawScan

# each hand kernel: its launch counter (module, attribute) and the names
# of its device functions as the profiler shows them
KERNELS = {
    "K1": ((sampler, "launches"), ("sample_packed_kernel",
                                   "sample_image_kernel", "empty_kernel")),
    "K2": ((ncc, "launches"), ("ncc_strong_kernel", "ncc_stage_kernel")),
    "K3": ((strong, "launches"), ("strong_kernel",)),
    "K5": ((sweep, "launches"), ("sweep_kernel", "stage_sweep_kernel")),
    "K6": ((weak, "launches"), ("weak_kernel", "rescore_weak_kernel")),
    "K7": ((weak_sweep, "launches"), ("weak_update_kernel",)),
    "K8": ((anchors, "anchor_launches"), ("gen_anchors",)),
    "K9": ((anchors, "fit_launches"), ("fit_planes",)),
    "K10": ((anchors, "jfa_launches"), ("jfa_phases",)),
    "K11": ((select, "launches"), ("topk_select_kernel",)),
}
STRONG_PATH = ("K1", "K2", "K3", "K5", "K11")
WEAK_PATH = ("K6", "K7", "K8", "K9", "K10")


def launch_counts() -> dict:
    return {k: getattr(mod, attr) for k, ((mod, attr), _) in KERNELS.items()}


def schedule_pass(cfg: dict, traffic: dict):
    """The cell's pass: ``traffic["pass_in_round"]`` of round
    ``traffic["round"]`` (negative from the last) of the configuration's
    schedule, as the program builds it."""
    sched = port_config.build_schedule(
        max(int(cfg["height"]), int(cfg["width"])), cfg["dataset"],
        use_sa=bool(cfg["use_sa"]), sampler_u8=bool(cfg["sampler_u8"]),
        base=int(cfg.get("pyramid_base", 800)))
    rounds = sched[-1].round_index + 1
    r = int(traffic["round"]) % rounds
    return [s for s in sched if s.round_index == r][int(traffic["pass_in_round"])]


@dataclasses.dataclass
class Program:
    problems: list
    spec: object
    views: List[driver.ViewInputs]

    @staticmethod
    def load(scan: RawScan, spec, device) -> "Program":
        """The program's own view loader over the scan, its priors and
        images handed in through its memory cache at the paths it reads."""
        cache = MemoryCache()
        problems = driver.generate_sample_list(scan.root)
        for p in problems:
            v = p.ref_image_id
            image = p.dense_folder / "images" / f"{v:08d}{p.img_ext}"
            cache.img_cache[str(image)] = scan.gray[v]
            for name, mat in scan.priors[v].items():
                cache.mat_cache[str(p.result_folder / f"{name}.bin")] = mat
            cache.mat_cache[str(scan.root / "sa_masks" / f"{v:08d}.bin")] = \
                scan.sa[v]
        views = [driver.load_view(p, spec, cache, device) for p in problems]
        return Program(problems, spec, views)

    def seed(self, run_seed: int, cycle: int, index: int) -> int:
        """The pass seed of view ``index`` in ``cycle``: `driver.pass_seed`
        of a seed that the cycle changes."""
        return driver.pass_seed(run_seed + cycle * 1_000_000_007,
                                self.problems[index].ref_image_id,
                                self.spec.iteration)

    def step(self, index: int, seed: int):
        """One view's pass, as the engine runs it; ends in its copies to
        the host."""
        vi = self.views[index]
        return run_patchmatch(vi.data, self.spec.params, **vi.priors,
                              valid=vi.valid, depth_min=vi.depth_min,
                              depth_max=vi.depth_max, seed=seed)
