"""Host orchestration of the scale-out engines.

`ViewParallelRunner` replaces the serial `for problem: process_problem(...)`
loop of `run_scan` with the view-parallel pass (`parallel.scene`): a
batch's views are split over the ranks of the process group and run at the
same time, the reference's file-based neighbour-depth exchange
(APD.cpp:592-610) becoming one all-gather. Each rank loads the priors of
its own views only and persists only the views it owns; a barrier ends
every batch, so the next reads see every view's bins.

Files remain the interchange between passes, exactly like the serial
engine, so resume / only_fuse / visualization semantics are unchanged and
a scan can switch engines at any pass boundary.

Pass-ordering semantics: the serial engine processes views in order within
a pass, so a geometric pass sees current-pass depths for neighbours it has
already processed (incidental Gauss-Seidel). The view-parallel engine is
Jacobi: every view reads the previous pass's depths. This matches the
reference's own multi-GPU behaviour (concurrently scheduled scans see
whatever is on disk) and is the formulation that parallelizes. Each
view's generator is seeded as the serial engine seeds it
(`driver.pass_seed`), so the FIRST_INIT pass equals the serial engine's
bit for bit, and every pass is invariant to the world size and to
``view_batch``.

`run_pass_tiled` is the tile route (`parallel.tile_pass`): view by view in
scan order, each view's pass row-sharded over all ranks. It reads and
writes as the serial engine does (every rank holds each view's maps;
rank 0 writes the files), so it equals the serial engine bit for bit.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import config as cfg
from ..io import read_bin_mat
from ..io.images import resize_nearest
from ..parallel import distributed as pdist
from ..parallel.mesh import ViewGroup
from .driver import (PAD_H, PAD_W, Problem, _load_scaled_view, format_index,
                     load_view, pass_seed, persist_view_results)
from .patchmatch import pad_to_multiple, run_patchmatch


class _RoundData:
    """One view batch's tables at one pyramid scale.

    ``ids``: every view id the batch touches (its reference views, then
    their sources, first appearance order), the image-table slots.
    ``pair`` (Vp, S) and ``ref_slot`` (Vp,) address those slots (a padded
    entry is slot M); padded problem slots repeat problem 0. ``depth_slot``
    (M + 1,) maps a slot to its row of the exchanged depth stack
    (`parallel.scene`). With ``scan_ref_ids`` covering more reference
    views than the batch, the others' depths are read from their files
    (``ext_ids``)."""

    def __init__(self, problems: List[Problem], scale_size: int, cache,
                 world: int, scan_ref_ids=None):
        self.scale_size = scale_size
        ids: List[int] = []
        for p in problems:
            for vid in [p.ref_image_id] + list(p.src_image_ids):
                if vid not in ids:
                    ids.append(vid)
        slot = {vid: i for i, vid in enumerate(ids)}
        self.ids = ids
        M = len(ids)
        img, _ = _load_scaled_view(problems[0], problems[0].ref_image_id,
                                   scale_size, cache)
        self.h, self.w = img.shape
        self.ph, self.pw = pad_to_multiple(img, PAD_H, PAD_W).shape

        V = len(problems)
        self.Vp = ViewGroup(0, world, V).padded
        self.S = max(len(p.src_image_ids) for p in problems)
        probs = list(problems) + [problems[0]] * (self.Vp - V)
        self.pair = np.full((self.Vp, self.S), M, np.int64)
        self.n_src = np.zeros((self.Vp,), np.int64)
        self.ref_slot = np.zeros((self.Vp,), np.int64)
        # float64, as the serial engine computes them
        self.dmin = np.zeros((self.Vp,), np.float64)
        self.dmax = np.zeros((self.Vp,), np.float64)
        for i, p in enumerate(probs):
            self.ref_slot[i] = slot[p.ref_image_id]
            self.n_src[i] = len(p.src_image_ids)
            for j, sid in enumerate(p.src_image_ids):
                self.pair[i, j] = slot[sid]
            _, cam = _load_scaled_view(p, p.ref_image_id, scale_size, cache)
            self.dmin[i] = cam.depth_min * cfg.DEPTH_MIN_FACTOR
            self.dmax[i] = cam.depth_max * cfg.DEPTH_MAX_FACTOR
        # table slot -> row of the depth stack [gathered Vp | zero | ext]
        ref_row = {p.ref_image_id: i for i, p in enumerate(problems)}
        scan_refs = set(scan_ref_ids) if scan_ref_ids is not None \
            else set(ref_row)
        self.ext_ids: List[int] = []
        self.depth_slot = np.full((M + 1,), self.Vp, np.int64)
        for vid, s in slot.items():
            if vid in ref_row:
                self.depth_slot[s] = ref_row[vid]
            elif vid in scan_refs:
                self.depth_slot[s] = self.Vp + 1 + len(self.ext_ids)
                self.ext_ids.append(vid)


class ViewParallelRunner:
    """Runs each pass with the scan's views split over the process group
    (or all on this process without one)."""

    def __init__(self, problems: List[Problem], cache, seed: int = 0,
                 view_batch: Optional[int] = None, device="cuda"):
        self.problems = problems
        self.cache = cache
        self.seed = seed
        self.device = torch.device(device)
        # view_batch caps how many reference views one batch holds: the
        # exchanged depth stack scales with the batch, not the scan. None
        # = sized from the device's free memory (`_auto_view_batch`)
        self.view_batch = view_batch
        self._rounds: Dict[tuple, _RoundData] = {}
        self.rank, self.world = pdist.rank_and_world()

    def _auto_view_batch(self) -> int:
        """Largest batch whose exchanged depth stack and per-view maps fit
        a quarter of the card's free memory: ~70 bytes a pixel a view
        (the stack every rank holds, the priors and outputs). On the CPU
        the whole scan."""
        if self.device.type != "cuda":
            return len(self.problems)
        free, _ = torch.cuda.mem_get_info(self.device)
        p0 = self.problems[0]
        img, _ = _load_scaled_view(p0, p0.ref_image_id, 1, self.cache)
        per_view = 70 * img.shape[0] * img.shape[1]
        return int(max(1, min(len(self.problems), (free // 4) // per_view)))

    def _batches(self) -> List[List[Problem]]:
        vb = self.view_batch
        if vb is None:
            vb = self.view_batch = self._auto_view_batch()
        if not vb or vb >= len(self.problems):
            return [self.problems]
        return [self.problems[i:i + vb]
                for i in range(0, len(self.problems), vb)]

    def _round_data(self, spec: cfg.PassSpec, batch: List[Problem]
                    ) -> _RoundData:
        key = (spec.scale_size, batch[0].ref_image_id, len(batch))
        if key not in self._rounds:
            self._rounds = {k: v for k, v in self._rounds.items()
                            if k[0] == spec.scale_size}
            self._rounds[key] = _RoundData(
                batch, spec.scale_size, self.cache, self.world,
                scan_ref_ids=[p.ref_image_id for p in self.problems])
        return self._rounds[key]

    def _load_depth(self, problem: Problem, rd: _RoundData,
                    cache) -> np.ndarray:
        mat = read_bin_mat(problem.result_folder / "depths.bin", cache=cache)
        if mat.shape[:2] != (rd.h, rd.w):
            mat = resize_nearest(mat, (rd.h, rd.w))
        return pad_to_multiple(mat.astype(np.float32), PAD_H, PAD_W,
                               mode="constant")

    def run_pass(self, spec: cfg.PassSpec) -> None:
        """One pass for every view, batch by batch."""
        for batch in self._batches():
            self._run_pass_batch(spec, batch)

    def _run_pass_batch(self, spec: cfg.PassSpec,
                        problems: List[Problem]) -> None:
        from ..parallel.scene import ScenePassInputs, run_scene_pass

        t0 = time.time()
        params = spec.params
        geom_or_apd = params.geom_consistency or params.use_apd
        rd = self._round_data(spec, problems)
        group = ViewGroup(self.rank, self.world, len(problems))
        dev = self.device

        # the exchanged rows: this rank's slots' prior depths (geometric /
        # APD passes read them through the all-gather) ...
        prior = torch.zeros((group.per, rd.ph, rd.pw), device=dev)
        ext = torch.zeros((0, rd.ph, rd.pw), device=dev)
        if geom_or_apd:
            for i, g in enumerate(group.slots()):
                if g < len(problems):
                    prior[i] = torch.as_tensor(
                        self._load_depth(problems[g], rd, self.cache),
                        device=dev)
            # ... and other batches' views, from their files (another rank
            # may own them: never from this process's cache)
            if rd.ext_ids:
                by_ref = {p.ref_image_id: p for p in self.problems}
                ext = torch.as_tensor(np.stack([
                    self._load_depth(by_ref[v], rd, None)
                    for v in rd.ext_ids]), device=dev)
        scene = ScenePassInputs(spec, problems, rd, group, prior, ext)
        outs = run_scene_pass(scene, self.seed, self.cache, dev)
        pm_ms = (time.time() - t0) * 1000
        for k, g in enumerate(outs.slots):
            p = problems[g]
            persist_view_results(
                p, spec, outs.depth[k], outs.normal[k], outs.weak[k],
                outs.confidence[k], float(rd.dmin[g]), float(rd.dmax[g]),
                geom_or_apd, self.cache,
                show_medium_result=spec.show_medium_result)
            p.used_time_ms += pm_ms / max(len(outs.slots), 1)
        pdist.barrier()
        print(f"Processed {len(outs.slots)} of {len(problems)} views iter "
              f"{spec.iteration} on rank {self.rank} of {self.world}: "
              f"{pm_ms:.0f} ms", flush=True)

    def run_pass_tiled(self, spec: cfg.PassSpec) -> None:
        """One pass view by view in scan order, each view's pass
        row-sharded over every rank (`parallel.tile_pass`)."""
        from ..parallel.tile_pass import RowShard

        params = spec.params
        geom_or_apd = params.geom_consistency or params.use_apd
        shard = RowShard(self.rank, self.world)
        for problem in self.problems:
            t0 = time.time()
            vi = load_view(problem, spec, self.cache, self.device)
            out = run_patchmatch(
                vi.data, params, **vi.priors, valid=vi.valid,
                depth_min=vi.depth_min, depth_max=vi.depth_max,
                seed=pass_seed(self.seed, problem.ref_image_id,
                               spec.iteration),
                shard=shard)
            pm_ms = (time.time() - t0) * 1000
            h, w = vi.h, vi.w
            # every rank holds the view's maps: rank 0 writes the files,
            # the others keep them in their caches; the barrier lets a
            # rank without a cache read them back
            persist_view_results(
                problem, spec, out.depth[:h, :w], out.normal[:h, :w],
                out.weak[:h, :w], out.confidence[:h, :w], vi.depth_min,
                vi.depth_max, geom_or_apd, self.cache,
                show_medium_result=spec.show_medium_result,
                write_files=self.rank == 0)
            pdist.barrier()
            problem.used_time_ms += pm_ms
            print(f"Processed view {format_index(problem.ref_image_id)} "
                  f"iter {spec.iteration} TILED over {self.world} rank(s): "
                  f"{pm_ms:.0f} ms", flush=True)
