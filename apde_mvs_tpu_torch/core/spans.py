"""Profiler ranges around the view pass's stages and the engine's host work.

A span is a `torch.profiler.record_function` range, so it lies in the same
trace as the card's kernels and copies, on the profiler's clock. It is
entered only while a profiler is recording (`--profile_dir`, a traced
benchmark run, `tools.profile_pass`); otherwise `span` hands back one shared
no-op context. Spans mark stages, never a chunk or a launch: the launch
counters and the device trace resolve those. A step's spans nest on the
thread that runs it:

    run_patchmatch            `pipeline.patchmatch.run_patchmatch`, one a call
      run_patchmatch.priors   PassStatic, the generator, the depth bounds,
                              `prior_state`'s uploads
      pass.sweeps             `full_pass.pass_sweeps`
        pass.apd_setup        the weak list, host camera, K10, K8, demotion
        pass.initial_cost     the initial planes and the initial cost
        pass.strong_sweep     one a colour and iteration
        pass.fit_planes       one an iteration (APD)
        pass.weak_sweep       one an iteration (APD)
        pass.to_depth_normal  planes to depth and normal, the median filters
      pass.classify           `full_pass.pass_classify`
      pass.finish             `full_pass.pass_finish`: confidence, refine
      run_patchmatch.outputs  the anchors map, the debug exports, the maps
                              copied to the host

The engine's own: `driver.load_view`, `driver.persist_view_results`, and
`kernels.build` around each kernel library's build or load.
"""

from __future__ import annotations

import contextlib

import torch

RUN = "run_patchmatch"
PRIORS = "run_patchmatch.priors"
OUTPUTS = "run_patchmatch.outputs"
SWEEPS = "pass.sweeps"
APD_SETUP = "pass.apd_setup"
INITIAL_COST = "pass.initial_cost"
STRONG_SWEEP = "pass.strong_sweep"
FIT_PLANES = "pass.fit_planes"
WEAK_SWEEP = "pass.weak_sweep"
TO_DEPTH_NORMAL = "pass.to_depth_normal"
CLASSIFY = "pass.classify"
FINISH = "pass.finish"
LOAD_VIEW = "driver.load_view"
PERSIST = "driver.persist_view_results"
BUILD = "kernels.build"

# a step's spans
STEP = (RUN, PRIORS, SWEEPS, APD_SETUP, INITIAL_COST, STRONG_SWEEP,
        FIT_PLANES, WEAK_SWEEP, TO_DEPTH_NORMAL, CLASSIFY, FINISH, OUTPUTS)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler records, else a
    no-op context (an ungated `record_function` costs ~20x more)."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
