"""The port's spans and pass counters on the CPU: one APD REFINE_INIT pass
at 48x64 under `torch.profiler` opens the spans `core/spans.py` documents,
nested as it documents them, and returns the same maps bit for bit as
without a profiler; the pass counters equal the sizes the pass works on;
the engine's spans (`load_view`, `persist_view_results`, a kernel build)
open once a call; and without a profiler `spans.span` enters nothing."""

import numpy as np
import pytest
import torch

from apde_mvs_tpu_torch import config as tcfg
from apde_mvs_tpu_torch.core import geometry as tgeo
from apde_mvs_tpu_torch.core import spans
from apde_mvs_tpu_torch.io import MemoryCache
from apde_mvs_tpu_torch.ops.cost import CostData
from apde_mvs_tpu_torch.ops.cuda import build
from apde_mvs_tpu_torch.ops.cuda.sweep import MIN_MARGIN
from apde_mvs_tpu_torch.pipeline import driver, full_pass
from apde_mvs_tpu_torch.pipeline.patchmatch import run_patchmatch
from apde_mvs_tpu_torch.testing import synthetic

# one intra-op thread a worker process, as the port's other pass tests
torch.set_num_threads(1)

H, W, V = 48, 64, 3
WEAK_REGION = (-0.3, 0.3, -0.2, 0.2)
SEED = 7

# each span of a step and the span it opens in (core/spans.py's tree)
PARENT = {
    spans.PRIORS: spans.RUN, spans.SWEEPS: spans.RUN,
    spans.CLASSIFY: spans.RUN, spans.FINISH: spans.RUN,
    spans.OUTPUTS: spans.RUN, spans.APD_SETUP: spans.SWEEPS,
    spans.INITIAL_COST: spans.SWEEPS, spans.STRONG_SWEEP: spans.SWEEPS,
    spans.FIT_PLANES: spans.SWEEPS, spans.WEAK_SWEEP: spans.SWEEPS,
    spans.TO_DEPTH_NORMAL: spans.SWEEPS,
}


@pytest.fixture(scope="module")
def apd_view():
    """An APD REFINE_INIT pass's inputs on view 0: priors a little off the
    ground truth, the scene's weak plane marked WEAK, and a band of
    padding rows (not valid) across it."""
    scene = synthetic.make_scene(num_views=V, height=H, width=W,
                                 weak_region=WEAK_REGION)
    gt = scene.depths[0]
    weak_region = gt < gt.mean() * 0.95
    rng = np.random.default_rng(0)
    valid = np.ones((H, W), bool)
    valid[-4:] = False
    priors = dict(
        prior_depth=(gt * (1 + 0.002 * rng.standard_normal(gt.shape))
                     ).astype(np.float32),
        prior_normal=scene.normals[0].astype(np.float32),
        prior_weak=np.where(weak_region, tcfg.WEAK,
                            tcfg.STRONG).astype(np.int32),
        prior_confidence=np.where(weak_region, 40, 200).astype(np.float32))
    params = next(s.params for s in tcfg.build_schedule(
        W, "General", use_sa=False, base=32)
        if s.params.state == "refine_init")
    assert params.use_apd
    cams = tgeo.CameraArrays.from_cameras(scene.cameras, device="cpu")
    data = CostData.build(
        cams.view(0), cams.map(lambda a: a[1:]),
        torch.as_tensor(scene.images[0]), torch.as_tensor(scene.images[1:]),
        src_depths=torch.as_tensor(scene.depths[1:]), real_width=W,
        real_height=H, sampler_u8=True)
    kw = dict(priors, valid=torch.as_tensor(valid),
              depth_min=scene.cameras[0].depth_min * tcfg.DEPTH_MIN_FACTOR,
              depth_max=scene.cameras[0].depth_max * tcfg.DEPTH_MAX_FACTOR)
    return data, params, kw, valid


@pytest.fixture(scope="module")
def profiled(apd_view):
    """The pass without a profiler, and again under one: (the plain
    outputs, the profiled outputs, the profiler's events)."""
    data, params, kw, _ = apd_view
    plain = run_patchmatch(data, params, seed=SEED, **kw)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = run_patchmatch(data, params, seed=SEED, **kw)
    return plain, traced, prof.events()


def _span_parent(evt):
    """The innermost span of a step that ``evt`` opened in, or None."""
    p = evt.cpu_parent
    while p is not None and p.name not in spans.STEP:
        p = p.cpu_parent
    return None if p is None else p.name


def test_a_step_opens_the_documented_spans(apd_view, profiled):
    _, params, _, _ = apd_view
    events = [e for e in profiled[2] if e.name in spans.STEP]
    counts = {name: sum(e.name == name for e in events)
              for name in spans.STEP}
    iters = params.max_iterations
    assert counts == {
        spans.RUN: 1, spans.PRIORS: 1, spans.SWEEPS: 1, spans.APD_SETUP: 1,
        spans.INITIAL_COST: 1, spans.STRONG_SWEEP: 2 * iters,
        spans.FIT_PLANES: iters, spans.WEAK_SWEEP: iters,
        spans.TO_DEPTH_NORMAL: 1, spans.CLASSIFY: 1, spans.FINISH: 1,
        spans.OUTPUTS: 1}
    for e in events:
        assert _span_parent(e) == PARENT.get(e.name), e.name
    assert set(PARENT) | {spans.RUN} == set(spans.STEP)


@pytest.mark.parametrize("field", [
    "depth", "normal", "weak", "confidence", "cost", "anchors",
    "anchors_map"])
def test_the_profiler_changes_no_output(profiled, field):
    plain, traced = getattr(profiled[0], field), getattr(profiled[1], field)
    assert plain.dtype == traced.dtype and plain.shape == traced.shape
    assert plain.tobytes() == traced.tobytes()


def test_pass_counters_are_the_pass_sizes(apd_view):
    """Each counter grows by the size of what its stage works on: the
    prior WEAK pixels that are valid, the reliable subset the fit and the
    weak sweep run over, and the sweepable pixels of the classify
    (margins left out) and refine stages."""
    data, params, kw, valid = apd_view
    cfg = full_pass.PassStatic.from_params(params)
    state = full_pass.prior_state(
        data, cfg, valid=kw["valid"], **{k: kw[k] for k in (
            "prior_depth", "prior_normal", "prior_weak",
            "prior_confidence")})
    gen = torch.Generator().manual_seed(SEED)
    dmin = tgeo.f32_scalar(kw["depth_min"], "cpu")
    dmax = tgeo.f32_scalar(kw["depth_max"], "cpu")
    full_pass.reset_counts()
    state, weak = full_pass.pass_sweeps(data, state, cfg, dmin, dmax, gen)
    want_weak = int(((kw["prior_weak"] == tcfg.WEAK) & valid).sum())
    assert want_weak > 0 and weak is not None
    assert full_pass.weak_pixels == want_weak == weak.x.numel()
    assert 0 < full_pass.reliable_pixels == weak.sweep[0].numel() \
        <= want_weak
    xs, ys = tgeo.pixel_grid(H, W, "cpu")
    margin = (xs < MIN_MARGIN) | (ys < MIN_MARGIN) \
        | (xs >= W - MIN_MARGIN) | (ys >= H - MIN_MARGIN)
    classify = int((full_pass.sweepable(data, state) & ~margin).sum())
    weak_map, _ = full_pass.pass_classify(data, state, cfg, dmin, dmax)
    assert full_pass.classified_pixels == classify > 0
    state = state.replace(weak=weak_map)
    refine = int(full_pass.sweepable(data, state).sum())
    full_pass.pass_finish(data, state, cfg, dmin, dmax)
    assert full_pass.refined_pixels == refine > 0
    full_pass.reset_counts()
    assert (full_pass.weak_pixels, full_pass.reliable_pixels,
            full_pass.classified_pixels, full_pass.refined_pixels) \
        == (0, 0, 0, 0)


def test_span_enters_nothing_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with spans.span(spans.RUN) as ctx:
        assert ctx is None
    assert spans.span(spans.RUN) is spans.span(spans.OUTPUTS)


def _load_view(tmp_path):
    scene = synthetic.make_scene(num_views=V, height=H, width=W)
    synthetic.write_scene_to_disk(scene, tmp_path / "scan")
    problem = driver.generate_sample_list(tmp_path / "scan")[0]
    spec = tcfg.build_schedule(W, "General")[0]
    driver.load_view(problem, spec, device="cpu")


def _persist(tmp_path):
    problem = driver.Problem(0, [1], tmp_path, tmp_path / "out", ".jpg")
    maps = np.ones((H, W), np.float32)
    driver.persist_view_results(
        problem, tcfg.build_schedule(W, "General")[0], maps,
        np.zeros((H, W, 3), np.float32), maps.astype(np.uint8),
        maps.astype(np.uint8), 0.5, 2.0, True, MemoryCache(),
        write_files=False)


def _build(tmp_path, monkeypatch):
    """A kernel library's build where no nvcc is found: the span closes
    on the error."""
    def no_nvcc():
        raise RuntimeError("no nvcc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="no nvcc"):
        build.build("apde_sampler", ("sampler.cu",))


@pytest.mark.parametrize("name,call", [
    (spans.LOAD_VIEW, lambda tmp, mp: _load_view(tmp)),
    (spans.PERSIST, lambda tmp, mp: _persist(tmp)),
    (spans.BUILD, _build)], ids=["load_view", "persist", "build"])
def test_engine_spans(tmp_path, monkeypatch, name, call):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        call(tmp_path, monkeypatch)
    names = [e.name for e in prof.events()]
    assert names.count(name) == 1
    assert not set(names) & set(spans.STEP)
