"""What decides `correct` has teeth: the control (the reference in
bfloat16) and the faults a view pass can have come out not correct, at a
test's size on the CPU. Also the frozen K3 count against the port's, and
the traced run's refusal of a trace that lost a launch."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from mvsbench import judge, k3_count, manifest, program, run, scan, scene, \
    trace
from mvsbench.reference import pass_ref

from .conftest import TINY_CELL

SEED = 2**31 + 11
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("bench")
    cfg = dict(manifest.load(Path(__file__).parent / "tiny.json"))
    traffic = manifest.load(manifest.REPO / "mvsbench" / "traffic"
                            / "final_geom_weak31.json")
    sc = scene.make_scene(cfg, traffic["weak_share"], SEED, CPU)
    raw = scan.write_scan(root / "scan", sc, traffic, SEED, cfg["sources"])
    return cfg, traffic, raw


def test_control_is_not_correct(tiny):
    """The reference with its planes and costs in bfloat16 against the
    reference: every number fails its limit but the weak classes'."""
    cfg, traffic, raw = tiny
    spec = pass_ref.schedule_pass(cfg, traffic)
    want = pass_ref.run_pass(raw, 1, spec, 12345, CPU)
    again = pass_ref.run_pass(raw, 1, spec, 12345, CPU)
    low = pass_ref.run_pass(raw, 1, spec, 12345, CPU, lower=True)
    assert judge.verdict([judge.compare(again, want)])[0]
    correct, failed, compared = judge.verdict([judge.compare(low, want)])
    assert not correct and failed == 1
    for name in ("depth_off_pct", "normal_off_pct", "cost_off_pct"):
        assert compared[name]["value"] > 3 * compared[name]["limit"]


def _run_broken(tiny_manifest, monkeypatch, breaking):
    """A whole run of the added cell with the program's view pass broken
    underneath by ``breaking(outputs, priors) -> outputs``."""
    inner = program.run_patchmatch

    def broken(data, params, **kw):
        out = inner(data, params, **kw)
        return breaking(out, kw)
    monkeypatch.setattr(program, "run_patchmatch", broken)
    cell = manifest.cell(tiny_manifest, TINY_CELL)
    result, _ = run.run_cell(cell, SEED, 0.1, False, CPU)
    return result


def _unchanged(out, kw):
    """A pass that returns its state unchanged: the priors."""
    return out._replace(depth=kw["prior_depth"].copy(),
                        normal=kw["prior_normal"].copy(),
                        weak=kw["prior_weak"].astype(np.uint8),
                        confidence=kw["prior_confidence"].astype(np.uint8))


def _half_left_out(out, kw):
    """Half of the image's rows left at their priors."""
    h = out.depth.shape[0] // 2
    depth, normal = out.depth.copy(), out.normal.copy()
    depth[h:] = kw["prior_depth"][h:]
    normal[h:] = kw["prior_normal"][h:]
    return out._replace(depth=depth, normal=normal)


def _altered(out, kw):
    """An answer altered where it is made: the depths one part in a
    million off."""
    return out._replace(depth=out.depth * np.float32(1 + 1e-6))


@pytest.mark.parametrize("breaking", [_unchanged, _half_left_out, _altered],
                         ids=["unchanged", "half_left_out", "altered"])
def test_a_broken_pass_is_not_correct(tiny_manifest, monkeypatch, breaking):
    result = _run_broken(tiny_manifest, monkeypatch, breaking)
    assert result["correct"] is False
    assert result["failed"] == 1


def test_k3_count_equals_the_ports(tiny):
    """The frozen count against `chip_smoke.k3_bound` on a colour of the
    tiny view, with and without SA windows and the commit."""
    import chip_smoke
    from apde_mvs_tpu_torch.ops.propagation import checkerboard_candidates
    cfg, traffic, raw = tiny
    spec = program.schedule_pass(cfg, traffic)
    prog = program.Program.load(raw, spec, CPU)
    data = prog.views[0].data
    gen = torch.Generator().manual_seed(5)
    h, w, s = data.height, data.width, data.num_src
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    black = ((xs + ys) % 2 == 0)
    x = xs[black].to(torch.int32)
    y = ys[black].to(torch.int32)
    vw = torch.rand((x.numel(), s), generator=gen)
    vw[vw < 0.4] = 0.0
    out = type("Out", (), {"view_weights": vw})()
    for use_sa in (False, True):
        for commit in (False, True):
            kw = dict(radius=5, increment=2, use_sa=use_sa, geom=True,
                      row_bounds=None)
            costs = torch.rand((h, w), generator=gen)
            _, _, flags = checkerboard_candidates(costs, x, y, None)
            want_ms = chip_smoke.k3_bound(data, x, y, kw, flags, out,
                                          commit=commit)[0]
            got = k3_count.bound_seconds(data, x, y, kw, vw, commit)
            assert float(got) * 1e3 == pytest.approx(want_ms, rel=1e-12)


def _events(k3_launches: int, k3_records: int, counted: int = 0):
    """A chrome trace's events: the window range, K3 and a torch kernel,
    and a counting range whose kernel counts for no metric."""
    ev = [{"ph": "X", "cat": cat, "name": trace.WINDOW_RANGE, "ts": 0.0,
           "dur": 1000.0, "tid": 1}
          for cat in ("user_annotation", "gpu_user_annotation")]
    t = 10.0
    for i in range(k3_records):
        ev.append({"ph": "X", "cat": "kernel", "name": "void strong_kernel"
                   "<true, 10>(Params)", "ts": t, "dur": 100.0,
                   "args": {"correlation": 100 + i}})
        t += 150.0
    ev.append({"ph": "X", "cat": "kernel", "name": "void at::native::"
               "elementwise_kernel<128, 2>(int)", "ts": t, "dur": 50.0,
               "args": {"correlation": 1}})
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::copy_",
               "ts": t + 60.0, "dur": 200.0, "tid": 1})
    for i in range(counted):
        ev += [{"ph": "X", "cat": "user_annotation", "name":
                trace.COUNT_RANGE, "ts": 900.0, "dur": 20.0, "tid": 1},
               {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": 905.0, "dur": 2.0, "tid": 1,
                "args": {"correlation": 500 + i}},
               {"ph": "X", "cat": "kernel", "name": "reduce_kernel",
                "ts": 950.0, "dur": 5.0, "args": {"correlation": 500 + i}}]
    launched = {k: 0 for k in program.KERNELS}
    launched["K3"] = k3_launches
    return ev, launched


def test_trace_reduction():
    ev, launched = _events(2, 2, counted=1)
    rec = trace.reduce_events(ev, 2, 5, launched, 2, 1e-4)
    assert [k for k, _, _ in rec.kernels] == ["K3", "K3", ""]
    assert rec.busy_s == pytest.approx(250e-6)
    # the counting range (20 us) and its kernel (5 us) ran alone: cut out
    assert rec.counting_s == pytest.approx(25e-6)
    assert rec.window_s == pytest.approx(1e-3 - 25e-6)
    assert rec.idle_gaps[0][0] in ("aten::copy_", "host (no op)")
    roof = manifest.reader(manifest.REPO, "k3.roofline_pct").read(rec)
    assert roof == pytest.approx(100 * 1e-4 / 200e-6)


def test_counting_is_cut_only_where_it_ran_alone():
    """A counting span over a kernel of the pass cuts only its idle part."""
    gaps = [(0.0, 10.0), (20.0, 30.0), (40.0, 50.0)]
    cut = trace._union([(5.0, 25.0), (45.0, 60.0), (8.0, 9.0)])
    assert trace._minus(gaps, cut) == [(0.0, 5.0), (25.0, 30.0),
                                       (40.0, 45.0)]


@pytest.mark.parametrize("k3_launches,k3_records,seen", [
    (3, 2, 3), (2, 2, 3)], ids=["counter", "captured"])
def test_trace_that_lost_a_launch_fails(k3_launches, k3_records, seen):
    ev, launched = _events(k3_launches, k3_records)
    with pytest.raises(trace.TraceError):
        trace.reduce_events(ev, 1, 0, launched, seen, 0.0)

