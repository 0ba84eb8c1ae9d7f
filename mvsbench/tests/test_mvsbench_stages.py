"""The split of the traced window's idle time by the program's spans, on
synthetic chrome-trace events (those of `test_mvsbench_correct._events`,
with two steps' spans laid over them), and its readers."""

from __future__ import annotations

import pytest

from apde_mvs_tpu_torch.core import spans
from mvsbench import stages, trace

from .test_mvsbench_correct import _events

US = 1e-6


def _span(name, a, b, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": a,
            "dur": b - a, "tid": tid}


def _stepped(runs=((5.0, 400.0), (400.0, 980.0))):
    """`_events`' window (0-1000 us: busy 10-110, 160-260, 310-360; the
    count alone 900-920 and 950-955) with a step in each of ``runs``:
    the first's priors 5-12, sweeps 12-300 and outputs 300-400, the
    second's outputs 600-980."""
    ev, launched = _events(2, 2, counted=1)
    ev += [_span(spans.RUN, a, b) for a, b in runs]
    ev += [_span(spans.PRIORS, 5.0, 12.0), _span(spans.SWEEPS, 12.0, 300.0),
           _span(spans.STRONG_SWEEP, 100.0, 105.0),
           _span(spans.OUTPUTS, 300.0, 400.0),
           _span(spans.OUTPUTS, 600.0, 980.0)]
    return ev, launched


def test_idle_is_charged_to_the_innermost_span():
    """The idle time (busy and counting cut out) lies in the priors
    (5-10), the sweeps (110-160, 260-300), the outputs (300-310, 360-400,
    600-900, 920-950, 955-980), the second step's own span (400-600) and
    outside every step (0-5, 980-1000); a no-op gap inside the outputs is
    charged to them."""
    ev, _ = _stepped()
    split = stages.split_events(ev, 2, {"weak_pixels": 10})
    got = {k: pytest.approx(v / US) for k, v in split.idle_by_span.items()}
    assert got == {spans.PRIORS: 5.0, spans.SWEEPS: 90.0,
                   spans.OUTPUTS: 405.0, spans.RUN: 200.0,
                   stages.OUTSIDE: 25.0}
    assert split.ends_idle_s / US == pytest.approx(410.0)
    assert split.stages_idle_s / US == pytest.approx(290.0)
    assert split.outside_idle_s / US == pytest.approx(25.0)
    assert split.host_by_span[spans.OUTPUTS] / US == pytest.approx(480.0)
    assert stages.ends_idle_ms(split) == pytest.approx(0.205)
    assert stages.stages_idle_ms(split) == pytest.approx(0.145)


def test_the_parts_sum_to_the_windows_idle():
    """Ends, stages and outside sum to the idle time `trace` counts: the
    window less its busy time and the count's own."""
    ev, launched = _stepped()
    rec = trace.reduce_events(ev, 2, 0, launched, 2, 0.0)
    split = stages.split_events(ev, 2, {})
    parts = split.ends_idle_s + split.stages_idle_s + split.outside_idle_s
    assert parts == pytest.approx(split.idle_s, abs=1e-12)
    assert split.idle_s == pytest.approx(rec.window_s - rec.busy_s,
                                         abs=1e-12)
    # the midpoint rule names the gap's host op or span, not "no op"
    assert "host (no op)" not in dict(rec.idle_gaps)
    assert dict(rec.idle_gaps)[spans.OUTPUTS] > 0


@pytest.mark.parametrize("runs", [
    ((5.0, 400.0),), ((5.0, 400.0), (400.0, 900.0), (900.0, 980.0)),
    ((5.0, 400.0), (400.0, 980.0)), ()],
    ids=["missing", "extra", "other-thread", "none"])
def test_steps_not_matched_by_spans_fail(runs):
    ev, _ = _stepped(runs)
    if len(runs) == 2:      # the second step's span on another thread
        ev[-6]["tid"] = 2
    with pytest.raises(trace.TraceError):
        stages.split_events(ev, 2, {})


def test_no_split_for_a_program_without_spans(monkeypatch):
    ev, _ = _events(2, 2)
    monkeypatch.setattr(stages, "port_spans", None)
    assert stages.split_events(ev, 2, {}) is None
    assert stages.ends_idle_ms(None) is None
    assert stages.stages_idle_ms(None) is None


@pytest.mark.parametrize("steps,counts", [(0, {"weak_pixels": 5}),
                                          (2, {"weak_pixels": 0}),
                                          (2, {})],
                         ids=["no-steps", "no-weak-pixels", "no-counter"])
def test_readers_give_nothing_where_nothing_ran(steps, counts):
    split = stages.StageSplit(steps, 0.0, 0.0, 0.0, 0.0, {}, {}, counts)
    rec = trace.Records(steps, 1.0, 0.5, 0, [("K7", "weak_update_kernel",
                                              1e-3)], 0.0, [], [])
    if not steps:
        assert stages.ends_idle_ms(split) is None
        assert stages.stages_idle_ms(split) is None
    else:
        assert stages.weak_ns_per_pixel(rec, split) is None


def test_weak_path_ns_per_pixel():
    split = stages.StageSplit(2, 0.0, 0.0, 0.0, 0.0, {}, {},
                              {"weak_pixels": 1_000_000})
    rec = trace.Records(2, 1.0, 0.5, 0, [
        ("K7", "weak_update_kernel", 0.1), ("K3", "strong_kernel", 9.0),
        ("K8", "gen_anchors", 0.05)], 0.0, [], [])
    assert stages.weak_ns_per_pixel(rec, split) == pytest.approx(150.0)


def test_pass_counts_read_the_ports_counters(monkeypatch):
    from apde_mvs_tpu_torch.pipeline import full_pass
    monkeypatch.setattr(full_pass, "weak_pixels", 12)
    assert stages.pass_counts()["weak_pixels"] == 12
    assert set(stages.pass_counts()) == set(stages.COUNTERS)
    monkeypatch.delattr(full_pass, "refined_pixels")
    assert "refined_pixels" not in stages.pass_counts()
