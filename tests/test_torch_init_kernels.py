"""The initial cost's kernels (K2's stage form, ops/cuda/ncc.py; K6's
re-score form, ops/cuda/weak.py; the selection K11, ops/cuda/select.py)
around ``init.initial_cost``: the stage's calls (one of each form, one
re-score a WEAK_CHUNK, and none of the torch-op window, reference side or
selection it replaced), the wrappers' refusals, the layouts and the tile
route's compact blocks on the CPU, the profiler's wrapping; and, on a
card, each kernel against its plain version bit for bit and the stage's
launches.

Cases run on the 24x32 synthetic scene with 4 source views of
tests/test_torch_weak.py (every other pixel weak, seeded anchors and
selections, SA segment ids or none, u8 or f32 tables). No JAX: on a machine
with a card the file runs with ``--noconftest``:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_init_kernels.py
"""

import numpy as np
import pytest
import torch

from apde_mvs_tpu_torch.config import PatchMatchParams
from apde_mvs_tpu_torch.ops import cost as tcost
from apde_mvs_tpu_torch.ops import deformable as tdef
from apde_mvs_tpu_torch.ops import init as tinit
from apde_mvs_tpu_torch.ops.cuda import ncc as k2
from apde_mvs_tpu_torch.ops.cuda import select as k11
from apde_mvs_tpu_torch.ops.cuda import weak as k6
from apde_mvs_tpu_torch.ops.cuda import weak_sweep as k7
from apde_mvs_tpu_torch.testing.kernel_cases import cycled_views
from test_torch_weak import H, W, _case, _sweep_state

# one intra-op thread per test worker process (see tests/test_torch_cost.py)
torch.set_num_threads(1)

S = 4


def _params(sa: bool) -> PatchMatchParams:
    return PatchMatchParams(use_sa=sa)


def _rescore_kw(params) -> dict:
    return dict(strong_radius=params.strong_radius,
                strong_increment=params.strong_increment,
                weak_radius=params.weak_radius,
                weak_increment=params.weak_increment, use_sa=params.use_sa)


def _setup(name: str = "sa-u8", device="cpu"):
    c = _case(name, device)
    state = _sweep_state(c) if device == "cpu" else None
    if state is None:
        cpu = _case(name)
        state = _sweep_state(cpu)
        state = type(state)(**{k: getattr(state, k).to(device)
                               for k in state.__dataclass_fields__})
    state = state.replace(selected=c.selected.contiguous())
    return c, state, _params("sa" in name)


def _fail(*a, **kw):
    pytest.fail("the initial cost reached a step it no longer runs")


# ---------------------------------------------------------------------------
# The stage on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weak", [False, True])
def test_initial_cost_makes_one_call_of_each_stage_form(weak, monkeypatch):
    """One call of K2's stage form (the image's pixels, CHUNK of them at a
    time on the CPU: one here), one of K6's re-score form a WEAK_CHUNK, one
    of K11; neither the torch-op window (`cost.precompute_ref_window`) nor
    the reference side (`deformable.WeakRefData.build`) nor K2's and K6's
    sweep forms."""
    c, state, params = _setup()
    calls = []

    def counted(mod, name):
        fn = getattr(mod, name)

        def run(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, run)
    for mod, name in ((k2, "init_stage_fused"), (k6, "rescore_fused"),
                      (k11, "select_fused")):
        counted(mod, name)
    monkeypatch.setattr(tcost, "precompute_ref_window", _fail)
    monkeypatch.setattr(tdef.WeakRefData, "build", _fail)
    monkeypatch.setattr(k2, "ncc_strong_fused", _fail)
    monkeypatch.setattr(k6, "weak_fused", _fail)
    monkeypatch.setattr(tinit, "WEAK_CHUNK", 100)
    args = (c.x, c.y, c.anchors) if weak else ()
    out = tinit.initial_cost(c.data, state, params, *args)
    n = -(-c.x.numel() // 100) if weak else 0
    assert calls == ["init_stage_fused"] + ["rescore_fused"] * n \
        + ["select_fused"]
    assert out.costs.shape == (H, W) and out.selected.shape == (H, W, S)
    # fresh maps: the prior selections the re-score read are untouched
    assert out.selected is not state.selected


@pytest.mark.parametrize("view_major", [False, True])
def test_stage_forms_write_either_layout(view_major):
    """K2's stage form and K6's re-score form write the same costs into a
    view-major (S, n) or a pixel-major (n, S) block, whole or a range at a
    column offset, and K11 reads either."""
    c, state, params = _setup()
    n = H * W
    want = k2.init_stage_plain(c.data, state.planes, 0, n, 5, 2, True)
    out = torch.full((S, n) if view_major else (n, S), -1.0)
    for lo in range(0, n, 100):
        k2.init_stage_fused(c.data, state.planes, lo, min(lo + 100, n), out,
                            radius=5, increment=2, use_sa=True,
                            view_major=view_major, col0=0)
    got = out.T if view_major else out
    assert torch.equal(got, want)
    # a range at its own offset
    part = torch.empty((S, 70) if view_major else (70, S))
    k2.init_stage_fused(c.data, state.planes, 130, 200, part, radius=5,
                        increment=2, use_sa=True, view_major=view_major)
    assert torch.equal(part.T if view_major else part, want[130:200])
    # the re-score: scattered into the pixels' columns, or compact
    kw = _rescore_kw(params)
    wc = k6.rescore_plain(c.data, state.planes, state.selected, c.x, c.y,
                          c.anchors, **kw)
    k6.rescore_fused(c.data, state.planes, state.selected, c.x, c.y,
                     c.anchors, 0, c.x.numel(), out, view_major=view_major,
                     **kw)
    flat = c.y.long() * W + c.x.long()
    got = out.T if view_major else out
    assert torch.equal(got[flat], wc)
    keep = torch.ones(n, dtype=torch.bool)
    keep[flat] = False
    assert torch.equal(got[keep], want[keep])
    m = c.x.numel() - 50
    compact = torch.empty((S, m) if view_major else (m, S))
    k6.rescore_fused(c.data, state.planes, state.selected, c.x, c.y,
                     c.anchors, 50, c.x.numel(), compact,
                     view_major=view_major, col0=50, **kw)
    assert torch.equal(compact.T if view_major else compact, wc[50:])
    cost_map, sel = k11.select_fused(out, view_major, state.valid, 4)
    want_map, want_sel = k11.select_plain(got, state.valid, 4)
    assert torch.equal(cost_map, want_map) and torch.equal(sel, want_sel)


def test_rescore_plain_is_the_weak_sweeps_reference_side():
    """K6's re-score form and K7 build one reference side: the re-score's
    plain version is `weak.weak_ref_plain` (K7's, taken from weak.py)
    with `weak.weak_plain` on the pixel's own plane."""
    assert k7.weak_ref_plain is k6.weak_ref_plain
    c, state, params = _setup()
    kw = _rescore_kw(params)
    wref = k6.weak_ref_plain(c.data, c.x.float(), c.y.float(), c.anchors,
                             state.selected, kw["strong_radius"],
                             kw["strong_increment"], kw["weak_radius"],
                             kw["weak_increment"], True)
    own = state.planes[c.y.long(), c.x.long()][:, None].contiguous()
    want = k6.weak_plain(c.data, wref, own, kw["weak_radius"],
                         kw["weak_increment"], geom=False).ncc[:, 0]
    got = k6.rescore_plain(c.data, state.planes, state.selected, c.x, c.y,
                           c.anchors, **kw)
    assert torch.equal(got, want)


def _bad_stage(what, c, state):
    out = torch.empty((S, H * W))
    kw = dict(radius=5, increment=2, use_sa=False, view_major=True)
    if what == "stage out shape":
        k2.init_stage_fused(c.data, state.planes, 0, H * W,
                            torch.empty((H * W, S)), **kw)
    elif what == "stage out dtype":
        k2.init_stage_fused(c.data, state.planes, 0, H * W,
                            out.to(torch.float64), **kw)
    elif what == "stage planes":
        k2.init_stage_fused(c.data, state.planes.transpose(0, 1).contiguous(),
                            0, H * W, out, **kw)
    elif what == "stage planes strided":
        k2.init_stage_fused(
            c.data, torch.zeros((H, W, 8))[..., :4], 0, H * W, out, **kw)
    elif what == "stage range":
        k2.init_stage_fused(c.data, state.planes, 10, H * W + 1, out, **kw)
    elif what == "stage column":
        k2.init_stage_fused(c.data, state.planes, 10, 20, out, col0=11,
                            **kw)
    elif what == "stage SA window":
        k2.init_stage_fused(c.data, state.planes, 0, H * W, out, radius=4,
                            increment=2, use_sa=True, view_major=True)


def _bad_rescore(what, c, state):
    kw = dict(_rescore_kw(_params(True)), view_major=True)
    out = torch.empty((S, H * W))
    x, y, an = c.x, c.y, c.anchors
    n = x.numel()
    if what == "rescore x dtype":
        x = x.long()
    elif what == "rescore anchors shape":
        an = an[:, :8].contiguous()
    elif what == "rescore selected":
        state = state.replace(selected=state.selected.float())
    elif what == "rescore range":
        k6.rescore_fused(c.data, state.planes, state.selected, x, y, an, 5,
                         n + 1, out, **kw)
        return
    elif what == "rescore compact column":
        k6.rescore_fused(c.data, state.planes, state.selected, x, y, an, 5,
                         n, torch.empty((S, n)), col0=6, **kw)
        return
    elif what == "rescore scatter block":
        out = torch.empty((S, n))
    k6.rescore_fused(c.data, state.planes, state.selected, x, y, an, 0, n,
                     out, **kw)


def _bad_select(what, c, state):
    costs = torch.rand((S, H * W))
    valid = state.valid
    top_k = 4
    view_major = True
    if what == "select valid":
        valid = valid.float()
    elif what == "select costs shape":
        costs = costs[:, :-1].contiguous()
    elif what == "select top_k":
        top_k = -1
    elif what == "select 33 views":
        costs = torch.rand((33, H * W))
    elif what == "select strided":
        costs = torch.rand((H * W, S)).T
    k11.select_fused(costs, view_major, valid, top_k)


BAD = {
    **{w: _bad_stage for w in (
        "stage out shape", "stage out dtype", "stage planes",
        "stage planes strided", "stage range", "stage column",
        "stage SA window")},
    **{w: _bad_rescore for w in (
        "rescore x dtype", "rescore anchors shape", "rescore selected",
        "rescore range", "rescore compact column", "rescore scatter block")},
    **{w: _bad_select for w in (
        "select valid", "select costs shape", "select top_k",
        "select 33 views", "select strided")},
}


@pytest.mark.parametrize("what", sorted(BAD))
def test_wrappers_reject_bad_arguments(what):
    c, state, _ = _setup()
    with pytest.raises((ValueError, TypeError)):
        BAD[what](what, c, state)


def test_profile_pass_times_the_stage_forms_and_restores_them():
    from apde_mvs_tpu_torch.tools import profile_pass as pp
    fns = ((k2, "init_stage_fused"), (k6, "rescore_fused"),
           (k11, "select_fused"))
    before = [getattr(m, a) for m, a in fns]
    with pp.stage_ranges({}):
        assert all(getattr(m, a) is not f for (m, a), f in zip(fns, before))
    assert [getattr(m, a) for m, a in fns] == before


def test_engine_line_reports_k11(capsys):
    """The engine's last line carries K11's launches, as chip_smoke.py
    parses them from a subprocess's log."""
    import chip_smoke
    from apde_mvs_tpu_torch.pipeline import driver
    k11.reset_launches()
    k11.launches = 5
    try:
        driver.print_launches("")
    finally:
        k11.reset_launches()
    (m,) = chip_smoke.LAUNCH_RE.findall(capsys.readouterr().out)
    assert chip_smoke.parsed_counts(m)["k11"] == 5


# ---------------------------------------------------------------------------
# The kernels on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("K2's stage form, K6's re-score form and K11 are CUDA "
                    "kernels; no CUDA device here")
    return torch.device("cuda")


def _bits(a):
    return a.contiguous().view(torch.int32)


CARD_CASES = ("u8", "sa-u8", "f32", "sa-f32", "sa-u8-s32", "u8-s1",
              "u8-taps25")


def _card(name, device):
    c, state, params = _setup(name.replace("-s32", "").replace("-s1", "")
                              .replace("-taps25", ""), device)
    data, sel = c.data, state.selected
    if "s32" in name or "s1" in name:
        data, idx = cycled_views(data, 32 if "s32" in name else 1)
        sel = sel[..., idx].contiguous()
    state = state.replace(selected=sel, planes=state.planes.contiguous())
    if "taps25" in name:
        params = PatchMatchParams(use_sa=False, strong_radius=4,
                                  strong_increment=2, weak_radius=4,
                                  weak_increment=2)
    return c, data, state, params


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_CASES)
def test_stage_kernels_match_plain_on_card(cuda_device, name):
    c, data, state, params = _card(name, cuda_device)
    s, n = data.num_src, H * W
    r, inc, sa = params.strong_radius, params.strong_increment, \
        bool(params.use_sa)
    want = k2.init_stage_plain(data, state.planes, 0, n, r, inc, sa)
    for view_major in (True, False):
        out = torch.empty((s, n) if view_major else (n, s),
                          device=cuda_device)
        k2.init_stage_fused(data, state.planes, 0, n, out, radius=r,
                            increment=inc, use_sa=sa, view_major=view_major)
        got = out.T if view_major else out
        assert torch.equal(_bits(got), _bits(want))
    # a tile rank's rows, pixel-major at its offset
    part = torch.empty((n - 7 * W, s), device=cuda_device)
    k2.init_stage_fused(data, state.planes, 7 * W, n, part, radius=r,
                        increment=inc, use_sa=sa, view_major=False)
    assert torch.equal(_bits(part), _bits(want[7 * W:]))
    kw = _rescore_kw(params)
    wc = k6.rescore_plain(data, state.planes, state.selected, c.x, c.y,
                          c.anchors, **kw)
    out = torch.empty((s, n), device=cuda_device)
    k2.init_stage_fused(data, state.planes, 0, n, out, radius=r,
                        increment=inc, use_sa=sa, view_major=True)
    k6.rescore_fused(data, state.planes, state.selected, c.x, c.y,
                     c.anchors, 0, c.x.numel(), out, view_major=True, **kw)
    flat = c.y.long() * W + c.x.long()
    assert torch.equal(_bits(out.T[flat]), _bits(wc))
    compact = torch.empty((c.x.numel() - 3, s), device=cuda_device)
    k6.rescore_fused(data, state.planes, state.selected, c.x, c.y,
                     c.anchors, 3, c.x.numel(), compact, view_major=False,
                     col0=3, **kw)
    assert torch.equal(_bits(compact), _bits(wc[3:]))
    full = want.clone()
    full[flat] = wc
    cost_map, sel = k11.select_fused(out, True, state.valid, 4)
    want_map, want_sel = k11.select_plain(full, state.valid, 4)
    assert torch.equal(_bits(cost_map), _bits(want_map))
    assert torch.equal(sel, want_sel)


@pytest.mark.cuda
def test_k11_matches_plain_on_crafted_rows_on_card(cuda_device):
    rng = np.random.default_rng(3)
    c = rng.uniform(0, 2.0, (H * W, S)).astype(np.float32)
    c[:60] = 2.0
    c[60:120, 1] = c[60:120, 0]
    c[120:180, 2:] = 2.0
    c[180:240, 1:] = 2.0
    c[240:300, ::2] = np.nan
    c[300:360, 0] = -0.0
    c[300:360, 1] = 0.0
    c[360:420, 0] = -np.inf
    c[420:480, 1] = np.inf
    c[480:540, ::3] = 3.0
    c[540:700] = (np.round(rng.uniform(0, 2.0, (160, S)) * 4) / 4)
    costs = torch.as_tensor(c, device=cuda_device)
    valid = torch.as_tensor(rng.random((H, W)) < 0.9, device=cuda_device)
    for top_k in (0, 1, 4):
        want_map, want_sel = k11.select_plain(costs, valid, top_k)
        for view_major, block in ((False, costs),
                                  (True, costs.T.contiguous())):
            got_map, got_sel = k11.select_fused(block, view_major, valid,
                                                top_k)
            assert torch.equal(_bits(got_map), _bits(want_map))
            assert torch.equal(got_sel, want_sel)


@pytest.mark.cuda
@pytest.mark.parametrize("sa", [False, True])
def test_initial_cost_launches_each_form_once_on_card(cuda_device, sa):
    """On the card the stage is one launch of K2's stage form, one K6
    launch a WEAK_CHUNK and one K11 launch, and equals its plain versions
    run on the same tensors."""
    c, data, state, params = _card("sa-u8" if sa else "u8", cuda_device)
    k2.reset_launches()
    k6.reset_launches()
    k11.reset_launches()
    out = tinit.initial_cost(data, state, params, c.x, c.y, c.anchors)
    assert (k2.site_launches, k6.launches, k11.launches) == (
        {"init": 1}, -(-c.x.numel() // tinit.WEAK_CHUNK), 1)
    n = H * W
    full = k2.init_stage_plain(data, state.planes, 0, n, 5, 2, sa)
    full[c.y.long() * W + c.x.long()] = k6.rescore_plain(
        data, state.planes, state.selected, c.x, c.y, c.anchors,
        **_rescore_kw(params))
    want_map, want_sel = k11.select_plain(full, state.valid, params.top_k)
    assert torch.equal(_bits(out.costs), _bits(want_map))
    assert torch.equal(out.selected, want_sel)
