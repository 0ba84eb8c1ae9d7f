"""The initial cost's kernels (K2's stage form, ops/cuda/ncc.py; K6's
re-score form, ops/cuda/weak.py; the selection K11, ops/cuda/select.py)
around ``init.initial_cost``: the stage's calls (on the serial route one
call of K2's stage form with the selection in its epilogue and one of K6's
re-score form with it a WEAK_CHUNK, no K11, and none of the torch-op
window, reference side or selection it replaced), the selection modes'
writes against their compositions (K11's plain selection of the cost-out
modes' plain costs), the tile route against the serial route, the
wrappers' refusals, the layouts and the tile route's compact blocks on the
CPU, the profiler's wrapping; and, on a card, each kernel against its plain
version bit for bit and the stage's launches.

Cases run on the 24x32 synthetic scene with 4 source views of
tests/test_torch_weak.py (every other pixel weak, seeded anchors and
selections, SA segment ids or none, u8 or f32 tables), its views cycled to
1, 5, 10 and 32 where a test says so. No JAX: on a machine with a card the
file runs with ``--noconftest``:

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
from apde_mvs_tpu_torch.parallel.tile_pass import RowShard
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
    """On the serial route one call of K2's stage form with the selection
    in its epilogue (the image's pixels, CHUNK of them at a time on the
    CPU: one here) and one of K6's re-score form with it a WEAK_CHUNK; no
    selection call (K11), no cost-out mode (the tile route's), neither the
    torch-op window (`cost.precompute_ref_window`) nor the reference side
    (`deformable.WeakRefData.build`) nor K2's and K6's sweep forms."""
    c, state, params = _setup()
    calls = []

    def counted(mod, name):
        fn = getattr(mod, name)

        def run(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, run)
    for mod, name in ((k2, "init_stage_select_fused"),
                      (k6, "rescore_select_fused")):
        counted(mod, name)
    monkeypatch.setattr(tcost, "precompute_ref_window", _fail)
    monkeypatch.setattr(tdef.WeakRefData, "build", _fail)
    monkeypatch.setattr(k2, "ncc_strong_fused", _fail)
    monkeypatch.setattr(k6, "weak_fused", _fail)
    monkeypatch.setattr(k2, "init_stage_fused", _fail)
    monkeypatch.setattr(k6, "rescore_fused", _fail)
    monkeypatch.setattr(k11, "select_fused", _fail)
    monkeypatch.setattr(tinit, "WEAK_CHUNK", 100)
    args = (c.x, c.y, c.anchors) if weak else ()
    out = tinit.initial_cost(c.data, state, params, *args)
    n = -(-c.x.numel() // 100) if weak else 0
    assert calls == ["init_stage_select_fused"] \
        + ["rescore_select_fused"] * n
    assert out.costs.shape == (H, W) and out.selected.shape == (H, W, S)
    # fresh maps: the prior selections the re-score read are untouched
    assert out.selected is not state.selected


def _views(name: str, views: int):
    """The case ``name`` with its 4 source views cycled to ``views``, the
    prior selections cycled alike; a padded image's invalid border (its
    last 3 rows and 5 columns) where ``name`` has "pad", NaN and
    degenerate (w = 0) planes among the others where it has "nan"."""
    c, state, params = _setup(name.replace("-pad", "").replace("-nan", ""))
    data, sel = c.data, state.selected
    if views != S:
        data, idx = cycled_views(data, views)
        sel = sel[..., idx].contiguous()
    planes = state.planes.clone()
    valid = state.valid.clone()
    if "pad" in name:
        valid[-3:] = False
        valid[:, -5:] = False
    if "nan" in name:
        planes.view(-1, 4)[0::13, 3] = 0.0
        planes.view(-1, 4)[1::17] = float("nan")
    state = state.replace(selected=sel, planes=planes, valid=valid)
    return c, data, state, params


SELECT_CASES = [f"{v}-{n}" for v in (1, 5, 10, 32)
                for n in ("sa-u8", "u8-pad", "sa-f32-nan")]


@pytest.mark.parametrize("case", SELECT_CASES)
def test_stage_selection_is_k11_of_the_stage_costs(case):
    """K2's stage form with the selection (`init_stage_select_fused`) on
    pixel ranges of 100 (a ragged last one) writes, at exactly those
    pixels of the state's new maps, K11's plain selection of the cost-out
    mode's plain costs, bit for bit: at 1, 5, 10 and 32 views, on a padded
    image's invalid border and with NaN and degenerate planes."""
    views, name = case.split("-", 1)
    c, data, state, params = _views(name, int(views))
    sa = "sa" in name
    n = H * W
    want_map, want_sel = k11.select_plain(
        k2.init_stage_plain(data, state.planes, 0, n, 5, 2, sa),
        state.valid, params.top_k)
    cost_map = torch.full((H, W), -1.0)
    sel = torch.zeros((H, W, int(views)), dtype=torch.bool)
    for lo in range(0, n - 130, 100):
        k2.init_stage_select_fused(data, state.planes, lo, lo + 100,
                                   state.valid, params.top_k, cost_map, sel,
                                   radius=5, increment=2, use_sa=sa)
    done = (n - 130 + 99) // 100 * 100
    assert torch.equal(_bits(cost_map).view(-1)[:done],
                       _bits(want_map).view(-1)[:done])
    assert (cost_map.view(-1)[done:] == -1.0).all()
    assert torch.equal(sel.view(n, -1)[:done], want_sel.view(n, -1)[:done])
    assert not sel.view(n, -1)[done:].any()
    k2.init_stage_select_fused(data, state.planes, done, n, state.valid,
                               params.top_k, cost_map, sel, radius=5,
                               increment=2, use_sa=sa)
    assert torch.equal(_bits(cost_map), _bits(want_map))
    assert torch.equal(sel, want_sel)
    if "pad" in name:
        assert (cost_map[~state.valid] == k11.INVALID_COST).all()
        assert not sel[~state.valid].any()


@pytest.mark.parametrize("case", SELECT_CASES)
def test_rescore_selection_is_k11_of_the_rescore_costs(case):
    """K6's re-score form with the selection (`rescore_select_fused`) on
    list chunks of 50 (a ragged last one) writes, at exactly the weak
    pixels of the state's new maps, K11's plain selection of the cost-out
    mode's plain costs, bit for bit, and leaves the prior selections it
    reads as they were."""
    views, name = case.split("-", 1)
    c, data, state, params = _views(name, int(views))
    kw = _rescore_kw(params)
    prior = state.selected.clone()
    costs = k6.rescore_plain(data, state.planes, state.selected, c.x, c.y,
                             c.anchors, **kw)
    flat = c.y.long() * W + c.x.long()
    want_cost, want_sel = k11.select_rows_plain(
        costs, state.valid.view(-1)[flat], params.top_k)
    cost_map = torch.full((H, W), -1.0)
    sel = torch.zeros((H, W, int(views)), dtype=torch.bool)
    m = c.x.numel()
    for lo in range(0, m, 50):
        k6.rescore_select_fused(data, state.planes, state.selected, c.x,
                                c.y, c.anchors, lo, min(lo + 50, m),
                                state.valid, params.top_k, cost_map, sel,
                                **kw)
    assert torch.equal(_bits(cost_map.view(-1)[flat]), _bits(want_cost))
    assert torch.equal(sel.view(H * W, -1)[flat], want_sel)
    rest = torch.ones(H * W, dtype=torch.bool)
    rest[flat] = False
    assert (cost_map.view(-1)[rest] == -1.0).all()
    assert not sel.view(H * W, -1)[rest].any()
    assert torch.equal(state.selected, prior)
    # the whole stage: the composition of the cost-out modes and K11
    full = k2.init_stage_plain(data, state.planes, 0, H * W, 5, 2,
                               bool(params.use_sa))
    full[flat] = costs
    want_map, want_all = k11.select_plain(full, state.valid, params.top_k)
    out = tinit.initial_cost(data, state, params, c.x, c.y, c.anchors)
    assert torch.equal(_bits(out.costs), _bits(want_map))
    assert torch.equal(out.selected, want_all)


class _Recorded(RowShard):
    """A rank of a row-sharded pass run alone: its gathers record its part
    in ``parts`` (by call) and return it zero-padded to the whole."""

    def __init__(self, rank, world, parts):
        super().__init__(rank, world)
        self.parts, self.calls = parts, 0

    def gather(self, t, counts):
        self.parts.setdefault(self.calls, {})[self.rank] = t.clone()
        self.calls += 1
        return torch.zeros((sum(counts),) + tuple(t.shape[1:]),
                           dtype=t.dtype)


class _Replayed(RowShard):
    """A rank whose gathers join every rank's recorded parts, in rank
    order: the all-gather of ``distributed.all_gather_parts``."""

    def __init__(self, rank, world, parts):
        super().__init__(rank, world)
        self.parts, self.calls = parts, 0

    def gather(self, t, counts):
        got = self.parts[self.calls]
        self.calls += 1
        assert torch.equal(got[self.rank], t)
        return torch.cat([got[r] for r in range(self.world)])


@pytest.mark.parametrize("name", ["sa-u8", "u8"])
@pytest.mark.parametrize("world", [1, 3])
def test_tile_route_equals_serial_route(name, world):
    """The tile route's initial cost (the cost-out modes on a rank's rows
    and slice of the weak list, the gather, the re-scored costs placed,
    K11 on the whole image) equals the serial route's (the selection
    modes), bit for bit, on one rank and on each of three."""
    c, state, params = _setup(name)
    args = (c.x, c.y, c.anchors)
    serial = tinit.initial_cost(c.data, state, params, *args)
    parts = {}
    for rank in range(world):
        tinit.initial_cost(c.data, state, params, *args,
                           shard=_Recorded(rank, world, parts))
    for rank in range(world):
        tiled = tinit.initial_cost(c.data, state, params, *args,
                                   shard=_Replayed(rank, world, parts))
        assert torch.equal(_bits(tiled.costs), _bits(serial.costs))
        assert torch.equal(tiled.selected, serial.selected)


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


@pytest.mark.parametrize("views,before", [(1, 1.0), (4, 1.0), (5, 1.5),
                                          (8, 1.0), (10, 2.0), (32, 4.0)])
def test_stage_form_builds_each_window_once(views, before):
    """The windows K2's stage form builds a pixel, counted from its grid: a
    block owning all S views of whole groups builds each once, where a
    block of 8 consecutive (group, view) pairs built every window of the
    groups its pairs span (600x800; a ragged image too)."""
    n = 600 * 800
    assert k2.window_builds(n, views) == pytest.approx(before)
    g = k2.stage_groups(views)
    assert g == (2 if views >= 16 else 4)
    for pixels in (n, 1000, 31):
        assert k2.window_builds(pixels, views, g) == 1.0
    assert k2.window_builds(1000, 10) > 1.0


@pytest.mark.parametrize("windows,sa", [((5, 2, 5, 5), True),
                                        ((5, 2, 5, 5), False),
                                        ((4, 2, 4, 2), False)])
def test_rescore_plan_fits_every_view_count(windows, sa):
    """The re-score form's host-side plan (csrc/weak.cu's layout, the
    library's own numbers held against it on the card): a warp's G pixels
    fill its lanes with their S views (at most 8 pixels), a block takes 4
    G, and its shared memory stays within Hopper's 227 KB at every S = 1 ..
    32, for the main windows (SA and square) and another square."""
    t, ta = (len(tcost.square_taps(r, i))
             for r, i in (windows[:2], windows[2:]))
    side = (t + 8 * ta) * (2 if sa else 1) + 64
    for views in range(1, k6.MAX_VIEWS + 1):
        g = k6.rescore_pixels(views)
        assert g == min(32 // views, 8) and 1 <= g * views <= 32
        smem = k6.rescore_smem_bytes(views, windows, sa)
        assert smem == 4 * ((views + 1) * k6.CAM_STRIDE + 2 * (t + ta)
                            + 4 * (g * side + 8 * 32) + 15 * 4 * g + 1)
        assert smem <= k6.SMEM_LIMIT
    # fewer views, more pixels a warp: the most shared memory at S <= 4
    assert max(k6.rescore_smem_bytes(v, windows, sa) for v in range(1, 33)) \
        == k6.rescore_smem_bytes(4, windows, sa)


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


def _bad_select_modes(what, c, state):
    kw = _rescore_kw(_params(True))
    cost_map = torch.empty((H, W))
    sel = torch.empty((H, W, S), dtype=torch.bool)
    valid, top_k = state.valid, 4
    n = c.x.numel()
    if what == "stage select valid":
        valid = valid.float()
    elif what == "stage select top_k":
        top_k = -1
    elif what == "stage select cost map":
        cost_map = torch.empty((H * W,))
    elif what == "stage select selections":
        sel = torch.empty((H, W, S + 1), dtype=torch.bool)
    elif what == "stage select strided":
        sel = torch.empty((W, H, S), dtype=torch.bool).transpose(0, 1)
    elif what == "stage select range":
        k2.init_stage_select_fused(c.data, state.planes, 0, H * W + 1,
                                   valid, top_k, cost_map, sel, radius=5,
                                   increment=2, use_sa=True)
        return
    if what.startswith("stage"):
        k2.init_stage_select_fused(c.data, state.planes, 0, H * W, valid,
                                   top_k, cost_map, sel, radius=5,
                                   increment=2, use_sa=True)
        return
    prior = state.selected
    if what == "rescore select aliased":
        sel = prior
    elif what == "rescore select view":
        sel = prior.view(H, W, S)
    elif what == "rescore select valid":
        valid = valid[:, :-1]
    elif what == "rescore select top_k":
        top_k = -2
    elif what == "rescore select cost map":
        cost_map = cost_map.double()
    k6.rescore_select_fused(c.data, state.planes, prior, c.x, c.y,
                            c.anchors, 0, n, valid, top_k, cost_map, sel,
                            **kw)


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
    **{w: _bad_select_modes for w in (
        "stage select valid", "stage select top_k", "stage select cost map",
        "stage select selections", "stage select strided",
        "stage select range", "rescore select aliased",
        "rescore select view", "rescore select valid",
        "rescore select top_k", "rescore select cost map")},
}


@pytest.mark.parametrize("what", sorted(BAD))
def test_wrappers_reject_bad_arguments(what):
    c, state, _ = _setup()
    with pytest.raises((ValueError, TypeError)):
        BAD[what](what, c, state)


def test_profile_pass_times_the_stage_forms_and_restores_them():
    from apde_mvs_tpu_torch.tools import profile_pass as pp
    fns = ((k2, "init_stage_fused"), (k6, "rescore_fused"),
           (k11, "select_fused"), (k2, "init_stage_select_fused"),
           (k6, "rescore_select_fused"))
    before = [getattr(m, a) for m, a in fns]
    with pp.timed_kernels({}):
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


def _crafted_list(c, state, views: int):
    """The case's weak list with crafted anchors, cut to a length that is
    a multiple neither of a warp's G pixels (but at G = 1) nor of a block's
    4 G: rows with every anchor missing (-1), rows with an x or a y of -1,
    anchors on the image's border whose warps leave it in some views and
    whose prior selections hold every view (they count at COST_MAX where
    they leave), anchors beyond the grid (no selections, clamped taps),
    the rest the case's (under SA some in another segment: existing but
    not valid). Returns (x, y, anchors, the prior selections)."""
    an = c.anchors.clone()
    an[0::11, 1:] = -1
    an[1::11, 1:5, 0] = -1
    an[2::11, 1:5, 1] = -1
    rows = an[3::11]
    k = torch.arange(rows.shape[0], device=an.device)
    rows[:, 1, 0], rows[:, 1, 1] = W - 1, k % H
    rows[:, 2, 0], rows[:, 2, 1] = 0, (3 * k) % H
    rows[:, 3, 0], rows[:, 3, 1] = k % W, H - 1
    an[3::11] = rows
    an[4::11, 1] = torch.tensor([W + 2, 3], dtype=an.dtype)
    an[4::11, 2] = torch.tensor([5, H + 1], dtype=an.dtype)
    sel = state.selected.clone()
    sel[:, 0] = True
    sel[:, W - 1] = True
    sel[H - 1] = True
    g = k6.rescore_pixels(views)
    m = c.x.numel()
    m -= (m - (2 * g + 1)) % (4 * g)
    return c.x[:m], c.y[:m], an[:m].contiguous(), sel


def _card(name, device):
    parts = name.split("-")
    views = [int(p[1:]) for p in parts if p[0] == "s" and p[1:].isdigit()]
    c, state, params = _setup("-".join(
        p for p in parts if p != "taps25" and not (
            p[0] == "s" and p[1:].isdigit())), device)
    data, sel = c.data, state.selected
    if views and views[0] != S:
        data, idx = cycled_views(data, views[0])
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
    # the cost-out mode on the crafted weak list, scattered and compact
    x, y, an, prior = _crafted_list(c, state, s)
    m = x.numel()
    wc = k6.rescore_plain(data, state.planes, prior, x, y, an, **kw)
    assert (wc == tcost.COST_MAX).any() and (wc < tcost.COST_MAX).any()
    out = torch.full((s, n), -1.0, device=cuda_device)
    k6.rescore_fused(data, state.planes, prior, x, y, an, 0, m, out,
                     view_major=True, **kw)
    flat = y.long() * W + x.long()
    assert torch.equal(_bits(out.T[flat]), _bits(wc))
    rest = torch.ones(n, dtype=torch.bool, device=cuda_device)
    rest[flat] = False
    assert (out.T[rest] == -1.0).all()
    compact = torch.empty((m - 8, s), device=cuda_device)
    k6.rescore_fused(data, state.planes, prior, x, y, an, 5, m - 3,
                     compact, view_major=False, col0=5, **kw)
    assert torch.equal(_bits(compact), _bits(wc[5:m - 3]))


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
@pytest.mark.parametrize("views", [1, 5, 10, 32])
@pytest.mark.parametrize("name", ["u8", "sa-u8", "f32", "sa-f32"])
def test_selection_epilogues_match_plain_on_card(cuda_device, name, views):
    """K2's stage form and K6's re-score form with the selection in their
    epilogues against their plain versions, bit for bit, at 1, 5, 10 and
    32 views, square and SA, u8 and f32 tables; the stage form also on a
    ragged range at an offset (its selections' bytes not 16-byte
    aligned)."""
    c, data, state, params = _card(f"{name}-s{views}", cuda_device)
    s, n = data.num_src, H * W
    r, inc, sa = params.strong_radius, params.strong_increment, \
        bool(params.use_sa)
    valid = state.valid.clone()
    valid[-2:] = False
    top_k = params.top_k
    want_cost, want_sel = k2.init_stage_select_plain(
        data, state.planes, 0, n, valid, top_k, r, inc, sa)
    cost_map = torch.full((H, W), -1.0, device=cuda_device)
    sel = torch.zeros((H, W, s), dtype=torch.bool, device=cuda_device)
    k2.init_stage_select_fused(data, state.planes, 0, n, valid, top_k,
                               cost_map, sel, radius=r, increment=inc,
                               use_sa=sa)
    assert torch.equal(_bits(cost_map.view(-1)), _bits(want_cost))
    assert torch.equal(sel.view(n, s), want_sel)
    cost_map = torch.full((H, W), -1.0, device=cuda_device)
    sel = torch.zeros((H, W, s), dtype=torch.bool, device=cuda_device)
    k2.init_stage_select_fused(data, state.planes, 37, n - 11, valid, top_k,
                               cost_map, sel, radius=r, increment=inc,
                               use_sa=sa)
    assert torch.equal(_bits(cost_map.view(-1)[37:n - 11]),
                       _bits(want_cost[37:n - 11]))
    assert torch.equal(sel.view(n, s)[37:n - 11], want_sel[37:n - 11])
    assert (cost_map.view(-1)[:37] == -1).all() \
        and (cost_map.view(-1)[n - 11:] == -1).all()
    assert not sel.view(n, s)[:37].any() and not sel.view(n, s)[n - 11:].any()
    # K6's re-score form with the selection, over K2's maps
    kw = _rescore_kw(params)
    m = c.x.numel()
    wcost, wsel = k6.rescore_select_plain(data, state.planes, state.selected,
                                          c.x, c.y, c.anchors, valid, top_k,
                                          **kw)
    for lo, hi in ((0, m), (5, m - 3)):
        k6.rescore_select_fused(data, state.planes, state.selected, c.x, c.y,
                                c.anchors, lo, hi, valid, top_k, cost_map,
                                sel, **kw)
        flat = c.y[lo:hi].long() * W + c.x[lo:hi].long()
        assert torch.equal(_bits(cost_map.view(-1)[flat]),
                           _bits(wcost[lo:hi]))
        assert torch.equal(sel.view(n, s)[flat], wsel[lo:hi])
    # the crafted weak list: missing, invalid, border and off-grid anchors,
    # a length no multiple of a warp's or a block's pixels
    x, y, an, prior = _crafted_list(c, state, s)
    m = x.numel()
    wcost, wsel = k6.rescore_select_plain(data, state.planes, prior, x, y,
                                          an, valid, top_k, **kw)
    for lo, hi in ((0, m), (5, m - 3)):
        cost_map = torch.full((H, W), -1.0, device=cuda_device)
        sel = torch.zeros((H, W, s), dtype=torch.bool, device=cuda_device)
        k6.rescore_select_fused(data, state.planes, prior, x, y, an, lo, hi,
                                valid, top_k, cost_map, sel, **kw)
        flat = y[lo:hi].long() * W + x[lo:hi].long()
        assert torch.equal(_bits(cost_map.view(-1)[flat]),
                           _bits(wcost[lo:hi]))
        assert torch.equal(sel.view(n, s)[flat], wsel[lo:hi])
        rest = torch.ones(n, dtype=torch.bool, device=cuda_device)
        rest[flat] = False
        assert (cost_map.view(-1)[rest] == -1.0).all()
        assert not sel.view(n, s)[rest].any()


@pytest.mark.cuda
@pytest.mark.parametrize("sa", [False, True])
def test_rescore_plan_matches_the_library_on_card(cuda_device, sa):
    """The re-score form's host-side plan (`weak.rescore_smem_bytes`, which
    the wrapper refuses by) is the library's own layout at every view
    count, for the main windows and another square, and each main-window
    instantiation runs at least one block an SM."""
    lib = k6.library().lib
    for windows in ((5, 2, 5, 5), (4, 2, 4, 2)):
        for views in range(1, k6.MAX_VIEWS + 1):
            assert k6.rescore_smem_bytes(views, windows, sa) == \
                lib.apde_weak_rescore_smem_bytes(views, *windows, int(sa))
    for u8 in (True, False):
        for views in (1, 5, 10, 32):
            assert k6.rescore_kernel_info(u8, sa, views)["blocks_per_sm"] \
                >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("sa", [False, True])
def test_initial_cost_launches_each_form_once_on_card(cuda_device, sa):
    """On the card the stage is one launch of K2's stage form and one K6
    launch a WEAK_CHUNK, each with the selection in its epilogue, and no
    K11 launch (the tile route's), and equals its plain versions run on
    the same tensors."""
    c, data, state, params = _card("sa-u8" if sa else "u8", cuda_device)
    k2.reset_launches()
    k6.reset_launches()
    k11.reset_launches()
    out = tinit.initial_cost(data, state, params, c.x, c.y, c.anchors)
    assert (k2.site_launches, k6.launches, k11.launches) == (
        {"init": 1}, -(-c.x.numel() // tinit.WEAK_CHUNK), 0)
    n = H * W
    full = k2.init_stage_plain(data, state.planes, 0, n, 5, 2, sa)
    full[c.y.long() * W + c.x.long()] = k6.rescore_plain(
        data, state.planes, state.selected, c.x, c.y, c.anchors,
        **_rescore_kw(params))
    want_map, want_sel = k11.select_plain(full, state.valid, params.top_k)
    assert torch.equal(_bits(out.costs), _bits(want_map))
    assert torch.equal(out.selected, want_sel)
