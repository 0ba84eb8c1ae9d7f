"""The initial cost's stage (ops/init.py: K2's stage form, K6's re-score
form, the selection K11) on the CPU, where each form runs its plain
version: against the JAX package's ``initial_cost`` with the SA star window
and no weak list (u8 and f32), the selection against the JAX
``initial_cost_and_selection`` on crafted rows, one chunk of the plain
path against several, and the plain path against the torch-op composition
it replaced (``testing.init_composition``).

Costs to atol 1e-4 (float32 window sums taken in another order) and
selections exactly, as tests/test_torch_cost.py holds the square window,
but for the SA star test's cut windows (the per-view costs as
tests/test_torch_deformable.py holds few-tap windows, and the pixels whose
top-k decision sits on a float tie between the two sides, at most 0.5%);
the scene and planes are tests/test_torch_cost.py's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apde_mvs_tpu.config import PatchMatchParams
from apde_mvs_tpu.ops import cost as jcost
from apde_mvs_tpu.ops import init as jinit
from apde_mvs_tpu.ops.state import PMState as JState
from apde_mvs_tpu_torch import convert
from apde_mvs_tpu_torch.config import PatchMatchParams as TParams
from apde_mvs_tpu_torch.ops import cost as tcost
from apde_mvs_tpu_torch.ops import init as tinit
from apde_mvs_tpu_torch.ops.cuda import ncc as k2
from apde_mvs_tpu_torch.ops.cuda import select as k11
from apde_mvs_tpu_torch.testing.init_composition import init_composition
from test_torch_cost import H, V, W, _planes, _scene_data
from test_torch_propagation import _weak_setup

# one intra-op thread per test worker process (see tests/test_torch_cost.py)
torch.set_num_threads(1)

ATOL = 1e-4
LOOSE_SHARE, LOOSE_ATOL = 0.005, 1e-2
# pixels whose top-k decision may flip on a float tie (as
# tests/test_torch_propagation.py allows a sweep's)
MAX_TIES = 0.005


def _np(a):
    return a.detach().cpu().numpy()


def _states(jd, planes):
    js = JState.create(H, W, V - 1).replace(
        planes=jnp.asarray(planes.reshape(H, W, 4)))
    ts = convert.pm_state(**{k: getattr(js, k) for k in (
        "planes", "costs", "selected", "view_weights", "weak", "confidence",
        "valid")}, device="cpu")
    return js, ts


def _tie_pixels(jc: np.ndarray, tc: np.ndarray, top_k: int) -> np.ndarray:
    """(B,) pixels whose top-k decision sits on a float tie between two
    (B, S) per-view cost arrays that agree to ATOL: a view below COST_MAX on
    one side and not on the other, or the k-th smallest cost within ATOL
    of the next (the selection's threshold)."""
    flips = ((jc < tcost.COST_MAX) != (tc < tcost.COST_MAX)).any(-1)
    srt = np.sort(jc, -1)
    k = np.minimum((jc < tcost.COST_MAX).sum(-1), top_k)
    kth = np.take_along_axis(srt, np.clip(k - 1, 0, None)[:, None], -1)[:, 0]
    nxt = np.take_along_axis(srt, np.clip(k, None, jc.shape[1] - 1)[:, None],
                             -1)[:, 0]
    near = (k > 0) & (k < jc.shape[1]) & (np.abs(nxt - kth) < ATOL)
    return flips | near


@pytest.mark.parametrize("u8", [True, False])
def test_plain_initial_cost_matches_jax_with_the_sa_star(u8):
    """The SA star window cut at the segments' edges (a seeded mask of
    three segments), no weak list. The per-view costs to ATOL but at most
    LOOSE_SHARE of them, none beyond LOOSE_ATOL; the cost map to ATOL and
    the selections exactly, but at pixels with such a cost or whose top-k
    decision sits on a float tie between the two sides' per-view costs
    (`_tie_pixels`: a cost below COST_MAX on one side and not on the
    other, or the k-th smallest within ATOL of the next), at most
    MAX_TIES of the pixels. The torch-op composition the stage replaced
    (``testing.init_composition``) meets the same bar."""
    scene, jd, td = _scene_data(u8, sa_seed=5)
    x, y, planes = _planes(scene, jd, 6)
    params = PatchMatchParams(use_sa=True)
    js, ts = _states(jd, planes)
    jout = jinit.initial_cost(jd, js, params, use_apd=False)
    tout = tinit.initial_cost(td, ts, TParams(use_sa=True))
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    jc = np.asarray(jcost.ncc_strong(
        jd, jx, jy, jnp.asarray(planes),
        jcost.precompute_ref_window(jd, jx, jy, 5, 2, True)))
    tc = _np(k2.init_stage_plain(td, ts.planes, 0, H * W, 5, 2, True))
    # the per-view costs as tests/test_torch_deformable.py holds few-tap
    # windows (the float32 NCC of a cut star is noise of the order of its
    # sums where its variance nears MIN_VAR: ROADMAP Queue 3)
    far = np.abs(tc - jc) > ATOL
    assert far.mean() <= LOOSE_SHARE, far.sum()
    np.testing.assert_allclose(tc, jc, atol=LOOSE_ATOL, rtol=0)
    ties = _tie_pixels(jc, tc, params.top_k) | far.any(-1)
    assert ties.mean() <= MAX_TIES, ties.sum()
    live = ~ties.reshape(H, W)
    for got in (tout, init_composition(td, ts, TParams(use_sa=True))):
        np.testing.assert_allclose(_np(got.costs)[live],
                                   np.asarray(jout.costs)[live], atol=ATOL,
                                   rtol=0)
        np.testing.assert_array_equal(_np(got.selected)[live],
                                      np.asarray(jout.selected)[live])
    # the star really cut windows: SA changes the costs
    square = tinit.initial_cost(td, ts, TParams(use_sa=False))
    assert (_np(square.costs) != _np(tout.costs)).mean() > 0.05


def _crafted_rows(seed: int = 11, s: int = 6) -> np.ndarray:
    """Rows of S costs: uniform ones, every view at COST_MAX, exact ties
    at the threshold, fewer views below COST_MAX than top_k, one view
    below it, NaN costs, -0 and +0, costs above COST_MAX."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 2.0, (400, s)).astype(np.float32)
    c[:40] = 2.0                              # every view at COST_MAX
    c[40:80, 1] = c[40:80, 0]                 # ties with the smallest
    c[40:80, 3] = c[40:80, 2]
    c[80:120, 2:] = 2.0                       # k = 2 < top_k
    c[120:160, 1:] = 2.0                      # one view
    c[160:200, ::2] = np.nan                  # NaN views
    c[200:240, 0] = -0.0
    c[200:240, 1] = 0.0
    c[240:280, 1::2] = 3.0                    # above COST_MAX
    c[280:320] = (np.round(rng.uniform(0, 2.0, (40, s)) * 4) / 4).astype(
        np.float32)                           # many exact ties
    return c


@pytest.mark.parametrize("top_k", [1, 4, 6])
def test_plain_selection_matches_jax_on_crafted_rows(top_k):
    """K11's plain version (``cost.initial_cost_and_selection`` with its
    top-k sum in ascending order, and the state update) against the JAX
    package's selection and state update."""
    c = _crafted_rows()
    jm, js = jcost.initial_cost_and_selection(jnp.asarray(c), top_k)
    valid = np.ones(c.shape[0], bool)
    valid[::7] = False
    want_cost = np.where(valid, np.asarray(jm), 1e9)
    want_sel = np.asarray(js) & valid[:, None]
    got_cost, got_sel = k11.select_plain(
        torch.as_tensor(c), torch.as_tensor(valid).reshape(20, 20), top_k)
    np.testing.assert_array_equal(_np(got_sel).reshape(-1, c.shape[1]),
                                  want_sel)
    np.testing.assert_allclose(_np(got_cost).reshape(-1), want_cost,
                               atol=1e-6, rtol=0)
    # the crafted rows' rules
    got_sel = _np(got_sel).reshape(-1, c.shape[1])
    got_cost = _np(got_cost).reshape(-1)
    live = valid.copy()
    assert not got_sel[:40].any()
    assert (got_cost[:40][live[:40]] == tcost.COST_MAX).all()
    assert (got_sel[120:160][live[120:160]].sum(-1) == 1).all()
    assert not got_sel[160:200, ::2].any()
    # tied views are selected together
    assert (got_sel[40:80, 0] == got_sel[40:80, 1]).all()
    assert (got_sel[40:80, 2] == got_sel[40:80, 3]).all()


def test_selection_sums_in_ascending_order():
    """The top-k sum is taken smallest first from +0: a row whose order
    matters in float32 gives the ascending sum, not another order's."""
    row = torch.tensor([[1.0, 1e-8, 1e-8, 1e-8, 2.0]])
    mean, sel = tcost.initial_cost_and_selection(row, 4)
    want = ((np.float32(0) + np.float32(1e-8)) + np.float32(1e-8)
            + np.float32(1e-8)) + np.float32(1.0)
    assert float(mean[0]) == float(np.float32(want) / np.float32(4))
    assert sel[0].tolist() == [True, True, True, True, False]


@pytest.mark.parametrize("use_sa", [False, True])
def test_one_chunk_equals_several(use_sa, monkeypatch):
    """The plain path's chunks (CHUNK pixels of K2's stage form, WEAK_CHUNK
    items of the re-score) do not change the result, bit for bit."""
    _, _, td, ts, *_, wx, wy, anchors, _ = _weak_setup(4, False, use_sa)
    params = TParams(use_sa=use_sa)
    args = (convert.ints(wx, "cpu"), convert.ints(wy, "cpu"),
            convert.ints(anchors, "cpu"))
    whole = tinit.initial_cost(td, ts, params, *args)
    monkeypatch.setattr(tinit, "CHUNK", 100)
    monkeypatch.setattr(tinit, "WEAK_CHUNK", 37)
    parts = tinit.initial_cost(td, ts, params, *args)
    assert torch.equal(whole.costs.view(torch.int32),
                       parts.costs.view(torch.int32))
    assert torch.equal(whole.selected, parts.selected)


@pytest.mark.parametrize("use_sa", [False, True])
def test_plain_matches_the_composition_it_replaces(use_sa):
    """The stage's plain path against the torch-op composition it replaced
    (``testing.init_composition``: torch's reductions for the window sums),
    with the weak list re-scored: costs to 1e-4, selections exactly."""
    _, _, td, ts, *_, wx, wy, anchors, _ = _weak_setup(4, False, use_sa)
    params = TParams(use_sa=use_sa)
    args = (convert.ints(wx, "cpu"), convert.ints(wy, "cpu"),
            convert.ints(anchors, "cpu"))
    got = tinit.initial_cost(td, ts, params, *args)
    want = init_composition(td, ts, params, *args)
    np.testing.assert_allclose(_np(got.costs), _np(want.costs), atol=1e-4,
                               rtol=0)
    assert torch.equal(got.selected, want.selected)
    # ... and the composition's state is the same kind of state
    assert dataclasses.asdict(got).keys() == dataclasses.asdict(want).keys()
