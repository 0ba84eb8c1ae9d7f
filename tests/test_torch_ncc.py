"""K2, the fused strong NCC (ops/cuda/ncc.py, csrc/ncc.cu): its plain
version against the JAX package's ``ncc_strong`` and against the
composition the port ran before it (homography, warp, K1, window sums,
NCC), the wrapper's CPU contract, and, on a card, the kernel against its
plain version bit for bit.

Every case runs on a 24x32 synthetic scene with 4 source views: u8 and f32
quad tables, real bounds smaller than the padded ones, an SA star window on
seeded segment masks, a halo-extended row block (``src_height`` >
``height``), and planes with w = 0, NaN and +-inf components and centres
warped off the image mixed into near-truth and random planes. On the card
K2 is also held at 1 and 32 source views and on 25-tap windows (the
kernel's generic tap loop; its main path runs 36 taps).

The card part imports no JAX, so on a machine with a card and without the
JAX package's imports it runs with ``--noconftest`` (the JAX parity tests
then skip):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ncc.py
"""

import functools
import gc

import numpy as np
import pytest
import torch

from apde_mvs_tpu_torch.core import geometry as tgeo
from apde_mvs_tpu_torch.ops import cost as tcost
from apde_mvs_tpu_torch.ops.cuda import ncc as k2
from apde_mvs_tpu_torch.ops.cuda import sampler as k1
from apde_mvs_tpu_torch.parallel.tiles import halo_block
from apde_mvs_tpu_torch.testing import synthetic
from apde_mvs_tpu_torch.testing.kernel_cases import window_25

# one intra-op thread per test worker process (see tests/test_torch_cost.py)
torch.set_num_threads(1)

H, W, V = 24, 32, 5
COST_MAX = tcost.COST_MAX
CASES = ("u8", "f32", "u8-real", "sa-u8", "sa-f32", "halo-u8", "halo-sa-f32")
# the card's further cases: 1 or 32 source views (the 4 cycled), a 25-tap
# square window with shared or per-pixel offsets and weights
CARD_CASES = CASES + ("u8-s1", "sa-u8-s32", "u8-taps25", "f32-taps25-pp")


@functools.lru_cache(maxsize=None)
def _scene():
    return synthetic.make_scene(num_views=V, height=H, width=W)


def _sa_mask(depth, seed):
    """Seeded segment ids: segment 1 where the slanted scene is nearer than
    its mean, a random block of segment 2 across it, single-pixel specks of
    segment 3, 0 (no segment) elsewhere (tests/test_torch_cost.py)."""
    rng = np.random.default_rng(seed)
    m = np.where(depth < depth.mean(), 1, 0).astype(np.int32)
    y0, x0 = rng.integers(3, H // 2), rng.integers(3, W // 2)
    m[y0:y0 + 8, x0:x0 + 11] = 2
    m[rng.random(m.shape) < 0.03] = 3
    return m


def _case(name, device="cpu"):
    """(cost data, x, y, planes (B, 4), use_sa, special rows that must
    cost COST_MAX) of one case, every tensor on ``device``."""
    scene = _scene()
    cams = tgeo.CameraArrays.from_cameras(scene.cameras, device=device)
    imgs = torch.as_tensor(scene.images, device=device)
    sa = name.startswith("sa") or "-sa" in name
    mask = torch.as_tensor(_sa_mask(scene.depths[0], 2), device=device) \
        if sa else None
    real = (29, 21) if name.endswith("real") else (0, 0)
    src = [1] if name.endswith("-s1") else \
        [1 + i % (V - 1) for i in range(32)] if name.endswith("-s32") else \
        list(range(1, V))
    data = tcost.CostData.build(
        cams.view(0), cams.map(lambda a: a[src]), imgs[0], imgs[src],
        real_width=real[0], real_height=real[1], sampler_u8="u8" in name,
        sa_mask=mask)
    row0 = 0
    if name.startswith("halo"):
        data, row0, _, _ = halo_block(data, 6, 18, 4)   # 20 rows of 24
    rng = np.random.default_rng(CARD_CASES.index(name))
    ys, xs = np.mgrid[0:data.height, 0:data.width]
    n = xs.size
    x = torch.as_tensor(xs.reshape(-1).astype(np.float32), device=device)
    y = torch.as_tensor(ys.reshape(-1).astype(np.float32), device=device)
    rows = np.clip(ys.reshape(-1) + row0, 0, H - 1)
    depth = scene.depths[0][rows, xs.reshape(-1)] \
        * (1 + rng.normal(0, 0.01, n)).astype(np.float32)
    normal = tgeo.normal_world_to_cam(cams.view(0).R, torch.as_tensor(
        np.concatenate([scene.normals[0][rows, xs.reshape(-1)],
                        np.zeros((n, 1), np.float32)], -1), device=device))
    truth = tgeo.make_plane(data.ref_cam, x, y, torch.as_tensor(
        depth.astype(np.float32), device=device), normal[:, :3])
    rnd = tgeo.random_plane_from_draws(
        torch.as_tensor(rng.random(n).astype(np.float32), device=device),
        torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32),
                        device=device),
        data.ref_cam, x, y, 2.0, 7.0)
    # a plane 0.3 in front of the camera: its centres warp off the image
    near = tgeo.make_plane(data.ref_cam, x, y, torch.full_like(x, 0.3),
                           normal[:, :3])
    pick = torch.as_tensor(rng.random(n) < 0.5, device=device)[:, None]
    planes = torch.where(pick, truth, rnd).cpu().numpy()
    planes[::37, 3] = 0.0                       # w = 0
    planes[5::41] = np.nan
    planes[7::43, 3] = np.inf
    planes[11::47, 3] = -np.inf
    planes[13::53, 0] = np.inf
    planes[17::59, 2] = -np.inf
    planes[19::31] = near[19::31].cpu().numpy()
    special = (planes[:, 3] == 0) | np.isnan(planes).any(-1)
    special[19::31] = True
    return data, x, y, torch.as_tensor(planes, device=device), sa, special


def _window(data, x, y, sa):
    return tcost.precompute_ref_window(data, x, y, 5, 2, use_sa=sa)


def _case_window(name, data, x, y, sa):
    """The case's window: ``kernel_cases.window_25`` for ``taps25``, with
    per-pixel offsets and weights for ``taps25-pp``; else ``_window``'s."""
    if "taps25" not in name:
        return _window(data, x, y, sa)
    return window_25(data, x, y, per_pixel=name.endswith("-pp"))


def _composition(data, x, y, plane, win):
    """The strong NCC as the port computed it before K2: the homography,
    an (S, B, T) warp, K1, ``window_sums`` and ``ncc_from_sums``."""
    hom = tgeo.homography(data.ref_cam, data.src_views, plane)
    cx, cy = tgeo.warp(hom, x, y)
    oob = (cx < 0) | (cx >= data.img_w) | (cy < 0) | (cy >= data.img_h)
    wx, wy = tgeo.warp(hom[..., None, :, :], x[:, None] + win.tap_dx,
                       y[:, None] + win.tap_dy)
    sv = k1.sample_packed(data.src_quads, data.width, data.quad_h,
                          wx.contiguous(), wy.contiguous())
    cost = tcost.ncc_from_sums(win.sum_ref, win.sum_rr,
                               *tcost.window_sums(win.tap_w, win.tap_val, sv),
                               win.wsum)
    return torch.where(oob, COST_MAX, cost).T


def _jax():
    """(jax.numpy, the JAX package's geometry and cost modules), imported
    here: a machine with the card may lack the JAX package's imports."""
    jcost = pytest.importorskip("apde_mvs_tpu.ops.cost")
    import jax.numpy as jnp

    from apde_mvs_tpu.core import geometry as jgeo
    return jnp, jgeo, jcost


def _jax_cost_data(td):
    """The JAX package's CostData holding the same arrays as ``td``."""
    jnp, jgeo, jcost = _jax()

    def cams(c):
        return jgeo.CameraArrays(*(jnp.asarray(a.numpy())
                                   for a in (c.K, c.R, c.t, c.c)))
    sa = np.zeros((td.height, td.width), np.int32) if td.sa_mask is None \
        else td.sa_mask.numpy()
    return jcost.CostData(
        ref_cam=cams(td.ref_cam), src_cams=cams(td.src_cams),
        ref_image=jnp.asarray(td.ref_image.numpy()),
        src_quads=jnp.asarray(td.src_quads.numpy()), sa_mask=jnp.asarray(sa),
        src_depths=jnp.asarray(td.src_depths.numpy()), width=td.width,
        height=td.height, num_src=td.num_src, real_width=td.real_width,
        real_height=td.real_height, src_height=td.src_height)


def _assert_costs(got, want, atol):
    """Costs within ``atol``, COST_MAX in the same places. A cost that the
    clamp at COST_MAX reaches in one summation order and misses by less
    than ``atol`` in the other (an anti-correlated window of a few SA taps)
    is a cost difference, not a COST_MAX placement: such entries are left
    to the tolerance."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    at_clamp = np.minimum(got, want) >= COST_MAX - atol
    np.testing.assert_array_equal((got == COST_MAX)[~at_clamp],
                                  (want == COST_MAX)[~at_clamp])
    assert ((got == COST_MAX) != (want == COST_MAX)).sum() <= 2
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# The plain version on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax_ncc_strong(name):
    """K2's plain version against apde_mvs_tpu/ops/cost.py::ncc_strong on
    the same arrays: costs to 1e-4 (float32 sums in another order), the
    COST_MAX mask exactly."""
    jnp, _, jcost = _jax()
    data, x, y, planes, sa, special = _case(name)
    jd = _jax_cost_data(data)
    jx, jy = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())
    jw = jcost.precompute_ref_window(jd, jx, jy, 5, 2, sa)
    want = np.asarray(jcost.ncc_strong(jd, jx, jy, jnp.asarray(planes.numpy()),
                                       jw))
    got = k2.ncc_strong_plain(data, x, y, planes, _window(data, x, y, sa))
    assert got.shape == (x.numel(), V - 1)
    _assert_costs(got.numpy(), want, 1e-4)
    assert (got[torch.as_tensor(special)] == COST_MAX).all()
    assert (want < COST_MAX).sum() > 100 and (want < 0.3).sum() > 50
    if name.endswith("real"):
        # warps into the pad strip cost COST_MAX, not edge-replicated NCC
        assert (want == COST_MAX).sum() > (np.asarray(k2.ncc_strong_plain(
            data.replace(real_width=0, real_height=0), x, y, planes,
            _window(data, x, y, sa))) == COST_MAX).sum()


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_the_composition_it_replaces(name):
    """The plain version against the homography + warp + K1 + window_sums
    + ncc_from_sums composition: the sums differ only in their order."""
    data, x, y, planes, sa, _ = _case(name)
    win = _window(data, x, y, sa)
    _assert_costs(k2.ncc_strong_plain(data, x, y, planes, win),
                  _composition(data, x, y, planes, win), 1e-4)


# ---------------------------------------------------------------------------
# The wrapper's CPU contract
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version():
    data, x, y, planes, sa, _ = _case("sa-u8")
    win = _window(data, x, y, sa)
    before = (k2.launches, k1.launches)
    got = k2.ncc_strong_fused(data, x, y, planes, win)
    strided = torch.stack([planes, planes], 1)[:, 0]
    assert not strided.is_contiguous()
    via_cost = tcost.ncc_strong(data, x, y, strided, win)
    assert (k2.launches, k1.launches) == before
    want = k2.ncc_strong_plain(data, x, y, planes, win)
    assert torch.equal(got, want) and torch.equal(via_cost, want)
    assert got.shape == (x.numel(), V - 1)


def _bad(data, x, y, planes, win, what):
    """One argument set the wrapper must refuse, and the error it raises."""
    b = x.numel()
    if what == "x float64":
        return (data, x.double(), y, planes, win), TypeError
    if what == "quads int32":
        return (data.replace(src_quads=data.src_quads.to(torch.int32)), x, y,
                planes, win), TypeError
    if what == "window float64":
        return (data, x, y, planes, win._replace(tap_val=win.tap_val.double())
                ), TypeError
    if what == "plane (B, 3)":
        return (data, x, y, planes[:, :3], win), ValueError
    if what == "y (B - 1,)":
        return (data, x, y[1:], planes, win), ValueError
    if what == "offsets (T + 1,)":
        return (data, x, y, planes, win._replace(
            tap_dx=torch.cat([win.tap_dx, win.tap_dx[:1]]))), ValueError
    if what == "weights (B, T - 1)":
        return (data, x, y, planes, win._replace(
            tap_w=torch.ones((b, win.tap_val.shape[1] - 1)))), ValueError
    if what == "wsum (B + 1,)":
        return (data, x, y, planes, win._replace(
            wsum=torch.ones(b + 1))), ValueError
    if what == "x on another device":
        return (data, x.to("meta"), y, planes, win), ValueError
    if what == "quads (S, N + 1, 4)":
        return (data.replace(src_quads=torch.cat(
            [data.src_quads, data.src_quads[:, :1]], 1)), x, y, planes,
            win), ValueError
    raise AssertionError(what)


@pytest.mark.parametrize("what", [
    "x float64", "quads int32", "window float64", "plane (B, 3)",
    "y (B - 1,)", "offsets (T + 1,)", "weights (B, T - 1)", "wsum (B + 1,)",
    "x on another device", "quads (S, N + 1, 4)"])
def test_wrapper_rejects_bad_arguments(what):
    data, x, y, planes, sa, _ = _case("u8")
    args, err = _bad(data, x, y, planes, _window(data, x, y, sa), what)
    before = k2.launches
    with pytest.raises(err):
        k2.ncc_strong_fused(*args)
    assert k2.launches == before


def test_wrapper_rejects_more_views_than_the_kernel_takes():
    scene = _scene()
    cams = tgeo.CameraArrays.from_cameras(scene.cameras, device="cpu")
    imgs = torch.as_tensor(scene.images)
    many = [1 + i % (V - 1) for i in range(k2.MAX_VIEWS + 1)]
    data = tcost.CostData.build(cams.view(0), cams.map(lambda a: a[many]),
                                imgs[0], imgs[many], sampler_u8=True)
    x = torch.arange(8, dtype=torch.float32) + 10
    y = torch.full((8,), 12.0)
    planes = torch.tensor([[0.0, 0.0, -1.0, 4.0]]).expand(8, 4).contiguous()
    win = _window(data, x, y, False)
    with pytest.raises(ValueError, match="at most 32"):
        k2.ncc_strong_fused(data, x, y, planes, win)
    # one view fewer is taken
    few = data.replace(src_quads=data.src_quads[:-1],
                       src_cams=data.src_cams.map(lambda a: a[:-1]),
                       num_src=k2.MAX_VIEWS)
    assert k2.ncc_strong_fused(few, x, y, planes, win).shape == (8, 32)


def test_camera_table_is_built_once_per_cost_data():
    """The wrapper's camera table: the plain ``camera_table``, built once
    per CostData object and dropped when the object goes."""
    data, *_ = _case("u8")
    first = k2.cached_camera_table(data)
    assert k2.cached_camera_table(data) is first
    assert torch.equal(first, k2.camera_table(data))
    assert first.shape == (data.num_src + 1, 16)
    other = data.replace(real_width=data.width)
    assert k2.cached_camera_table(other) is not first
    key = id(data)
    del data
    gc.collect()
    assert key not in k2._tables and id(other) in k2._tables


def test_profile_pass_times_k2_and_restores_the_stages():
    """tools.profile_pass wraps every stage it reports, and K2, while it
    profiles, and puts the plain functions back afterwards."""
    from apde_mvs_tpu_torch.tools import profile_pass as pp
    before = [getattr(m, a) for m, a, _ in pp._STAGES]
    fused = k2.ncc_strong_fused
    with pp.stage_ranges({}):
        assert k2.ncc_strong_fused is not fused
        assert all(getattr(m, a) is not f
                   for (m, a, _), f in zip(pp._STAGES, before))
    assert k2.ncc_strong_fused is fused
    assert [getattr(m, a) for m, a, _ in pp._STAGES] == before


# ---------------------------------------------------------------------------
# The kernel on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("K2 is a CUDA kernel; no CUDA device here")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_CASES)
def test_k2_matches_plain_on_card(cuda_device, name):
    data, x, y, planes, sa, special = _case(name, cuda_device)
    win = _case_window(name, data, x, y, sa)
    before = (k2.launches, k1.launches)
    got = k2.ncc_strong_fused(data, x, y, planes, win)
    torch.cuda.synchronize()
    assert (k2.launches, k1.launches) == (before[0] + 1, before[1])
    want = k2.ncc_strong_plain(data, x, y, planes, win)
    assert torch.equal(got, want)
    assert (got[torch.as_tensor(special, device=cuda_device)]
            == COST_MAX).all()
    assert (got < 0.3).sum() > 50


@pytest.mark.cuda
def test_k2_one_pixel_and_ncc_strong_route_on_card(cuda_device):
    """One pixel (tools.debug_point's shape), and cost.ncc_strong on CUDA
    tensors launching K2 once and K1 never."""
    data, x, y, planes, sa, _ = _case("u8", cuda_device)
    for sl in (slice(100, 101), slice(None)):
        px, py, pp = x[sl], y[sl], planes[sl]
        win = _window(data, px, py, sa)
        before = (k2.launches, k1.launches)
        got = tcost.ncc_strong(data, px, py, pp, win)
        torch.cuda.synchronize()
        assert (k2.launches, k1.launches) == (before[0] + 1, before[1])
        assert torch.equal(got, k2.ncc_strong_plain(data, px, py, pp, win))


@pytest.mark.cuda
def test_k2_rejects_what_it_does_not_take_on_card(cuda_device):
    data, x, y, planes, sa, _ = _case("u8", cuda_device)
    win = _window(data, x, y, sa)
    with pytest.raises(ValueError):     # not contiguous
        k2.ncc_strong_fused(data, x, y, planes.T.contiguous().T, win)
    with pytest.raises(ValueError):     # a CPU tensor among CUDA ones
        k2.ncc_strong_fused(data, x.cpu(), y, planes, win)
    with pytest.raises(TypeError):
        k2.ncc_strong_fused(data, x, y, planes.double(), win)
