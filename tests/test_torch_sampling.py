"""Parity of the port's geometry, checkerboard layout and sampler (K1's
plain version) with the JAX package. K1 itself is tested on the card in
tests/test_torch_kernels.py.

The JAX side runs as the JAX package's own tests run it on the CPU; the
Pallas sampler in interpret mode, as tests/test_pallas_sampler.py does."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apde_mvs_tpu.core import checkerboard as jcb
from apde_mvs_tpu.core import geometry as jgeo
from apde_mvs_tpu.core import sampling as jsamp
from apde_mvs_tpu_torch.core import checkerboard as tcb
from apde_mvs_tpu_torch.core import geometry as tgeo
from apde_mvs_tpu_torch.core import sampling as tsamp
from apde_mvs_tpu_torch.ops.cuda import sampler as k1

# The suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's many small CPU ops from spinning against each
# other, as they do with the default of one thread per core.
torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# geometry / checkerboard
# ---------------------------------------------------------------------------

def _cams(rng, n):
    """n cameras looking roughly down +z with distinct poses."""
    K = np.zeros((n, 3, 3), np.float32)
    K[:, 0, 0] = rng.uniform(150, 170, n)
    K[:, 1, 1] = rng.uniform(150, 170, n)
    K[:, 0, 2] = 32.0
    K[:, 1, 2] = 24.0
    K[:, 2, 2] = 1.0
    R = []
    for _ in range(n):
        a = rng.normal(0, 0.05, 3)
        c1, s1 = np.cos(a), np.sin(a)
        Rx = np.array([[1, 0, 0], [0, c1[0], -s1[0]], [0, s1[0], c1[0]]])
        Ry = np.array([[c1[1], 0, s1[1]], [0, 1, 0], [-s1[1], 0, c1[1]]])
        R.append(Rx @ Ry)
    R = np.asarray(R, np.float32)
    t = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    c = -np.einsum("nji,nj->ni", R, t).astype(np.float32)
    return (jgeo.CameraArrays(*map(jnp.asarray, (K, R, t, c))),
            tgeo.CameraArrays(*map(torch.as_tensor, (K, R, t, c))))


def test_geometry_parity():
    rng = np.random.default_rng(0)
    jc, tc = _cams(rng, 4)
    B = 257
    x = rng.uniform(0, 64, B).astype(np.float32)
    y = rng.uniform(0, 48, B).astype(np.float32)
    d = rng.uniform(2, 6, B).astype(np.float32)
    n = rng.normal(size=(B, 3)).astype(np.float32)
    n[:, 2] = -np.abs(n[:, 2]) - 0.5
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    jr, tr = jc.view(0), tc.view(0)
    js, ts = jc.view(2), tc.view(2)

    jplane = jgeo.make_plane(jr, jnp.asarray(x), jnp.asarray(y),
                             jnp.asarray(d), jnp.asarray(n))
    tplane = tgeo.make_plane(tr, _t(x), _t(y), _t(d), _t(n))
    _close(tplane, jplane)
    _close(tgeo.depth_from_plane(tr, tplane, _t(x), _t(y)),
           jgeo.depth_from_plane(jr, jplane, x, y))
    _close(tgeo.backproject_world(tr, _t(x), _t(y), _t(d)),
           jgeo.backproject_world(jr, x, y, d))
    Xw = jgeo.backproject_world(jr, x, y, d)
    for got, want in zip(tgeo.project(ts, _t(Xw)), jgeo.project(js, Xw)):
        _close(got, want)
    _close(tgeo.view_direction(tr, _t(x), _t(y), 2.0),
           jgeo.view_direction(jr, jnp.asarray(x), jnp.asarray(y), 2.0))
    _close(tgeo.normal_cam_to_world(tr.R, tplane),
           jgeo.normal_cam_to_world(jr.R, jplane))
    _close(tgeo.normal_world_to_cam(tr.R, tplane),
           jgeo.normal_world_to_cam(jr.R, jplane))
    _close(tgeo.angle_between(_t(n), _t(n[::-1].copy())),
           jgeo.angle_between(n, n[::-1]))

    # homography batched over views, as ncc_strong uses it
    tsrc = tc.map(lambda a: a[1:, None])
    Ht = tgeo.homography(tr, tsrc, tplane)                   # (3, B, 3, 3)
    for s in range(3):
        Hj = jgeo.homography(jr, jc.view(s + 1), jplane)
        _close(Ht[s], Hj)
        for got, want in zip(tgeo.warp(Ht[s], _t(x), _t(y)),
                             jgeo.warp(Hj, x, y)):
            _close(got, want)


def test_random_hypotheses_from_jax_draws():
    rng = np.random.default_rng(1)
    jc, tc = _cams(rng, 1)
    jr, tr = jc.view(0), tc.view(0)
    B = 301
    x = jnp.asarray(rng.uniform(0, 64, B).astype(np.float32))
    y = jnp.asarray(rng.uniform(0, 48, B).astype(np.float32))
    dmin, dmax = jnp.float32(1.7), jnp.float32(7.3)

    key = jax.random.PRNGKey(5)
    want = jgeo.random_plane_hypothesis(key, jr, x, y, dmin, dmax)
    kd, kn = jax.random.split(key)
    u = jax.random.uniform(kd, x.shape, jnp.float32)
    g = jax.random.normal(kn, x.shape + (3,), jnp.float32)
    got = tgeo.random_plane_from_draws(_t(u), _t(g), tr, _t(x), _t(y),
                                       1.7, 7.3)
    _close(got, want)

    angles = (rng.uniform(size=(B, 3)).astype(np.float32) - 0.5) * 0.06
    normal = np.asarray(want[:, :3])
    _close(tgeo.perturbed_normal_from_angles(_t(angles), tr, _t(x), _t(y),
                                             _t(normal)),
           jgeo.perturbed_normal_from_angles(jnp.asarray(angles), jr, x, y,
                                             jnp.asarray(normal)))


def test_checkerboard_parity():
    rng = np.random.default_rng(2)
    arr = rng.normal(size=(6, 10, 3)).astype(np.float32)
    for color in (0, 1):
        jx, jy = jcb.color_coords(6, 10, color)
        tx, ty = tcb.color_coords(6, 10, color)
        np.testing.assert_array_equal(_np(tx), np.asarray(jx))
        np.testing.assert_array_equal(_np(ty), np.asarray(jy))
        g = tcb.gather_color(_t(arr), color)
        np.testing.assert_array_equal(_np(g), np.asarray(
            jcb.gather_color(jnp.asarray(arr), color)))
        vals = rng.normal(size=(6, 5, 3)).astype(np.float32)
        np.testing.assert_array_equal(
            _np(tcb.scatter_color(_t(arr), _t(vals), color)),
            np.asarray(jcb.scatter_color(jnp.asarray(arr),
                                         jnp.asarray(vals), color)))
    m = rng.integers(0, 3, (6, 10)).astype(np.int32)
    np.testing.assert_array_equal(_np(tcb.gather_color(_t(m), 1)),
                                  np.asarray(jcb.gather_color(m, 1)))


# ---------------------------------------------------------------------------
# sampling: plain version against the JAX sampler
# ---------------------------------------------------------------------------

_SPECIAL = np.array([np.nan, np.inf, -np.inf, -1e30, 1e30, -3.5, 70.25,
                     0.0, 63.0, 47.0, 62.999, -0.0], np.float32)


def _coords(rng, S, n, w, h):
    x = rng.uniform(-4, w + 4, (S, n)).astype(np.float32)
    y = rng.uniform(-4, h + 4, (S, n)).astype(np.float32)
    k = len(_SPECIAL)
    x[:, :k] = _SPECIAL
    y[:, k:2 * k] = _SPECIAL
    x[:, 2 * k:3 * k] = _SPECIAL
    y[:, 2 * k:3 * k] = _SPECIAL[::-1]
    return x, y


@pytest.mark.parametrize("u8", [True, False])
def test_packed_sampler_matches_jax(u8):
    rng = np.random.default_rng(3)
    S, H, W = 3, 48, 64
    imgs = rng.uniform(0, 255, (S, H, W)).astype(np.float32)
    pack_j = jsamp.pack_bilinear_u8 if u8 else jsamp.pack_bilinear
    pack_t = tsamp.pack_bilinear_u8 if u8 else tsamp.pack_bilinear
    jq = jax.vmap(pack_j)(jnp.asarray(imgs))
    tq = pack_t(_t(imgs))
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    x, y = _coords(rng, S, 4000, W, H)
    want = np.stack([np.asarray(jsamp.bilinear_sample_packed(
        jq[s], W, H, jnp.asarray(x[s]), jnp.asarray(y[s]))) for s in range(S)])
    before = k1.launches
    got = _np(tsamp.bilinear_sample_packed(tq, W, H, _t(x), _t(y)))
    assert k1.launches == before        # CPU tensors never launch
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert np.isnan(got).sum() > 0
    # the single-table form
    got0 = _np(tsamp.bilinear_sample_packed(tq[0], W, H, _t(x[0]), _t(y[0])))
    np.testing.assert_array_equal(got0, got[0])


def test_image_sampler_matches_jax_bilinear_sample():
    rng = np.random.default_rng(4)
    H, W = 48, 64
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    x, y = _coords(rng, 1, 3000, W, H)
    want = np.asarray(jsamp.bilinear_sample(jnp.asarray(img), x[0], y[0]))
    got = _np(tsamp.bilinear_sample(_t(img), _t(x[0]), _t(y[0])))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _pallas_interpret(img, xs, ys, rw=24, cw=256):
    from jax.experimental import pallas as pl

    from apde_mvs_tpu.ops.pallas import sampler

    nb = xs.shape[0]
    kernel = functools.partial(sampler._sampler_kernel, rw=rw, cw=cw)
    out = pl.pallas_call(
        kernel,
        grid=(nb,),
        in_specs=[
            pl.BlockSpec(img.shape, lambda i: (0, 0)),
            pl.BlockSpec((1, sampler.BLOCK, 1), lambda i: (i, 0, 0)),
            pl.BlockSpec((1, sampler.BLOCK, 1), lambda i: (i, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, sampler.BLOCK, 1), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((nb, sampler.BLOCK, 1), jnp.float32),
        interpret=True,
    )(img, xs.reshape(nb, sampler.BLOCK, 1), ys.reshape(nb, sampler.BLOCK, 1))
    return out.reshape(nb, sampler.BLOCK)


def test_sample_blocks_matches_pallas_kernel():
    """The port's image form against the TPU kernel itself (interpret mode)
    on coherent blocks; atol is the JAX test's own, for the hat-matmul
    summation."""
    from apde_mvs_tpu.ops.pallas.sampler import BLOCK

    H, W = 256, 384
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    NB = 3
    ys = rng.uniform(8, H - 40, NB)[:, None] + rng.uniform(0, 12, (NB, BLOCK))
    xs = rng.uniform(8, W - 270, NB)[:, None] + rng.uniform(0, 120, (NB, BLOCK))
    xs = xs.astype(np.float32)
    ys = ys.astype(np.float32)
    want = np.asarray(_pallas_interpret(jnp.asarray(img), jnp.asarray(xs),
                                        jnp.asarray(ys)))
    got = _np(k1.sample_blocks(_t(img), _t(xs), _t(ys)))
    np.testing.assert_allclose(got, want, atol=2e-2)


def test_texel_fetch_and_fetch_parity():
    rng = np.random.default_rng(6)
    img = rng.uniform(0, 9, (6, 9)).astype(np.float32)
    x = np.concatenate([rng.uniform(-3, 12, 50),
                        [np.nan, np.inf, -np.inf, 1e12, -1e12]]
                       ).astype(np.float32)
    y = np.concatenate([rng.uniform(-3, 9, 50),
                        [1.0, 2.0, 3.0, 4.0, 5.0]]).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tsamp.texel_fetch(_t(img), _t(x), _t(y))),
        np.asarray(jsamp.texel_fetch(jnp.asarray(img), jnp.asarray(x),
                                     jnp.asarray(y))))
    xi = rng.integers(-2, 11, (7, 5)).astype(np.int32)
    yi = rng.integers(-2, 8, (7, 5)).astype(np.int32)
    arr = rng.normal(size=(6, 9, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tsamp.fetch(_t(arr), _t(xi), _t(yi), fill=-1.0)),
        np.asarray(jsamp.fetch(jnp.asarray(arr), jnp.asarray(xi),
                               jnp.asarray(yi), fill=-1.0)))
