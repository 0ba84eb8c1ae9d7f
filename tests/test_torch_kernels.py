"""K1, the hand-written CUDA sampler, against its plain PyTorch version.

This file imports no JAX, so on a machine with a card and without JAX it
runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

The card tests carry the ``cuda`` marker and skip where
torch.cuda.is_available() is false; the wrapper's CPU contract (plain
version, no launch, argument checks) is tested everywhere."""

import numpy as np
import pytest
import torch

from apde_mvs_tpu_torch.core import sampling as tsamp
from apde_mvs_tpu_torch.ops.cuda import sampler as k1

_SPECIAL = np.array([np.nan, np.inf, -np.inf, -1e30, 1e30, -3.5, 1e4,
                     0.0, -0.0, 0.5], np.float32)


def _coords(rng, lead, n, w, h):
    x = rng.uniform(-4, w + 4, lead + (n,)).astype(np.float32)
    y = rng.uniform(-4, h + 4, lead + (n,)).astype(np.float32)
    k = len(_SPECIAL)
    x[..., :k] = _SPECIAL
    y[..., k:2 * k] = _SPECIAL
    x[..., 2 * k:3 * k] = _SPECIAL
    y[..., 2 * k:3 * k] = _SPECIAL[::-1]
    return torch.as_tensor(x), torch.as_tensor(y)


def _assert_same(got, want, atol=1e-3):
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert float((got[ok] - want[ok]).abs().max()) <= atol


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(0)
    imgs = torch.as_tensor(rng.uniform(0, 255, (2, 12, 16)).astype(np.float32))
    quads = tsamp.pack_bilinear_u8(imgs)
    x, y = _coords(rng, (2,), 500, 16, 12)
    before = k1.launches
    got = k1.sample_packed(quads, 16, 12, x, y)
    assert k1.launches == before
    assert torch.equal(torch.isnan(got),
                       torch.isnan(x) | torch.isnan(y))
    _assert_same(got, k1.sample_packed_plain(quads, 16, 12, x, y), atol=0)
    # the image form equals the packed f32 form on the same image
    img = imgs[0]
    _assert_same(k1.sample_blocks(img, x[0], y[0]),
                 k1.sample_packed(tsamp.pack_bilinear(img)[None], 16, 12,
                                  x[:1], y[:1])[0], atol=1e-4)


def test_sampler_wrapper_validates_arguments():
    q = torch.zeros((2, 12, 4), dtype=torch.uint8)
    x = torch.zeros((2, 5))
    with pytest.raises(ValueError):
        k1.sample_packed(q, 4, 4, x, x)            # 12 rows != 4*4
    with pytest.raises(ValueError):
        k1.sample_packed(q, 4, 3, x[:1], x[:1])    # 1 coordinate set, 2 tables
    with pytest.raises(ValueError):
        k1.sample_blocks(torch.zeros(3, 4), x, x[:1])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("K1 is a CUDA kernel; no CUDA device here")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("u8", [True, False])
def test_k1_packed_matches_plain_on_card(cuda_device, u8):
    rng = np.random.default_rng(7)
    S, H, W = 4, 120, 160
    imgs = torch.as_tensor(rng.uniform(0, 255, (S, H, W)).astype(np.float32),
                           device=cuda_device)
    quads = (tsamp.pack_bilinear_u8 if u8 else tsamp.pack_bilinear)(imgs)
    x, y = _coords(rng, (S, 50), 1000, W, H)
    x, y = x.to(cuda_device), y.to(cuda_device)
    before = k1.launches
    got = k1.sample_packed(quads, W, H, x, y)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    assert got.shape == x.shape
    _assert_same(got, k1.sample_packed_plain(quads, W, H, x, y))


@pytest.mark.cuda
def test_k1_image_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(8)
    H, W = 120, 160
    img = torch.as_tensor(rng.uniform(0, 255, (H, W)).astype(np.float32),
                          device=cuda_device)
    x, y = _coords(rng, (7,), 9000, W, H)
    x, y = x.to(cuda_device), y.to(cuda_device)
    got = k1.sample_blocks(img, x, y)
    torch.cuda.synchronize()
    _assert_same(got, k1.sample_blocks_plain(img, x, y))


@pytest.mark.cuda
def test_k1_core_sampling_routes_cuda_tensors_to_the_kernel(cuda_device):
    rng = np.random.default_rng(9)
    img = torch.as_tensor(rng.uniform(0, 255, (24, 32)).astype(np.float32),
                          device=cuda_device)
    quad = tsamp.pack_bilinear_u8(img)
    x, y = _coords(rng, (), 3000, 32, 24)
    before = k1.launches
    got = tsamp.bilinear_sample_packed(quad, 32, 24, x.to(cuda_device),
                                       y.to(cuda_device))
    got2 = tsamp.bilinear_sample(img, x.to(cuda_device), y.to(cuda_device))
    torch.cuda.synchronize()
    assert k1.launches == before + 2
    _assert_same(got.cpu(), tsamp.bilinear_sample_packed(quad.cpu(), 32, 24,
                                                         x, y))
    _assert_same(got2.cpu(), tsamp.bilinear_sample(img.cpu(), x, y))


@pytest.mark.cuda
def test_k1_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros((1, 5), device=cuda_device)
    with pytest.raises(TypeError):
        k1.sample_packed(torch.zeros((1, 12, 4), dtype=torch.int32,
                                     device=cuda_device), 4, 3, x, x)
    q = torch.zeros((1, 12, 4), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(TypeError):
        k1.sample_packed(q, 4, 3, x.double(), x.double())
    with pytest.raises(ValueError):
        k1.sample_packed(q, 4, 3, x.cpu(), x.cpu())
    with pytest.raises(ValueError):
        k1.sample_packed(q, 4, 3, torch.zeros((1, 10),
                                              device=cuda_device)[:, ::2], x)
