"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where only PyTorch is
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from dt4image_restoration_tpu_torch.config import ModelConfig
from dt4image_restoration_tpu_torch.models import (DecisionTransformer,
                                                   UNetDenoiser,
                                                   init_dt_params,
                                                   random_unet_state_dict)
from dt4image_restoration_tpu_torch.ops.kernels import conv_block as k1
from dt4image_restoration_tpu_torch.ops.kernels import kspace as k2
from dt4image_restoration_tpu_torch.ops.kernels import transformer as k3
from dt4image_restoration_tpu_torch.utils.device import resolve_device

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return resolve_device("cuda")  # TF32 off for the plain versions


def _f32(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32))


@pytest.mark.parametrize("shape,feats,layers", [
    ((2, 2, 40, 36), 32, 3),     # inc-like, ragged 16x16 tiles
    ((1, 96, 32, 32), 32, 3),    # up4-like: 6 input-channel chunks
    ((2, 5, 18, 17), 8, 2),      # odd width, narrow
    ((1, 3, 7, 9), 16, 1),       # smaller than one tile
])
def test_conv_block_kernel_matches_plain(dev, shape, feats, layers):
    rng = np.random.default_rng(0)
    cin = shape[1]
    ws, bs = [], []
    for i in range(layers):
        ws.append(_f32(rng, (feats, cin if i == 0 else feats, 3, 3), 0.1))
        bs.append(_f32(rng, (feats,), 0.1))
    packed = k1.pack_conv_block([w.to(dev) for w in ws],
                                [b.to(dev) for b in bs])
    x = _f32(rng, shape).to(dev)
    before = k1.launches
    got = k1.conv_block(x, packed)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    ref = k1.conv_block_plain(x, packed)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def test_kspace_kernel_matches_plain_exactly(dev):
    rng = np.random.default_rng(1)
    shape = (4, 1, 64, 64)
    z = torch.complex(_f32(rng, shape, 30), _f32(rng, shape, 30)).to(dev)
    y0 = torch.complex(_f32(rng, shape, 30), _f32(rng, shape, 30)).to(dev)
    mask = torch.from_numpy(rng.uniform(size=shape) < 0.3).to(dev)
    mu = torch.from_numpy(rng.uniform(0.1, 2.0, 4).astype(np.float32)).to(dev)
    got = k2.kspace_consistency_kernel(z, y0, mask, mu)
    ref = k2.kspace_consistency_plain(z, y0, mask, mu)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    with pytest.raises(ValueError, match="contiguous"):
        k2.kspace_consistency_kernel(z.transpose(-1, -2), y0, mask, mu)


@pytest.mark.parametrize("t", [12, 18])
def test_dt_decode_kernel_matches_plain(dev, t):
    cfg = ModelConfig()
    dt = DecisionTransformer(cfg).eval().requires_grad_(False)
    dt.load_state_dict(init_dt_params(cfg, seed=0))
    packed = dt.to(dev).packed_weights()
    tokens = _f32(np.random.default_rng(2), (5, t, cfg.embed_dim)).to(dev)
    got = k3.fused_dt_decode(tokens, packed, cfg.n_blocks, cfg.n_heads)
    ref = k3.fused_dt_decode_plain(tokens, packed, cfg.n_blocks, cfg.n_heads)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def test_unet_on_card_matches_cpu(dev):
    model = UNetDenoiser().eval().requires_grad_(False)
    model.load_state_dict(random_unet_state_dict(0))
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (2, 1, 128, 128)).astype(np.float32))
    sigma = torch.tensor([0.05, 0.1])
    ref = model(x, sigma)
    before = k1.launches
    got = model.to(dev)(x.to(dev), sigma.to(dev))
    torch.cuda.synchronize()
    assert k1.launches == before + 2          # inc and up4
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-3, atol=2e-4)
