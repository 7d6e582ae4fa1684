"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where only PyTorch is
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py
"""
import functools
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dt4image_restoration_tpu_torch.config import MCTSConfig, ModelConfig
from dt4image_restoration_tpu_torch.data import (EvaluationDataset,
                                                 write_eval_dir)
from dt4image_restoration_tpu_torch.inference import (MCTS, DeviceMCTS,
                                                      Evaluator)
from dt4image_restoration_tpu_torch.models import (DecisionTransformer,
                                                   DRUNetDenoiser,
                                                   PriorGraphs,
                                                   RestormerDenoiser,
                                                   UNetDenoiser,
                                                   fused_forward_takes,
                                                   init_dt_params,
                                                   make_dt_apply,
                                                   proxy_value_fn,
                                                   proxy_value_fn_batched,
                                                   random_drunet_state_dict,
                                                   random_restormer_state_dict,
                                                   random_unet_state_dict)
from dt4image_restoration_tpu_torch.ops import kernels
from dt4image_restoration_tpu_torch.ops.kernels import attention as k4
from dt4image_restoration_tpu_torch.ops.kernels import conv_block as k1
from dt4image_restoration_tpu_torch.ops.kernels import kspace as k2
from dt4image_restoration_tpu_torch.ops.kernels import layernorm as k5
from dt4image_restoration_tpu_torch.ops.kernels import transformer as k3
from dt4image_restoration_tpu_torch.ops.kernels import upsample_concat as k6
from dt4image_restoration_tpu_torch.ops.kernels import mdta_gram as k7
from dt4image_restoration_tpu_torch.ops.kernels import (
    biasfree_layernorm as k8)
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
    ((2, 2, 128, 128), 32, 3),   # the U-Net's inc
    ((2, 96, 128, 128), 32, 3),  # the U-Net's up4
    ((128, 2, 128, 128), 32, 3),   # inc at the expert recorder's chunk
    ((128, 96, 128, 128), 32, 3),  # up4 at the expert recorder's chunk
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


def _dt128(dev):
    """The published DT's pack (E 128, 4 heads, 5 blocks) on the card."""
    cfg = ModelConfig()
    dt = DecisionTransformer(cfg).eval().requires_grad_(False)
    dt.load_state_dict(init_dt_params(cfg, seed=0))
    return dt.to(dev).packed_weights()


@pytest.mark.parametrize("b", [1, 2, 61, 63])
@pytest.mark.parametrize("t", [1, 7, 12, 18, 32])
def test_dt_decode_kernel_at_policy_shapes(dev, b, t):
    """The cluster kernel at the published width, max abs error <= 1e-4;
    B=61 leaves the last cluster ragged where S > 1, T=32 takes a cluster
    alone."""
    packed = _dt128(dev)
    tokens = _f32(np.random.default_rng(7), (b, t, 128)).to(dev)
    before = k3.launches
    got = k3.fused_dt_decode(tokens, packed, 5, 4)
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    ref = k3.fused_dt_decode_plain(tokens, packed, 5, 4)
    assert float((got - ref).abs().max()) <= 1e-4


def test_dt_decode_kernel_narrow_width(dev):
    """E=64 (4 heads of 16) on a pack without the fragment key: the
    wrapper packs it for the call."""
    cfg = ModelConfig(embed_dim=64, n_heads=4, n_blocks=2)
    dt = DecisionTransformer(cfg).eval().requires_grad_(False)
    dt.load_state_dict(init_dt_params(cfg, seed=3))
    packed = {k: v for k, v in dt.to(dev).packed_weights().items()
              if k in k3.PACK_KEYS}
    tokens = _f32(np.random.default_rng(8), (37, 18, 64)).to(dev)
    got = k3.fused_dt_decode(tokens, packed, cfg.n_blocks, cfg.n_heads)
    ref = k3.fused_dt_decode_plain(tokens, packed, cfg.n_blocks, cfg.n_heads)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-4


def test_dt_decode_kernel_refuses_unsupported_width(dev):
    cfg = ModelConfig(embed_dim=96, n_heads=4, n_blocks=1)
    dt = DecisionTransformer(cfg).eval().requires_grad_(False)
    dt.load_state_dict(init_dt_params(cfg, seed=0))
    packed = dt.to(dev).packed_weights()
    assert "tc_w" not in packed
    tokens = torch.zeros((2, 12, 96), device=dev)
    with pytest.raises(ValueError, match=r"E in \(64, 128\)"):
        k3.fused_dt_decode(tokens, packed, 1, 4)
    with pytest.raises(ValueError, match="n_heads=4"):
        k3.fused_dt_decode(torch.zeros((2, 12, 128), device=dev),
                           _dt128(dev), 5, 8)


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


# K6's (a, skip) planes, without the batch: the U-Net decoder's four
# levels at 128x128 (up1 to up4), an odd-sized pair (a pad border on all
# four sides), a Ws that is not a multiple of 4, and a skip smaller than
# the upsampled image (F.pad crops).
K6_PLANES = {"up1": ((512, 8, 8), (256, 16, 16)),
             "up2": ((256, 16, 16), (128, 32, 32)),
             "up3": ((128, 32, 32), (64, 64, 64)),
             "up4": ((64, 64, 64), (32, 128, 128)),
             "odd": ((64, 31, 33), (32, 65, 68)),
             "ws30": ((64, 16, 15), (32, 32, 30)),
             "crop": ((8, 5, 6), (4, 9, 10))}


def _interpolate_pad_cat(a, skip):
    """The composition K6 replaces, as the U-Net ran it before."""
    up = F.interpolate(a, scale_factor=2, mode="bilinear",
                       align_corners=True)
    dy, dx = skip.shape[2] - up.shape[2], skip.shape[3] - up.shape[3]
    up = F.pad(up, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
    return torch.cat([skip, up], dim=1)


def _bits(t):
    """The bit patterns of a float32 or bfloat16 tensor."""
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 16, 63])
@pytest.mark.parametrize("planes", list(K6_PLANES))
def test_upsample_concat_kernel_equals_interpolate_pad_cat(dev, planes, b,
                                                            dtype):
    """K6 against ``F.interpolate`` + pad + ``torch.cat`` on the card: the
    same arithmetic as PyTorch's kernel, so every output bit for bit."""
    a_plane, skip_plane = K6_PLANES[planes]
    gen = torch.Generator(device=dev).manual_seed(b)
    a = torch.randn((b, *a_plane), generator=gen, device=dev).to(dtype)
    skip = torch.randn((b, *skip_plane), generator=gen, device=dev).to(dtype)
    before = k6.launches
    got = k6.upsample_concat(a, skip)
    torch.cuda.synchronize()
    assert k6.launches == before + 1
    ref = _interpolate_pad_cat(a, skip)
    assert got.shape == ref.shape and got.dtype == dtype
    equal = _bits(got) == _bits(ref)
    assert bool(equal.all()), (
        f"bit-equal share {float(equal.float().mean())}, largest "
        f"difference {float((got.float() - ref.float()).abs().max())}")


def test_upsample_concat_kernel_takes_unaligned_skip(dev):
    """A contiguous skip whose storage starts off a 16-byte boundary runs
    the kernel's element-by-element path, with the same result."""
    a = torch.randn((2, 8, 16, 16), device=dev)
    skip = torch.randn(2 * 4 * 32 * 32 + 1, device=dev)[1:].view(
        2, 4, 32, 32)
    assert skip.is_contiguous() and skip.data_ptr() % 16
    assert torch.equal(_bits(k6.upsample_concat(a, skip)),
                       _bits(_interpolate_pad_cat(a, skip)))


@pytest.mark.parametrize("case,error", [
    ("float16", TypeError), ("mixed", TypeError),
    ("strided_a", ValueError), ("strided_skip", ValueError),
    ("batch", ValueError), ("ndim", ValueError)])
def test_upsample_concat_kernel_refuses(dev, case, error):
    a = torch.zeros((2, 8, 4, 4), device=dev)
    skip = torch.zeros((2, 4, 8, 8), device=dev)
    if case == "float16":
        a, skip = a.half(), skip.half()
    elif case == "mixed":
        a = a.to(torch.bfloat16)
    elif case == "strided_a":
        a = torch.zeros((2, 8, 4, 8), device=dev)[..., ::2]
    elif case == "strided_skip":
        skip = torch.zeros((2, 4, 8, 8), device=dev).transpose(2, 3)
    elif case == "batch":
        skip = torch.zeros((3, 4, 8, 8), device=dev)
    else:
        a = a[0]
    before = k6.launches
    with pytest.raises(error):
        k6.upsample_concat(a, skip)
    assert k6.launches == before


# K7's (side, channels, heads) at Restormer's levels on 128x128 slices:
# encoder levels 1-3 (decoder levels 3 and 2 alike), the latent, decoder
# level 1 and the refinement.
K7_LEVELS = {"level1": (128, 48, 1), "level2": (64, 96, 2),
             "level3": (32, 192, 4), "latent": (16, 384, 8),
             "decoder1": (128, 96, 1)}


def _qkv(dev, b, side, ch, heads, seed, dtype=torch.bfloat16):
    """A (B, side, side, 3C) qkv whose k leans on q, so that the maps are
    far from uniform, and ``heads`` temperatures from 1 to 3."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, side, side, ch), generator=gen, device=dev)
    k = q + torch.randn((b, side, side, ch), generator=gen, device=dev)
    v = torch.randn((b, side, side, ch), generator=gen, device=dev)
    tau = 1.0 + 2.0 * torch.rand((heads,), generator=gen, device=dev)
    return torch.cat([q, k, v], dim=-1).to(dtype), tau


@pytest.mark.parametrize("b", [1, 16, 63])
@pytest.mark.parametrize("level", list(K7_LEVELS))
def test_mdta_gram_kernel_matches_plain(dev, level, b):
    """K7 in bfloat16 at every level's (c, h) against its plain version on
    the same bfloat16 q and k (normalize, matmul, softmax in float32): the
    kernel's Gram sums the pixels in float32 in another order, so within
    1e-5 of maps whose entries are about 1/c; two launches agree bit for
    bit, and each call counts one launch."""
    side, ch, heads = K7_LEVELS[level]
    qkv, tau = _qkv(dev, b, side, ch, heads, b)
    before = k7.launches
    got = k7.mdta_gram(qkv, tau, heads)
    again = k7.mdta_gram(qkv, tau, heads)
    torch.cuda.synchronize()
    assert k7.launches == before + 2
    ref = k7.mdta_gram_plain(qkv, tau, heads)
    assert got.shape == (b, heads, ch // heads, ch // heads)
    assert got.dtype == torch.float32
    gap = float((got - ref).abs().max())
    print(f"mdta_gram {level} B={b}: largest gap {gap:.3e}, map range "
          f"{float(ref.min()):.4f}-{float(ref.max()):.4f}")
    assert gap <= 1e-5
    assert torch.equal(got, again)


@pytest.mark.parametrize("level", ["level1", "latent", "decoder1"])
def test_mdta_gram_kernel_in_float32(dev, level):
    """The float32 path (SIMT products, full float32) against the plain
    version at B=2."""
    side, ch, heads = K7_LEVELS[level]
    qkv, tau = _qkv(dev, 2, side, ch, heads, 7,
                     dtype=torch.float32)
    got = k7.mdta_gram(qkv, tau, heads)
    assert float((got - k7.mdta_gram_plain(qkv, tau, heads)).abs().max()) \
        <= 1e-5


def test_mdta_gram_kernel_in_cuda_graph_is_bit_equal_to_eager(dev):
    """A replay of a captured call writes the eager call's maps bit for
    bit: the split and the order of the partials' sum are fixed, with no
    atomics, and the workspace comes from the graph's pool."""
    side, ch, heads = K7_LEVELS["level1"]
    qkv, tau = _qkv(dev, 63, side, ch, heads, 3)
    want = k7.mdta_gram(qkv, tau, heads)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        k7.mdta_gram(qkv, tau, heads)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = k7.mdta_gram(qkv, tau, heads)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("case,error", [
    ("float16", TypeError), ("width", ValueError), ("strided", ValueError),
    ("heads", ValueError), ("tau", ValueError)])
def test_mdta_gram_kernel_refuses(dev, case, error):
    qkv = torch.zeros((2, 8, 8, 3 * 48), device=dev, dtype=torch.bfloat16)
    tau, heads = torch.ones(1, device=dev), 1
    if case == "float16":
        qkv = qkv.half()
    elif case == "width":
        qkv = torch.zeros((2, 8, 8, 3 * 40), device=dev)
    elif case == "strided":
        qkv = qkv.transpose(1, 2)
    elif case == "heads":
        heads = 5
    else:
        tau = torch.ones(2, device=dev)
    before = k7.launches
    with pytest.raises(error):
        k7.mdta_gram(qkv, tau, heads)
    assert k7.launches == before


def _ln_inputs(dev, shape, dtype, seed):
    """A (..., C) input off centre (mean 0.5, so that the mean's share
    counts) and a (C,) float32 scale around 1."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=dev) + 0.5
    w = 1.0 + 0.1 * torch.randn((shape[-1],), generator=gen, device=dev)
    return x.to(dtype), w


def _bf16_ulp(t):
    """The spacing of bfloat16 numbers (8 significant bits) at |t|."""
    return torch.ldexp(torch.ones_like(t), torch.frexp(t)[1] - 8)


def _assert_ln_close(got, x, w):
    """bfloat16: within one bfloat16 step of the float32 formula on the
    same input (the kernel rounds its float32 result once); float32:
    within 1e-6 relative of the formula (the sums taken in another
    order)."""
    ref = k8.biasfree_layernorm_plain(x.float(), w, 1e-5)
    gap = (got.float() - ref).abs()
    if got.dtype == torch.bfloat16:
        assert bool((gap <= _bf16_ulp(ref)).all()), float(gap.max())
    else:
        assert bool((gap <= 1e-6 * ref.abs()).all()), \
            float((gap / ref.abs()).max())
    return float(gap.max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 16, 63])
@pytest.mark.parametrize("level", list(K7_LEVELS))
def test_biasfree_layernorm_kernel_matches_plain(dev, level, b, dtype):
    """K8 at every Restormer level's shape (K7's) against the float32
    formula on the same input; each call counts one launch."""
    side, ch, _ = K7_LEVELS[level]
    x, w = _ln_inputs(dev, (b, side, side, ch), dtype, b)
    before = k8.launches
    got = k8.biasfree_layernorm(x, w, 1e-5)
    torch.cuda.synchronize()
    assert k8.launches == before + 1
    assert got.shape == x.shape and got.dtype == dtype
    gap = _assert_ln_close(got, x, w)
    print(f"biasfree_layernorm {level} B={b} {dtype}: largest gap "
          f"{gap:.3e}")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [16, 128, 200])
def test_biasfree_layernorm_kernel_takes_other_widths(dev, c, dtype):
    """Widths outside Restormer's (the tests' Restormer runs 16-128) go
    through the generic build, on a row count that leaves the last CTA
    partial."""
    x, w = _ln_inputs(dev, (3, 7, 5, c), dtype, c)
    _assert_ln_close(k8.biasfree_layernorm(x, w, 1e-5), x, w)


def test_biasfree_layernorm_kernel_in_cuda_graph_is_bit_equal_to_eager(dev):
    """A replay of a captured call writes the eager call's output bit for
    bit."""
    side, ch, _ = K7_LEVELS["decoder1"]
    x, w = _ln_inputs(dev, (16, side, side, ch), torch.bfloat16, 3)
    want = k8.biasfree_layernorm(x, w, 1e-5)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        k8.biasfree_layernorm(x, w, 1e-5)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = k8.biasfree_layernorm(x, w, 1e-5)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("case,error", [
    ("strided", ValueError), ("float16", TypeError), ("weight", ValueError),
    ("width", ValueError), ("devices", ValueError), ("wide", ValueError),
    ("unaligned", ValueError)])
def test_biasfree_layernorm_kernel_refuses(dev, case, error):
    x = torch.zeros((2, 8, 8, 48), device=dev, dtype=torch.bfloat16)
    w = torch.ones(48, device=dev)
    if case == "strided":
        x = x.transpose(1, 2)
    elif case == "float16":
        x = x.half()
    elif case == "weight":
        w = torch.ones(96, device=dev)
    elif case == "width":
        x, w = torch.zeros((2, 8, 8, 44), device=dev), torch.ones(44,
                                                                  device=dev)
    elif case == "devices":
        w = w.cpu()
    elif case == "wide":
        x, w = torch.zeros((2, 4, 392), device=dev), torch.ones(392,
                                                                device=dev)
    else:
        x = torch.zeros(2 * 8 * 8 * 48 + 1, device=dev,
                        dtype=torch.bfloat16)[1:].view(2, 8, 8, 48)
    before = k8.launches
    with pytest.raises(error):
        k8.biasfree_layernorm(x, w, 1e-5)
    assert k8.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["none", "s2d", "pallas", "winograd",
                                  "winograd_deep"])
def test_unet_forward_launches_upsample_concat_on_card(dev, monkeypatch,
                                                        mode, dtype):
    """Every U-Net mode launches K6 once a decoder level, four a forward,
    and its output equals the same forward with the composition K6
    replaced (``F.interpolate``, pad, ``torch.cat``) bit for bit."""
    from dt4image_restoration_tpu_torch.models import unet
    model = UNetDenoiser(dtype=dtype, packed=mode)
    model.load_state_dict(random_unet_state_dict(0))
    model = model.eval().requires_grad_(False).to(dev)
    x = torch.rand((3, 1, 128, 128), device=dev)
    sigma = torch.tensor([0.05, 0.1, 0.2], device=dev)
    model(x, sigma)                  # packs the weights, warms cuDNN up
    kernels.reset_launch_counts()
    got = model(x, sigma)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["upsample_concat"] == 4
    monkeypatch.setattr(unet, "upsample_concat", _interpolate_pad_cat)
    kernels.reset_launch_counts()
    ref = model(x, sigma)
    assert kernels.launch_counts()["upsample_concat"] == 0
    assert torch.equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("shape", [(16, 4, 18, 32), (63, 4, 18, 32),
                                   (3, 4, 12, 32), (2, 2, 32, 64),
                                   (1, 3, 1, 20)])
def test_attention_kernel_matches_plain(dev, shape):
    """Contiguous inputs; the refusals: T past 96, a last stride that is
    not 1."""
    rng = np.random.default_rng(4)
    q, k, v = (_f32(rng, shape).to(dev) for _ in range(3))
    before = k4.launches
    got = k4.fused_causal_attention(q, k, v)
    torch.cuda.synchronize()
    assert k4.launches == before + 1
    ref = k4.fused_causal_attention_plain(q, k, v)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    strided = torch.zeros(shape[:-1] + (2 * shape[-1],), device=dev)
    with pytest.raises(ValueError, match="last stride of 1"):
        k4.fused_causal_attention(strided[..., ::2], k, v)
    with pytest.raises(ValueError, match="T <= 96"):
        x = torch.zeros((1, 1, 97, 8), device=dev)
        k4.fused_causal_attention(x, x, x)


def _qkv_views(x, h):
    """q, k, v as the per-op forward cuts them from its (B, T, 3E)
    projection: (B, H, T, D) views with a last stride of 1."""
    b, t, e3 = x.shape
    return tuple(a.reshape(b, t, h, e3 // (3 * h)).transpose(1, 2)
                 for a in x.split(e3 // 3, dim=-1))


@pytest.mark.parametrize("b,h,d", [(16, 4, 32), (63, 4, 32), (2, 2, 64),
                                   (3, 4, 16), (2, 1, 6)])
@pytest.mark.parametrize("t", [1, 18, 32, 33, 90, 96])
def test_attention_kernel_on_strided_views(dev, b, h, d, t):
    """K4 on the views of one (B, T, 3E) tensor, max abs error <= 1e-5
    against the plain version; its output is the (B, H, T, D) view of a
    contiguous (B, T, H, D) tensor, so merging the heads copies nothing.
    D = 6 takes the 4-byte copies."""
    x = _f32(np.random.default_rng(10), (b, t, 3 * h * d)).to(dev)
    q, k, v = _qkv_views(x, h)
    before = k4.launches
    got = k4.fused_causal_attention(q, k, v)
    torch.cuda.synchronize()
    assert k4.launches == before + 1
    assert got.shape == (b, h, t, d) and got.transpose(1, 2).is_contiguous()
    ref = k4.fused_causal_attention_plain(q, k, v)
    assert float((got - ref).abs().max()) <= 1e-5


def _graph_replay(fn):
    """``fn()``'s result from one replay of a CUDA graph that captured it."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    return out


def test_attention_kernel_in_cuda_graph(dev):
    """K4 captured in a CUDA graph behind the product that feeds it, as in
    the per-op forward, and replayed."""
    rng = np.random.default_rng(11)
    x = _f32(rng, (16, 18, 128)).to(dev)
    w = _f32(rng, (384, 128), 0.1).to(dev)

    def fn():
        return k4.fused_causal_attention(*_qkv_views(x @ w.t(), 4))
    got = _graph_replay(fn)
    ref = k4.fused_causal_attention_plain(*_qkv_views(x @ w.t(), 4))
    assert float((got - ref).abs().max()) <= 1e-5


@pytest.mark.parametrize("shape", [(288, 128), (1134, 128), (4, 18, 128)])
def test_layernorm_kernel_in_cuda_graph(dev, shape):
    """K5 captured in a CUDA graph behind the op that feeds it and
    replayed, at the search's and the evaluation's rows."""
    rng = np.random.default_rng(12)
    e = shape[-1]
    x = (_f32(rng, shape) + 3.0).to(dev)
    scale = (1 + _f32(rng, (e,), 0.1)).to(dev)
    bias = _f32(rng, (e,), 0.1).to(dev)
    got = _graph_replay(lambda: k5.layernorm(x * 2.0, scale, bias))
    ref = k5.layernorm_plain(x * 2.0, scale, bias)
    assert float((got - ref).abs().max()) <= 1e-5


@pytest.mark.parametrize("shape", [(288, 128), (1134, 128), (1, 128),
                                   (7, 128), (4, 18, 128), (5, 68),
                                   (3, 1024)])
def test_layernorm_kernel_matches_plain(dev, shape):
    rng = np.random.default_rng(5)
    e = shape[-1]
    x = (_f32(rng, shape) + 3.0).to(dev)
    scale = (1 + _f32(rng, (e,), 0.1)).to(dev)
    bias = _f32(rng, (e,), 0.1).to(dev)
    before = k5.launches
    got = k5.layernorm(x, scale, bias)
    torch.cuda.synchronize()
    assert k5.launches == before + 1
    ref = k5.layernorm_plain(x, scale, bias)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    strided = torch.zeros((8, 2 * e), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        k5.layernorm(strided[:, ::2], scale, bias)


def test_layernorm_kernel_refuses_unsupported_width(dev):
    x = torch.zeros((2, 66), device=dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        k5.layernorm(x, torch.ones(66, device=dev),
                     torch.zeros(66, device=dev))


@pytest.mark.parametrize("three_token", [True, False])
def test_per_op_dt_on_card_matches_cpu(dev, three_token):
    """The per-op forward with use_pallas launches K4 once and K5 twice per
    block (and K5 once more for the final norm) and matches the CPU."""
    cfg = ModelConfig(use_pallas=True)
    dt = DecisionTransformer(cfg).eval().requires_grad_(False)
    dt.load_state_dict(init_dt_params(cfg, seed=1))
    rng = np.random.default_rng(6)
    args = [_f32(rng, (4, 6, 1)), torch.from_numpy(rng.uniform(
        0, 1, (4, 6, 128 * 128)).astype(np.float32)),
        torch.arange(6).expand(4, 6), torch.full((4, 6), 2),
        _f32(rng, (4, 6, 3)) if three_token else None]
    ref = make_dt_apply(dt)(*args)
    dt.to(dev)
    a4, a5 = k4.launches, k5.launches
    got = make_dt_apply(dt)(*[None if a is None else a.to(dev)
                              for a in args])
    torch.cuda.synchronize()
    assert (k4.launches - a4, k5.launches - a5) == (5, 11)
    torch.testing.assert_close(got.pred_actions.cpu(), ref.pred_actions,
                               rtol=1e-4, atol=1e-5)
    if three_token:
        torch.testing.assert_close(got.pred_rtg.cpu(), ref.pred_rtg,
                                   rtol=1e-4, atol=1e-5)


def test_search_on_card_matches_cpu(dev, tmp_path):
    """Three search rounds of two trees at the published widths: the card's
    traces equal the CPU's, priors and rewards agree."""
    cfg = ModelConfig(use_pallas=True)
    d = write_eval_dir(str(tmp_path / "4_15"), "4_15", n=2, seed=9)
    records = [EvaluationDataset(d, 5.0)[i] for i in range(2)]
    runs = []
    for device in ("cpu", dev):
        dt = DecisionTransformer(cfg).eval().requires_grad_(False)
        dt.load_state_dict(init_dt_params(cfg, seed=0))
        with torch.no_grad():
            dt.predict_action.bias[0] = -3.0   # T: no early stops
        unet = UNetDenoiser().eval().requires_grad_(False)
        unet.load_state_dict(random_unet_state_dict(0))
        m = MCTS(dt=dt.to(device), denoise=unet.to(device), model_cfg=cfg,
                 cfg=MCTSConfig(iterations=3, max_timesteps=8),
                 value_fn=proxy_value_fn, record_trace=True, device=device)
        runs.append((m.run_batch(records, seeds=[0, 1]), m.traces))
    (r_cpu, t_cpu), (r_gpu, t_gpu) = runs
    key = ("iter", "time", "edge", "index")
    for a, b in zip(t_gpu, t_cpu):
        assert [[e[k] for k in key] for e in a] \
            == [[e[k] for k in key] for e in b]
        for x, y in zip(a, b):
            np.testing.assert_allclose(x["probs"], y["probs"], rtol=1e-4)
    np.testing.assert_allclose(r_gpu, r_cpu, rtol=0, atol=0.05)


def _long_window_policy(cfg, device):
    dt = DecisionTransformer(cfg).eval().requires_grad_(False)
    dt.load_state_dict(init_dt_params(cfg, seed=0))
    with torch.no_grad():
        dt.predict_action.bias[0] = -3.0   # T: no early stops
    return dt.to(device)


@pytest.mark.parametrize("block_size", [36, 90])
def test_evaluator_on_card_matches_cpu_at_long_windows(dev, tmp_path,
                                                       block_size):
    """Past K3's 32 tokens the evaluator runs the per-op forward (K4, K5)
    on the card; two slices match the CPU run: equal episode lengths,
    rewards within 0.05 dB."""
    cfg = ModelConfig(block_size=block_size, use_pallas=True)
    assert not fused_forward_takes(cfg)
    d = write_eval_dir(str(tmp_path / "4_15"), "4_15", n=2, seed=13)
    records = [EvaluationDataset(d, 10.0)[i] for i in range(2)]
    unet = UNetDenoiser().eval().requires_grad_(False)
    unet.load_state_dict(random_unet_state_dict(0))
    runs = {}
    for device in ("cpu", dev):
        kernels.reset_launch_counts()
        runs[str(device)] = Evaluator(
            dt=_long_window_policy(cfg, device), denoise=unet.to(device),
            cfg=cfg, max_timesteps=30, device=device).evaluate_records(
                records)
        counts = kernels.launch_counts()
    assert counts["dt_decode"] == 0
    assert counts["attention"] > 0 and counts["layernorm"] > 0
    cpu, gpu = runs["cpu"], runs[str(dev)]
    np.testing.assert_array_equal(gpu["episode_len"], cpu["episode_len"])
    assert np.all(gpu["episode_len"] == 30)
    np.testing.assert_allclose(gpu["reward"], cpu["reward"], rtol=0,
                               atol=0.05)


@pytest.mark.parametrize("block_size,use_pallas,refused", [
    (36, False, True), (90, False, True), (36, True, False),
    (18, False, False)])
def test_evaluator_refuses_per_op_forward_without_kernels(
        dev, block_size, use_pallas, refused):
    """Past K3's 32 tokens the evaluator's per-op forward must run K4 and
    K5 on the card: a policy built without ``use_pallas`` is refused when
    the evaluator is made, before anything launches. Up to 32 tokens the
    fused forward runs and the flag does not matter."""
    cfg = ModelConfig(block_size=block_size, use_pallas=use_pallas)
    dt = DecisionTransformer(cfg).eval().requires_grad_(False).to(dev)
    kw = dict(dt=dt, denoise=lambda x, sigma: x, cfg=cfg, device=dev)
    if refused:
        with pytest.raises(ValueError, match="use_pallas=True"):
            Evaluator(**kw)
        # A forward the caller hands over is run as it is.
        Evaluator(dt_apply=make_dt_apply(dt), **kw)
    else:
        Evaluator(**kw)


@pytest.mark.parametrize("block_size", [36, 90])
def test_search_on_card_matches_cpu_at_long_windows(dev, tmp_path,
                                                    block_size):
    """Two search rounds of one tree with 12- and 30-timestep windows: the
    card's trace equals the CPU's, priors and reward agree."""
    cfg = ModelConfig(block_size=block_size, use_pallas=True)
    d = write_eval_dir(str(tmp_path / "4_15"), "4_15", n=1, seed=14)
    record = EvaluationDataset(d, 5.0)[0]
    runs = []
    for device in ("cpu", dev):
        unet = UNetDenoiser().eval().requires_grad_(False)
        unet.load_state_dict(random_unet_state_dict(0))
        m = MCTS(dt=_long_window_policy(cfg, device), denoise=unet.to(device),
                 model_cfg=cfg,
                 cfg=MCTSConfig(iterations=2, max_timesteps=30),
                 value_fn=proxy_value_fn, record_trace=True, device=device)
        runs.append((m.run(record, seed=0), m.traces[0]))
    (r_cpu, t_cpu), (r_gpu, t_gpu) = runs
    key = ("iter", "time", "edge", "index")
    assert [[e[k] for k in key] for e in t_gpu] \
        == [[e[k] for k in key] for e in t_cpu]
    for x, y in zip(t_gpu, t_cpu):
        np.testing.assert_allclose(x["probs"], y["probs"], rtol=1e-4)
    assert abs(r_gpu - r_cpu) <= 0.05


@pytest.mark.parametrize("verb", ["eval", "flex", "mcts"])
@pytest.mark.parametrize("block_size", [36, 90])
def test_verbs_on_card_at_long_windows(dev, tmp_path, monkeypatch, capsys,
                                       verb, block_size):
    """The verbs run --block_size 36 and 90 on the card with kernels K4
    and K5 (the search cut to two rounds) and print finite results."""
    from dt4image_restoration_tpu_torch import __main__ as cli
    from dt4image_restoration_tpu_torch import config
    d = write_eval_dir(str(tmp_path / "4_15"), "4_15", n=1, seed=15)
    monkeypatch.setattr(config, "MCTSConfig",
                        functools.partial(config.MCTSConfig, iterations=2))
    args = ["--block_size", str(block_size), "--n_embeds",
            "6" if verb == "flex" else "9", "--device", "cuda", verb]
    if verb != "flex":
        args += ["--rtg", "5"]
    kernels.reset_launch_counts()
    cli.main(args + ["--max_timesteps", "30", "--checkpoint",
                     str(tmp_path / "n.pt"), "--denoiser_ckpt",
                     str(tmp_path / "n.pt"), "--data_dirs", d])
    counts = kernels.launch_counts()
    r = capsys.readouterr()
    assert counts["dt_decode"] == 0
    assert counts["attention"] > 0 and counts["layernorm"] > 0
    if verb != "mcts":
        assert "policy forward: per-op (kernels K4, K5)" in r.err
    numbers = [float(ln.rsplit(",", 1)[1] if "," in ln
                     else ln.split(":", 1)[1])
               for ln in r.out.splitlines()
               if ln.startswith(("Average reward", "MCTS Reward:",
                                 "Total MCTS reward:"))]
    assert numbers and all(np.isfinite(numbers)), r.out


# --- training ------------------------------------------------------------

def _train_batch(rng, b=8, t=6):
    """A batch of the published shapes whose rows keep 6 - i % 4 valid
    timesteps."""
    masks = (np.arange(t)[None, :] < (t - np.arange(b) % 4)[:, None]
             ).astype(np.float32)[..., None]
    return {"states": rng.uniform(0, 1, (b, t, 128 * 128)).astype(np.float32)
            * masks,
            "actions": rng.uniform(0, 1, (b, t, 3)).astype(np.float32)
            * masks,
            "rtg": rng.uniform(0, 1, (b, t, 1)).astype(np.float32) * masks,
            "traj_masks": masks,
            "timesteps": np.broadcast_to(np.arange(t, dtype=np.int32)[
                None, :, None], (b, t, 1)).copy(),
            "task": rng.integers(0, 9, (b, t)).astype(np.int32)}


def _train_run(device, batches, tcfg, **cfg_kw):
    from dt4image_restoration_tpu_torch.training import (init_train_state,
                                                         make_train_step,
                                                         shard_batch)
    cfg = ModelConfig(**cfg_kw)
    model = DecisionTransformer(cfg)
    model.load_state_dict(init_dt_params(cfg, seed=0))
    state = init_train_state(model.to(device), tcfg, 10)
    step = make_train_step()
    losses = [float(step(state, shard_batch(b, device))) for b in batches]
    return losses, {n: p.detach().cpu() for n, p in model.named_parameters()}


def test_train_steps_on_card_match_cpu(dev):
    """Three updates at the published widths (dropout off, warmup 2) on
    the card and on the CPU: losses within 1e-5 relative, every parameter
    tensor within 2e-4 (norm of the error over the tensor's norm; and
    largest error over its largest value, but for the QKV biases, whose
    key thirds have gradients of pure rounding noise)."""
    from dt4image_restoration_tpu_torch.config import TrainerConfig
    rng = np.random.default_rng(8)
    batches = [_train_batch(rng) for _ in range(3)]
    tcfg = TrainerConfig(warmup_steps=2)
    kernels.reset_launch_counts()
    gpu = _train_run(dev, batches, tcfg, dropout=0.0, embd_dropout=0.0)
    assert not any(kernels.launch_counts().values())
    cpu = _train_run("cpu", batches, tcfg, dropout=0.0, embd_dropout=0.0)
    np.testing.assert_allclose(gpu[0], cpu[0], rtol=1e-5)
    for name, ref in cpu[1].items():
        got, ref = gpu[1][name].double(), ref.double()
        assert (got - ref).norm() <= 2e-4 * ref.norm(), name
        if not name.endswith("qkv_proj.bias"):
            assert (got - ref).abs().max() <= 2e-4 * ref.abs().max(), name


def test_train_resume_on_card_equals_straight_run(dev, tmp_path):
    """Two updates, a stop request (the SIGTERM path's save), a Trainer
    resuming from state_latest.pt on other initial weights, two more
    updates: the weights equal four straight updates (dropout on, cuDNN's
    deterministic algorithms)."""
    from dt4image_restoration_tpu_torch.config import TrainerConfig
    from dt4image_restoration_tpu_torch.training import (Trainer,
                                                         init_train_state,
                                                         make_train_step)
    rng = np.random.default_rng(9)
    batches = [_train_batch(rng) for _ in range(4)]
    tcfg = TrainerConfig(max_epochs=1)

    def run(name, data, seed=0, stop_after=None, **kw):
        cfg = ModelConfig()
        model = DecisionTransformer(cfg)
        model.load_state_dict(init_dt_params(cfg, seed=seed))
        step, calls = make_train_step(), []

        def counted(state, batch):
            calls.append(1)
            loss = step(state, batch)
            if len(calls) == stop_after:
                trainer.request_stop()
            return loss

        trainer = Trainer(train_step=counted,
                          state=init_train_state(model.to(dev), tcfg, 4),
                          config=tcfg, batches=lambda e: iter(data),
                          checkpoint_dir=str(tmp_path / name), **kw)
        trainer.train()
        return trainer

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        straight = run("straight", batches)
        first = run("first", batches, stop_after=2)
        resumed = run("resumed", batches[2:], seed=1, resume_from=str(
            tmp_path / "first" / "state_latest.pt"))
    finally:
        torch.backends.cudnn.deterministic = prev
    assert (first.state.step, resumed.state.step) == (2, 4)
    ref = dict(straight.state.model.named_parameters())
    for name, p in resumed.state.model.named_parameters():
        torch.testing.assert_close(p, ref[name], rtol=1e-6, atol=0)


def test_step_timer_waits_for_the_device(dev):
    """On CUDA a step's time includes the device work it queued."""
    from dt4image_restoration_tpu_torch.utils.profiling import StepTimer
    timer = StepTimer(dev)
    torch.cuda.synchronize()
    with timer:
        torch.cuda._sleep(200_000_000)     # ~0.1 s of device spinning
    assert timer.times[0] > 0.03
    assert set(timer.summary()) == {"steps", "mean_s", "p50_s", "p95_s",
                                    "total_s"}


def test_trace_if_enabled_writes_device_trace(dev, tmp_path):
    import json as _json

    from dt4image_restoration_tpu_torch.utils.profiling import (
        TRACE_FILE, annotate, region_breakdown, trace_if_enabled)
    x = torch.randn((512, 512), device=dev)
    with trace_if_enabled(str(tmp_path)):
        with annotate("matmuls"):
            for _ in range(4):
                x = x @ x / 512
            torch.cuda.synchronize()
    with open(tmp_path / TRACE_FILE) as f:
        events = _json.load(f)["traceEvents"]
    region = region_breakdown(events, "matmuls")
    assert region["device_ops"] >= 4 and region["device_ms"] > 0
    assert 0 <= region["device_idle_share"] < 1


def test_unet_span_holds_its_kernels_launches_on_one_clock(dev, tmp_path):
    """The kernels launched inside a ``dt4ir.unet`` span (the launch's
    correlation id) start after the span starts, on the trace's one clock:
    the program's spans and the device's work can be laid side by side."""
    import json as _json

    from dt4image_restoration_tpu_torch.utils.profiling import (
        TRACE_FILE, UNET, trace_if_enabled)
    model = UNetDenoiser().to(dev).eval().requires_grad_(False)
    x = torch.rand((1, 1, 128, 128), device=dev)
    sigma = torch.full((1,), 0.05, device=dev)
    model(x, sigma)
    torch.cuda.synchronize()
    with trace_if_enabled(str(tmp_path)):
        for _ in range(2):
            model(x, sigma)
        torch.cuda.synchronize()
    with open(tmp_path / TRACE_FILE) as f:
        events = [e for e in _json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
              (e.get("pid"), e.get("tid"))) for e in events
             if e.get("name") == UNET and e.get("cat") == "user_annotation"]
    assert len(spans) == 2
    launches = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and corr:
            launches[corr] = (float(e["ts"]), (e.get("pid"), e.get("tid")))
    held = []
    for e in events:
        if e.get("cat") != "kernel":
            continue
        launch = launches.get((e.get("args") or {}).get("correlation"))
        if launch is None:
            continue
        for s0, s1, th in spans:
            if th == launch[1] and s0 <= launch[0] <= s1:
                held.append((s0, launch[0], float(e["ts"])))
    # Every U-Net forward launches dozens of kernels.
    assert len(held) >= 2 * 20
    for s0, t_launch, t_kernel in held:
        assert s0 <= t_launch <= t_kernel


def test_bfloat16_train_step_on_card(dev):
    """--dtype bfloat16 on the card: forward and loss under autocast, the
    loss within 2e-2 of the float32 loss (bfloat16 keeps 8 bits of
    mantissa); weights and gradients stay float32."""
    from dt4image_restoration_tpu_torch.config import TrainerConfig
    from dt4image_restoration_tpu_torch.training import (init_train_state,
                                                         make_train_step,
                                                         shard_batch)
    from dt4image_restoration_tpu_torch.training.trainer import loss_fn
    cfg = ModelConfig(dropout=0.0, embd_dropout=0.0)
    model = DecisionTransformer(cfg)
    model.load_state_dict(init_dt_params(cfg, seed=2))
    state = init_train_state(model.to(dev), TrainerConfig(), 10)
    batch = shard_batch(_train_batch(np.random.default_rng(10)), dev)
    with torch.no_grad():
        f32 = float(loss_fn(model.train(), batch))
    loss = float(make_train_step("bfloat16")(state, batch))
    assert abs(loss - f32) <= 2e-2 * abs(f32)
    assert loss != f32                  # bfloat16 products did run
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())


# --- device search and serving -------------------------------------------

def _search_models(device, block_size=18):
    cfg = ModelConfig(block_size=block_size, use_pallas=True)
    unet = UNetDenoiser().eval().requires_grad_(False)
    unet.load_state_dict(random_unet_state_dict(0))
    return _long_window_policy(cfg, device), unet.to(device), cfg


def _quantized(x):
    """A scorer that float reordering between devices cannot move."""
    return torch.round(x.mean(dim=(1, 2)) * 1e3) / 10.0


def test_device_search_on_card_matches_host_and_cpu(dev, tmp_path):
    """Three rounds of two trees at the published widths: the device
    search on the card has the host search's traces on the card and its
    own on the CPU; priors within 1e-4, final PSNR within 0.05 dB. It runs
    K1, K2, K4 and K5."""
    d = write_eval_dir(str(tmp_path / "4_15"), "4_15", n=2, seed=9)
    records = [EvaluationDataset(d, 5.0)[i] for i in range(2)]
    runs = {}
    for name, cls, device in (("device card", DeviceMCTS, dev),
                              ("host card", MCTS, dev),
                              ("device cpu", DeviceMCTS, "cpu")):
        dt, unet, cfg = _search_models(device)
        kw = dict(value_fn_batched=_quantized) if cls is DeviceMCTS else {}
        m = cls(dt=dt, denoise=unet, model_cfg=cfg,
                cfg=MCTSConfig(iterations=3, max_timesteps=8),
                value_fn=lambda x: float(_quantized(torch.as_tensor(
                    np.asarray(x, np.float32)).reshape(1, 128, 128))[0]),
                record_trace=True, device=device, **kw)
        kernels.reset_launch_counts()
        runs[name] = (m.run_batch(records, seeds=[0, 1]), m.traces,
                      kernels.launch_counts())
    rewards, traces, counts = runs["device card"]
    assert all(counts[k] > 0 for k in ("conv_block", "kspace", "attention",
                                       "layernorm"))
    key = ("iter", "time", "edge", "index")
    for other in ("host card", "device cpu"):
        for a, b in zip(traces, runs[other][1]):
            assert [[e[k] for k in key] for e in a] \
                == [[e[k] for k in key] for e in b], other
            for x, y in zip(a, b):
                np.testing.assert_allclose(x["probs"], y["probs"],
                                           rtol=1e-4)
        np.testing.assert_allclose(rewards, runs[other][0], rtol=0,
                                   atol=0.05)


def test_device_search_bfloat16_nodes_on_card(dev, tmp_path):
    """bfloat16 node storage on the card: within 0.05 dB of float32."""
    d = write_eval_dir(str(tmp_path / "4_15"), "4_15", n=2, seed=9)
    records = [EvaluationDataset(d, 5.0)[i] for i in range(2)]
    dt, unet, cfg = _search_models(dev)
    out = [DeviceMCTS(dt=dt, denoise=unet, model_cfg=cfg,
                      cfg=MCTSConfig(iterations=3, max_timesteps=8),
                      value_fn=proxy_value_fn,
                      value_fn_batched=proxy_value_fn_batched,
                      node_dtype=nd, device=dev).run_batch(
                          records, seeds=[0, 1], verbose=False)
           for nd in ("float32", "bfloat16")]
    np.testing.assert_allclose(out[1], out[0], rtol=0, atol=0.05)


def _serve(device, mode, requests, **kw):
    from dt4image_restoration_tpu_torch.serving import RestorationService
    dt, unet, _ = _search_models(device)
    if mode == "mcts":
        kw["search_cfg"] = MCTSConfig(iterations=2, max_timesteps=8)
    svc = RestorationService(denoise=unet, dt=dt, mode=mode, batch_size=4,
                             max_timesteps=8, device=device, **kw)
    try:
        return svc.restore(requests, timeout=600)
    finally:
        svc.close(timeout=600)


@pytest.mark.parametrize("mode,want", [
    ("policy", ("conv_block", "kspace", "dt_decode")),
    ("fixed", ("conv_block", "kspace")),
    ("mcts", ("conv_block", "kspace", "attention", "layernorm"))])
def test_serving_modes_on_card_match_cpu(dev, mode, want):
    """Three requests (a padded batch of 4) served on the card and on the
    CPU: equal episode lengths, PSNR within 0.05 dB; the card's run
    launches the mode's kernels."""
    from dt4image_restoration_tpu_torch.data import make_mat_record
    from dt4image_restoration_tpu_torch.serving import RestorationRequest
    reqs = [RestorationRequest(mat=make_mat_record(seed=i), rtg=5.0, task=2)
            for i in range(3)]
    kernels.reset_launch_counts()
    card = _serve(dev, mode, reqs)
    counts = kernels.launch_counts()
    cpu = _serve("cpu", mode, reqs)
    assert all(counts[k] > 0 for k in want), counts
    for a, b in zip(card, cpu):
        assert a.episode_len == b.episode_len
        assert abs(a.psnr_db - b.psnr_db) <= 0.05
        assert a.image.shape == (128, 128)


@pytest.mark.parametrize("mode", ["policy", "fixed"])
def test_pipelined_service_on_card_matches_unpipelined(dev, mode):
    """pipeline_depth=2 on the card (the side-stream copy to pinned host
    memory) returns what the inline path does, over 3 batches."""
    from dt4image_restoration_tpu_torch.data import make_mat_record
    from dt4image_restoration_tpu_torch.serving import RestorationRequest
    reqs = [RestorationRequest(mat=make_mat_record(seed=i), rtg=5.0, task=2)
            for i in range(10)]
    want = _serve(dev, mode, reqs)
    got = _serve(dev, mode, reqs, pipeline_depth=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.image, w.image)
        assert g.episode_len == w.episode_len and g.psnr_db == w.psnr_db


@pytest.mark.parametrize("mode,block_size,use_pallas,refused", [
    ("policy", 36, False, True), ("policy", 36, True, False),
    ("policy", 18, False, False), ("mcts", 18, False, True),
    ("mcts", 18, True, False)])
def test_service_refuses_per_op_forward_without_kernels(
        dev, mode, block_size, use_pallas, refused):
    """On the card, a service whose policy would run the per-op forward
    without K4 and K5 is refused when it is made."""
    from dt4image_restoration_tpu_torch.serving import RestorationService
    cfg = ModelConfig(block_size=block_size, use_pallas=use_pallas)
    dt = DecisionTransformer(cfg).eval().requires_grad_(False).to(dev)
    kw = dict(denoise=lambda x, sigma: x, dt=dt, mode=mode, device=dev)
    if refused:
        with pytest.raises(ValueError, match="use_pallas=True"):
            RestorationService(**kw)
    else:
        RestorationService(**kw).close(timeout=60)


# --- bfloat16 and the U-Net's execution modes ------------------------------

def _bf16_block(rng, cin, feats, layers, dev):
    ws, bs = [], []
    for i in range(layers):
        ws.append(_f32(rng, (feats, cin if i == 0 else feats, 3, 3), 0.1))
        bs.append(_f32(rng, (feats,), 0.1))
    return k1.pack_conv_block([w.to(dev) for w in ws],
                              [b.to(dev) for b in bs],
                              dtype=torch.bfloat16)


@pytest.mark.parametrize("shape,feats,layers", [
    ((2, 2, 128, 128), 32, 3),   # the U-Net's inc
    ((2, 96, 128, 128), 32, 3),  # the U-Net's up4: 6 chunks an item
    ((96, 96, 128, 128), 32, 3),  # up4 at the search's expansion batch
    ((3, 96, 128, 128), 32, 3),  # 192 work items: not a multiple of grid
    ((2, 2, 40, 36), 32, 3),     # ragged 16x16 tiles, element-wise loads
    ((1, 24, 37, 50), 8, 3),     # odd sizes, F = 8 (zero pad planes)
    ((2, 5, 18, 17), 24, 2),     # odd Cin, F = 24
    ((1, 3, 7, 9), 16, 1),       # smaller than one tile
    ((2, 176, 40, 48), 32, 3),   # layer 0's weights carried by each stage
    ((1, 7, 33, 40), 32, 4),     # 4 layers: 9 m64 tiles at layer 0
])
def test_conv_block_bf16_kernel_matches_plain(dev, shape, feats, layers):
    """K1 in bfloat16 against its plain version: both sum in float32 in
    another order and round each layer to bfloat16, so a value may come
    out a bfloat16 step apart; the band is two steps of the largest
    output (2^-6 x max |plain|)."""
    from dt4image_restoration_tpu_torch.ops.kernels import conv_block_bf16
    rng = np.random.default_rng(7)
    packed = _bf16_block(rng, shape[1], feats, layers, dev)
    x = _f32(rng, shape).to(dev).to(torch.bfloat16)
    before = conv_block_bf16.launches
    got = k1.conv_block(x, packed)
    torch.cuda.synchronize()
    assert conv_block_bf16.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == \
        (shape[0], feats) + shape[2:]
    ref = k1.conv_block_plain(x, packed).float()
    err = float((got.float() - ref).abs().max())
    assert err <= 2.0 ** -6 * float(ref.abs().max()), err


def test_conv_block_bf16_kernel_is_deterministic_and_takes_unaligned_input(
        dev):
    """Two launches on one stream give bit-equal output (no atomics, a
    fixed order of products), and an input that starts off a 16-byte
    boundary takes the element-wise path to the same result."""
    from dt4image_restoration_tpu_torch.ops.kernels import conv_block_bf16
    rng = np.random.default_rng(11)
    packed = _bf16_block(rng, 96, 32, 3, dev)
    x = _f32(rng, (5, 96, 128, 128)).to(dev).to(torch.bfloat16)
    a = k1.conv_block(x, packed)
    b = k1.conv_block(x, packed)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:]
    shifted = shifted.view(x.shape).copy_(x)
    assert not conv_block_bf16.vector_path(shifted)
    assert torch.equal(k1.conv_block(shifted, packed), a)


def test_conv_block_bf16_kernel_refuses_float32_input(dev):
    packed = _bf16_block(np.random.default_rng(0), 2, 8, 2, dev)
    with pytest.raises(TypeError, match="bfloat16"):
        k1.conv_block(torch.zeros((1, 2, 16, 16), device=dev), packed)


def test_pallas_bfloat16_denoiser_launches_bf16_kernel(dev):
    """The U-Net's default mode in bfloat16 runs the bfloat16 K1 at inc and
    up4 on the card, not the float32 one nor cuDNN in their place, and
    agrees with the CPU (the plain bfloat16 K1) within the bfloat16
    band of the U-Net."""
    from dt4image_restoration_tpu_torch.ops.kernels import conv_block_bf16
    model = UNetDenoiser(dtype="bfloat16", packed="pallas")
    model.load_state_dict(random_unet_state_dict(0))
    model.eval().requires_grad_(False)
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (2, 1, 64, 64)).astype(np.float32))
    sigma = torch.tensor([0.05, 0.1])
    ref = model(x, sigma)
    kernels.reset_launch_counts()
    got = model.to(dev)(x.to(dev), sigma.to(dev))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["conv_block_bf16"] == 2 and counts["conv_block"] == 0
    assert conv_block_bf16.launches == 2
    assert got.dtype == torch.float32
    assert float((got.cpu() - ref).abs().mean()) < 2e-3
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=5e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["none", "s2d", "pallas", "winograd",
                                  "winograd_deep"])
def test_unet_modes_on_card_match_cpu(dev, mode, dtype):
    """Every --unet_packed mode on the card against the same mode on the
    CPU: float32 within the U-Net band (1e-3 rel, 2e-4 abs); bfloat16
    (cuDNN and the CPU round at other places) within 2e-3 on average."""
    model = UNetDenoiser(dtype=dtype, packed=mode)
    model.load_state_dict(random_unet_state_dict(0))
    model.eval().requires_grad_(False)
    x = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (2, 1, 64, 64)).astype(np.float32))
    sigma = torch.tensor([0.05, 0.1])
    ref = model(x, sigma)
    got = model.to(dev)(x.to(dev), sigma.to(dev)).cpu()
    if dtype == "float32":
        torch.testing.assert_close(got, ref, rtol=1e-3, atol=2e-4)
    else:
        assert float((got - ref).abs().mean()) < 2e-3
        torch.testing.assert_close(got, ref, rtol=0, atol=5e-2)


def test_bfloat16_eval_on_card_matches_cpu(dev, tmp_path):
    """Greedy evaluation with --dtype bfloat16 (bfloat16 K1, K2, K3) on two
    slices: equal episode lengths and rewards within 0.15 dB of the CPU
    run, the JAX package's bfloat16 band."""
    cfg = ModelConfig(block_size=18, use_pallas=True, dtype="bfloat16")
    d = write_eval_dir(str(tmp_path / "4_15"), "4_15", n=2, seed=17)
    records = [EvaluationDataset(d, 10.0)[i] for i in range(2)]
    unet = UNetDenoiser(dtype="bfloat16")
    unet.load_state_dict(random_unet_state_dict(0))
    unet.eval().requires_grad_(False)
    runs = {}
    for device in ("cpu", dev):
        kernels.reset_launch_counts()
        runs[str(device)] = Evaluator(
            dt=_long_window_policy(cfg, device), denoise=unet.to(device),
            cfg=cfg, max_timesteps=30, device=device).evaluate_records(
                records)
        counts = kernels.launch_counts()
    assert counts["conv_block_bf16"] > 0 and counts["dt_decode"] > 0
    assert counts["kspace"] > 0 and counts["conv_block"] == 0
    cpu, gpu = runs["cpu"], runs[str(dev)]
    np.testing.assert_array_equal(gpu["episode_len"], cpu["episode_len"])
    np.testing.assert_allclose(gpu["reward"], cpu["reward"], rtol=0,
                               atol=0.15)


# --- the expert corpus and the host search's single-node API ---------------

def test_expert_recording_on_card_matches_cpu(dev):
    """Three trajectories recorded in chunks of two on the card (K1, K2)
    and on the CPU: the same tasks, PSNRs within 1e-3 dB, uint8 states
    within 1 LSB."""
    from dt4image_restoration_tpu_torch.data import expert
    sd = random_unet_state_dict(0, base_channels=8)
    runs = {}
    for device in ("cpu", dev):
        unet = UNetDenoiser(8).eval().requires_grad_(False)
        unet.load_state_dict(sd)
        kernels.reset_launch_counts()
        runs[str(device)] = list(expert.expert_trajectories(
            unet.to(device), n_traj=3, ep_len=3, size=48, batch_chunk=2,
            device=device))
        counts = kernels.launch_counts()
    assert counts["conv_block"] > 0 and counts["kspace"] > 0
    for a, b in zip(runs[str(dev)], runs["cpu"], strict=True):
        assert (a.index, a.task, a.actions) == (b.index, b.task, b.actions)
        np.testing.assert_allclose(a.psnrs, b.psnrs, rtol=0, atol=1e-3)
        assert np.abs(a.states.astype(int) - b.states.astype(int)).max() \
            <= 1


def test_expand_and_beam_search_on_card_match_cpu(dev, tmp_path):
    """MCTS.expand of one root and MCTS.beam_search from a child on the card
    (K1, K2, K4, K5) against the CPU: priors within 1e-4, the children's
    states within the U-Net band, equal episode lengths and the final PSNR
    within 0.05 dB."""
    from dt4image_restoration_tpu_torch.env import reset_from_mat
    from dt4image_restoration_tpu_torch.inference import Node
    from dt4image_restoration_tpu_torch.ops.metrics import psnr
    cfg = ModelConfig(block_size=18, use_pallas=True)
    d = write_eval_dir(str(tmp_path / "4_15"), "4_15", n=1, seed=15)
    (_, rtg0, _, task0), mat = EvaluationDataset(d, 5.0)[0]
    runs = {}
    for device in ("cpu", dev):
        unet = UNetDenoiser().eval().requires_grad_(False)
        unet.load_state_dict(random_unet_state_dict(0))
        m = MCTS(dt=_long_window_policy(cfg, device), denoise=unet.to(device),
                 model_cfg=cfg, cfg=MCTSConfig(max_timesteps=8),
                 value_fn=proxy_value_fn, device=device)
        env = reset_from_mat(mat, device=device)
        root = Node(0, 1.0, None, 0, 0, env, env, float(rtg0[0, 0]))
        root.bufs = m._seed_bufs(env.x.reshape(1, -1),
                                 torch.tensor(rtg0).reshape(()),
                                 torch.as_tensor(task0))
        kernels.reset_launch_counts()
        m.expand(root, int(task0[0]), np.random.default_rng(3), 0)
        _, x, ep_len = m.beam_search(root.children[1], int(task0[0]))
        counts = kernels.launch_counts()
        gt = root.env_state.gt.cpu().reshape(x.shape)
        runs[str(device)] = (
            [c.prob for c in root.children],
            torch.cat([c.env_state.x.cpu() for c in root.children]), ep_len,
            float(psnr(gt, torch.from_numpy(x))[0, 0]))
    assert all(counts[k] > 0 for k in ("conv_block", "kspace", "attention",
                                       "layernorm"))
    (p_cpu, x_cpu, len_cpu, db_cpu) = runs["cpu"]
    (p_gpu, x_gpu, len_gpu, db_gpu) = runs[str(dev)]
    np.testing.assert_allclose(p_gpu, p_cpu, rtol=1e-4)
    np.testing.assert_allclose(x_gpu.numpy(), x_cpu.numpy(), rtol=1e-3,
                               atol=2e-4)
    assert len_gpu == len_cpu == 8
    assert abs(db_gpu - db_cpu) <= 0.05


def _mesh_devices(dev, n_cards):
    if torch.cuda.device_count() < n_cards:
        pytest.skip(f"needs {n_cards} GPUs")
    return [torch.device("cuda", i % n_cards) for i in range(2)]


@pytest.mark.parametrize("n_cards", [1, 2])
def test_sharded_evaluator_on_card_matches_unsharded(dev, tmp_path,
                                                     n_cards):
    """Three slices (padded to 4) on two shards, both on cuda:0 or one on
    each of two cards (a host thread each): the unsharded run's episode
    lengths, rewards within 0.01 dB, and every shard launches K1-K3."""
    from dt4image_restoration_tpu_torch.training.sharding import make_mesh
    devices = _mesh_devices(dev, n_cards)
    cfg = ModelConfig(block_size=18)
    d = write_eval_dir(str(tmp_path / "4_15"), "4_15", n=3, seed=13)
    records = [EvaluationDataset(d, 10.0)[i] for i in range(3)]
    unet = UNetDenoiser().eval().requires_grad_(False)
    unet.load_state_dict(random_unet_state_dict(0))
    dt = _long_window_policy(cfg, dev)
    want = Evaluator(dt=dt, denoise=unet.to(dev), cfg=cfg, max_timesteps=30,
                     device=dev).evaluate_records(records)
    kernels.reset_launch_counts()
    got = Evaluator(dt=dt, denoise=unet, cfg=cfg, max_timesteps=30,
                    device=dev, mesh=make_mesh(devices=devices)
                    ).evaluate_records(records)
    counts = kernels.launch_counts()
    assert all(counts[k] >= 2 for k in ("conv_block", "kspace",
                                        "dt_decode")), counts
    np.testing.assert_array_equal(got["episode_len"], want["episode_len"])
    np.testing.assert_allclose(got["reward"], want["reward"], rtol=0,
                               atol=0.01)
    assert got["final_state"].x.device == devices[0]


@pytest.mark.parametrize("n_cards", [1, 2])
def test_sharded_search_and_service_on_card(dev, tmp_path, n_cards):
    """The device search (3 trees, padded to 4, 2 rounds) and the policy
    service (3 requests at batch 4) on two shards: within 0.05 dB and 1e-5
    of their unsharded runs, K4 and K5 launched by the search."""
    from dt4image_restoration_tpu_torch.data import make_mat_record
    from dt4image_restoration_tpu_torch.serving import RestorationRequest
    from dt4image_restoration_tpu_torch.training.sharding import make_mesh
    mesh = make_mesh(devices=_mesh_devices(dev, n_cards))
    dt, unet, _ = _search_models(dev)
    d = write_eval_dir(str(tmp_path / "4_15"), "4_15", n=3, seed=13)
    records = [EvaluationDataset(d, 5.0)[i] for i in range(3)]
    kw = dict(dt=dt, denoise=unet, model_cfg=dt.cfg,
              cfg=MCTSConfig(iterations=2, max_timesteps=8),
              value_fn=proxy_value_fn, device=dev)
    want = DeviceMCTS(**kw).run_batch(records, verbose=False)
    kernels.reset_launch_counts()
    got = DeviceMCTS(mesh=mesh, **kw).run_batch(records, verbose=False)
    counts = kernels.launch_counts()
    assert counts["attention"] > 0 and counts["layernorm"] > 0, counts
    np.testing.assert_allclose(got, want, rtol=0, atol=0.05)
    reqs = [RestorationRequest(mat=make_mat_record(seed=i), rtg=5.0, task=2)
            for i in range(3)]
    for a, b in zip(_serve(dev, "policy", reqs),
                    _serve(dev, "policy", reqs, mesh=mesh)):
        np.testing.assert_allclose(b.image, a.image, rtol=0, atol=1e-5)
        assert a.episode_len == b.episode_len


def test_mesh_copies_cpu_models_with_packed_caches_to_card(dev, tmp_path):
    """A U-Net and a DT built on the CPU, with K1's and K3's packed
    weights already made there, sharded on [cuda:0, cuda:0]: the evaluator
    deep-copies both onto the card once, the copy repacks there, K1 and K3
    launch, and the results equal an unsharded run of the same models
    moved to the card (episode lengths, rewards within 0.01 dB)."""
    import copy

    from dt4image_restoration_tpu_torch.training.sharding import make_mesh
    cfg = ModelConfig(block_size=18)
    d = write_eval_dir(str(tmp_path / "4_15"), "4_15", n=3, seed=13)
    records = [EvaluationDataset(d, 10.0)[i] for i in range(3)]
    unet = UNetDenoiser().eval().requires_grad_(False)
    unet.load_state_dict(random_unet_state_dict(0))
    dt = _long_window_policy(cfg, "cpu")
    cpu_packs = [unet.net.inc.packed_weights(), unet.net.up4.packed_weights(),
                 dt.packed_weights()]
    want = Evaluator(dt=copy.deepcopy(dt).to(dev),
                     denoise=copy.deepcopy(unet).to(dev), cfg=cfg,
                     max_timesteps=30, device=dev).evaluate_records(records)
    mesh = make_mesh(devices=[dev, dev])
    card = mesh.devices[0]
    kernels.reset_launch_counts()
    ev = Evaluator(dt=dt, denoise=unet, cfg=cfg, max_timesteps=30,
                   device=dev, mesh=mesh)
    got = ev.evaluate_records(records)
    counts = kernels.launch_counts()
    assert all(counts[k] >= 2 for k in ("conv_block", "kspace",
                                        "dt_decode")), counts
    (_, dt_a, unet_a), (_, dt_b, unet_b) = ev._shards
    assert dt_a is dt_b and unet_a is unet_b
    assert dt_a is not dt and unet_a is not unet
    assert next(dt.parameters()).device.type == "cpu"
    for pack in (unet_a.net.inc.packed_weights(),
                 unet_a.net.up4.packed_weights()):
        assert pack.tc_weights.device == card
        assert all(pack is not p for p in cpu_packs)
    assert all(t.device == card for t in dt_a.packed_weights().values())
    assert dt.packed_weights() is cpu_packs[2]
    np.testing.assert_array_equal(got["episode_len"], want["episode_len"])
    np.testing.assert_allclose(got["reward"], want["reward"], rtol=0,
                               atol=0.01)


# --- the evaluator's policy step as a CUDA graph ---------------------------

def _graph_records(batch):
    """``batch`` records of seven synthetic slices, the tasks in turn, as
    the evaluation dataset yields them."""
    from dt4image_restoration_tpu_torch.data import make_mat_record
    recs = [make_mat_record(seed=i) for i in range(7)]
    out = []
    for i in range(batch):
        rec = dict(recs[i % 7])
        states = rec["x0"][..., 0].reshape(1, -1).astype(np.float32)
        rec["x0"] = np.clip(rec["x0"], 0, None)
        out.append(((states, np.full((1, 1), 10.0, np.float32),
                     np.zeros(3, np.float32), np.full((1, 1), i % 9)), rec))
    return out


def _graph_models(dev, dtype="float32"):
    cfg = ModelConfig(block_size=18, dtype=dtype)
    unet = UNetDenoiser(dtype=dtype)
    unet.load_state_dict(random_unet_state_dict(0))
    return cfg, _long_window_policy(cfg, dev), \
        unet.eval().requires_grad_(False).to(dev)


def _rollout_without_a_cache(dt, unet, cfg, records, dev, max_timesteps=30):
    """``Evaluator.evaluate_records``' rollout through ``greedy_rollout``
    without a graph cache, its policy step uncaptured: (final state,
    reward (B,), episode lengths (B,))."""
    from dt4image_restoration_tpu_torch.env import reset_from_mat
    from dt4image_restoration_tpu_torch.inference import (
        greedy_rollout, initial_policy_setup, policy_forward)
    from dt4image_restoration_tpu_torch.models import (make_dt_embed_apply,
                                                       make_state_encode)
    x0 = torch.from_numpy(np.concatenate([r[0][0] for r in records]))
    rtg0 = torch.from_numpy(np.stack([r[0][1].reshape(())
                                      for r in records]))
    task = torch.from_numpy(np.stack([np.int64(r[0][3].reshape(()))
                                      for r in records]))
    mats = {k: np.concatenate([r[1][k] for r in records])
            for k in ("x0", "y0", "mask", "gt")}
    apply = policy_forward(dt, cfg)
    encode = make_state_encode(dt)
    with torch.no_grad():
        bufs, _, adict, prtg = initial_policy_setup(
            apply, cfg, x0.to(dev), rtg0.to(dev), task.to(dev),
            max_timesteps, encode=encode)
    final, reward, ep_len, _ = greedy_rollout(
        apply, unet, cfg, reset_from_mat(mats, device=dev), bufs, adict,
        prtg, max_timesteps, encode=encode,
        dt_embed_apply=make_dt_embed_apply(apply))
    return final, reward[:, 0].cpu().numpy(), ep_len.cpu().numpy()


@pytest.mark.parametrize("dtype,batch", [("float32", 1), ("float32", 63),
                                         ("bfloat16", 63)])
def test_evaluator_policy_graph_matches_a_rollout_without_a_cache_on_card(
        dev, dtype, batch):
    """The evaluator, whose policy steps replay a CUDA graph, against
    ``greedy_rollout`` without a graph cache on the same models and
    slices: equal episode lengths, and images bit-equal (a float32 gap,
    if any, under 1e-6, and reported)."""
    cfg, dt, unet = _graph_models(dev, dtype)
    records = _graph_records(batch)
    ev = Evaluator(dt=dt, denoise=unet, cfg=cfg, max_timesteps=30,
                   device=dev)
    got = ev.evaluate_records(records)
    final, reward, ep_len = _rollout_without_a_cache(dt, unet, cfg, records,
                                                     dev)
    assert ev.policy_graph_stats() == {"captures": 1, "replays": 29,
                                       "eager_policy_steps": 0}
    assert ev.prior_graph_stats() == {"captures": 1, "replays": 29,
                                      "eager_prior_calls": 0}
    np.testing.assert_array_equal(got["episode_len"], ep_len)
    gap = float((got["final_state"].x - final.x).abs().max())
    print(f"policy graph, {dtype} B={batch}: largest pixel gap {gap:.3e}, "
          f"reward gap {np.abs(got['reward'] - reward).max():.3e}")
    assert gap == 0.0 if dtype == "bfloat16" else gap <= 1e-6


def test_evaluator_policy_graph_is_captured_once_per_batch_and_weights(
        dev):
    """Two calls of one batch size capture once and replay 29 policy steps
    each; a new batch size captures its own graph; a change of the DT's
    weights in place captures anew, and the result follows the new
    weights. No policy step runs without its graph. K3's launch count is
    what the card ran: the setup's two forwards, the warm-up step's two
    before a capture, none for the capture, two a replay."""
    cfg, dt, unet = _graph_models(dev)
    ev = Evaluator(dt=dt, denoise=unet, cfg=cfg, max_timesteps=30,
                   device=dev)
    two, three = _graph_records(2), _graph_records(3)
    kernels.reset_launch_counts()
    first = ev.evaluate_records(two)
    assert kernels.launch_counts()["dt_decode"] == 2 + 2 + 2 * 29
    kernels.reset_launch_counts()
    again = ev.evaluate_records(two)
    assert kernels.launch_counts()["dt_decode"] == 2 + 2 * 29
    assert ev.policy_graph_stats() == {"captures": 1, "replays": 58,
                                       "eager_policy_steps": 0}
    assert torch.equal(first["final_state"].x, again["final_state"].x)
    ev.evaluate_records(three)
    assert ev.policy_graph_stats() == {"captures": 2, "replays": 87,
                                       "eager_policy_steps": 0}
    with torch.no_grad():
        dt.blocks[0].fc.weight.mul_(1.5)
        dt.state_encoder.dense.weight.mul_(1.5)
    moved = ev.evaluate_records(two)
    assert ev.policy_graph_stats() == {"captures": 3, "replays": 116,
                                       "eager_policy_steps": 0}
    final, _, ep_len = _rollout_without_a_cache(dt, unet, cfg, two, dev)
    np.testing.assert_array_equal(moved["episode_len"], ep_len)
    assert float((moved["final_state"].x - final.x).abs().max()) <= 1e-6
    assert not torch.equal(moved["final_state"].x, first["final_state"].x)


# --- the priors' forward as a CUDA graph ------------------------------------

# The kernels of the priors' forward, by wrapper (DRUNet launches none,
# Restormer K7 and K8).
PRIOR_KERNELS = ("conv_block", "conv_block_bf16", "upsample_concat",
                 "mdta_gram", "biasfree_layernorm")
# Restormer's blocks at its published widths, each one K7 call and two K8
# calls.
RESTORMER_BLOCKS = 4 + 6 + 6 + 8 + 6 + 6 + 4 + 4


def _prior_launches():
    counts = kernels.launch_counts()
    return {k: counts[k] for k in PRIOR_KERNELS}


def _prior(dev, arch, dtype):
    if arch == "unet":
        den = UNetDenoiser(dtype=dtype)
        den.load_state_dict(random_unet_state_dict(0))
    elif arch == "drunet":
        den = DRUNetDenoiser(dtype=dtype)
        den.load_state_dict(random_drunet_state_dict(0))
    else:
        den = RestormerDenoiser(dtype=dtype)
        den.load_state_dict(random_restormer_state_dict(0))
    return den.eval().requires_grad_(False).to(dev)


@pytest.mark.parametrize("arch,dtype,batch", [
    ("unet", "float32", 1), ("unet", "float32", 63),
    ("unet", "bfloat16", 63), ("drunet", "bfloat16", 4),
    ("restormer", "bfloat16", 63)])
def test_prior_graph_is_bit_equal_to_the_eager_forward_on_card(
        dev, arch, dtype, batch):
    """Four calls of one shape through a graph cache (the first captures
    and answers from its warm-up, the others replay; the last with a float
    sigma) give the eager forward's answers bit for bit, each in a tensor
    of the caller's own that a later replay leaves alone; the K1, K1-bf16
    and K6 counters advance as they do eagerly."""
    den = _prior(dev, arch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(batch)
    xs = [torch.rand((batch, 1, 128, 128), device=dev, generator=gen)
          for _ in range(4)]
    sigmas = [0.1 * torch.rand((batch,), device=dev, generator=gen)
              for _ in range(3)] + [0.05]
    graphs = PriorGraphs()
    with torch.no_grad():
        kernels.reset_launch_counts()
        want = [den(x, s) for x, s in zip(xs, sigmas)]
        torch.cuda.synchronize()
        eager = _prior_launches()
        kernels.reset_launch_counts()
        with graphs.scope():
            got = [den(x, s) for x, s in zip(xs, sigmas)]
            torch.cuda.synchronize()
            assert _prior_launches() == eager
            kept = [g.clone() for g in got]
            den(xs[0], 0.2)
    gaps = [float((g - w).abs().max()) for g, w in zip(got, want)]
    print(f"prior graph, {arch} {dtype} B={batch}: pixel gaps {gaps}, "
          f"launches {eager}")
    assert gaps == [0.0] * 4
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, k) for g, k in zip(got, kept))
    assert graphs.stats() == {"captures": 1, "replays": 4,
                              "eager_prior_calls": 0}
    static = graphs.graphs[xs[0].device].out
    assert all(g.data_ptr() != static.data_ptr() for g in got)
    if arch == "unet":
        assert eager["upsample_concat"] == 4 * 4
        assert eager["conv_block_bf16" if dtype == "bfloat16"
                     else "conv_block"] == 2 * 4
    if arch == "restormer":
        assert eager["mdta_gram"] == RESTORMER_BLOCKS * 4
        assert eager["biasfree_layernorm"] == 2 * RESTORMER_BLOCKS * 4


def test_prior_graph_captures_anew_for_a_new_batch_or_new_weights_on_card(
        dev):
    """A new batch size captures in place of the device's graph; so does a
    change of the weights in place (K1's packed copy among them) before
    the next scope, as between two rollouts, and the answers follow the
    new weights."""
    den = _prior(dev, "unet", "float32")
    x2 = torch.rand((2, 1, 128, 128), device=dev)
    x3 = torch.rand((3, 1, 128, 128), device=dev)
    graphs = PriorGraphs()
    with torch.no_grad():
        with graphs.scope():
            den(x2, 0.05)
            den(x2, 0.05)
            first = graphs.graphs[x2.device]
            den(x3, 0.05)
        assert graphs.stats() == {"captures": 2, "replays": 1,
                                  "eager_prior_calls": 0}
        assert list(graphs.graphs) == [x2.device]
        assert graphs.graphs[x2.device] is not first
        with graphs.scope():
            den(x3, 0.05)
        assert graphs.stats()["captures"] == 2
        den.net.inc.conv0.weight.mul_(1.5)
        den.net.up2.conv1.weight.mul_(1.5)
        with graphs.scope():
            moved = den(x3, 0.05)
            again = den(x3, 0.05)
        assert graphs.stats() == {"captures": 3, "replays": 3,
                                  "eager_prior_calls": 0}
        want = den(x3, 0.05)
    assert torch.equal(moved, want) and torch.equal(again, want)


@pytest.mark.parametrize("dtype,batch", [("float32", 1), ("float32", 63),
                                         ("bfloat16", 63)])
def test_evaluator_prior_graph_matches_the_eager_prior_on_card(
        dev, dtype, batch):
    """The evaluator with its prior replayed from a graph against the same
    evaluator whose prior runs eagerly (called with grad on, which the
    graph cache leaves eager): equal episode lengths, bit-equal images,
    and the same K1, K1-bf16 and K6 launches."""
    cfg, dt, unet = _graph_models(dev, dtype)
    records = _graph_records(batch)

    def eager(x, sigma):
        with torch.enable_grad():
            return unet(x, sigma)

    runs = {}
    for name, den in (("graph", unet), ("eager", eager)):
        ev = Evaluator(dt=dt, denoise=den, cfg=cfg, max_timesteps=30,
                       device=dev)
        kernels.reset_launch_counts()
        m = ev.evaluate_records(records)
        torch.cuda.synchronize()
        runs[name] = (m, _prior_launches(), ev.prior_graph_stats())
    (got, got_launches, got_stats), (want, want_launches, want_stats) = \
        runs["graph"], runs["eager"]
    assert got_stats == {"captures": 1, "replays": 29,
                         "eager_prior_calls": 0}
    assert want_stats == {"captures": 0, "replays": 0,
                          "eager_prior_calls": 30}
    assert got_launches == want_launches
    np.testing.assert_array_equal(got["episode_len"], want["episode_len"])
    gap = float((got["final_state"].x - want["final_state"].x).abs().max())
    print(f"prior graph in the evaluator, {dtype} B={batch}: largest pixel "
          f"gap {gap:.3e}")
    assert gap == 0.0
    assert torch.equal(got["final_state"].x, want["final_state"].x)


# cuDNN's layout transforms, by the names its kernels carry.
LAYOUT_KERNELS = ("nchwtonhwc", "nhwctonchw")


def _trace_events(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_restormer_forward_runs_no_layout_transform_on_card(dev, tmp_path):
    """A traced bfloat16 Restormer forward at B=63 (published widths): no
    kernel of cuDNN's NCHW<->NHWC transforms, around the pixel
    (un)shuffles, the skip concats and the attention included; K7 once a
    block. Prints the forward's largest kernels."""
    den = _prior(dev, "restormer", "bfloat16")
    x = torch.rand((63, 1, 128, 128), device=dev)
    sigma = torch.full((63,), 0.05, device=dev)
    with torch.no_grad():
        den(x, sigma)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            den(x, sigma)
            torch.cuda.synchronize()
    kernels_run = [e for e in _trace_events(prof, tmp_path)
                   if e.get("cat") == "kernel"]
    by_name = {}
    for e in kernels_run:
        ms, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + float(e["dur"]) / 1e3, n + 1)
    total = sum(ms for ms, _ in by_name.values())
    print(f"Restormer bf16 B=63: {len(kernels_run)} kernels, {total:.3f} "
          "ms of device time; largest:")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]
                                )[:14]:
        print(f"  {ms:8.3f} ms {n:4d}x {name[:110]}")
    layout = [n for n in by_name
              if any(k in n.lower() for k in LAYOUT_KERNELS)]
    assert not layout, layout
    k7_runs = [e for e in kernels_run if "mdta_gram" in e["name"]]
    assert len(k7_runs) == 2 * RESTORMER_BLOCKS      # two passes a block
    # The LayerNorms: K8 alone, PyTorch's LayerNorm kernel nowhere.
    k8_runs = [e for e in kernels_run if "biasfree_layernorm" in e["name"]]
    assert len(k8_runs) == 2 * RESTORMER_BLOCKS
    assert not [n for n in by_name if "layer_norm" in n.lower()]


# tests/test_torch_restormer.py's bfloat16 band against the float32 plain
# forward: the largest pixel gap and the RMS gap.
RESTORMER_BF16_MAX, RESTORMER_BF16_RMS = 0.02, 0.005


def test_restormer_bfloat16_forward_on_card_runs_k8_in_every_layernorm(dev):
    """A bfloat16 Restormer forward at its published widths (two slices,
    128^2): 88 K8 launches (two a block) beside 44 K7 calls, and the answer
    within the CPU tests' bfloat16 band of the plain float32 forward
    (``utils/torch_reference.py``, TF32 off) on the same weights."""
    from dt4image_restoration_tpu_torch.utils.torch_reference import (
        torch_restormer_denoise)
    den = _prior(dev, "restormer", "bfloat16")
    sd = {k.removeprefix("net."): v.to(dev)
          for k, v in random_restormer_state_dict(0).items()}
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.rand((2, 1, 128, 128), generator=gen, device=dev)
    sigma = torch.tensor([0.03, 0.1], device=dev)
    with torch.no_grad():
        kernels.reset_launch_counts()
        got = den(x, sigma)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        want = torch_restormer_denoise(sd, x, sigma)
    assert counts["biasfree_layernorm"] == 2 * RESTORMER_BLOCKS
    assert counts["mdta_gram"] == RESTORMER_BLOCKS
    gap = got - want
    largest, rms = float(gap.abs().max()), float(gap.pow(2).mean().sqrt())
    print(f"Restormer bf16 on card vs float32 plain: largest {largest:.4f}, "
          f"RMS {rms:.5f}; the prior moves the image by RMS "
          f"{float((want - x).pow(2).mean().sqrt()):.4f}")
    assert largest <= RESTORMER_BF16_MAX
    assert rms <= RESTORMER_BF16_RMS


def test_restormer_span_holds_its_replayed_kernels_under_the_benchmarks_span(
        dev, tmp_path):
    """Through a graph cache, as in the evaluator: each replayed forward's
    ``dt4ir.restormer`` span lies inside a ``portbench.unet`` span, and its
    kernels, K7's among them, are the ones the benchmark counts under
    ``portbench.unet`` (by the ``cudaGraphLaunch``'s correlation id)."""
    from portbench.trace import WINDOW_SPAN, read_events, unet_span
    from dt4image_restoration_tpu_torch.utils.profiling import (PRIOR_GRAPH,
                                                                RESTORMER)
    den = _prior(dev, "restormer", "bfloat16")
    x = torch.rand((4, 1, 128, 128), device=dev)
    sigma = torch.full((4,), 0.05, device=dev)
    graphs, calls = PriorGraphs(), 3
    with torch.no_grad(), graphs.scope():
        den(x, sigma)                          # captures the graph
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(WINDOW_SPAN):
                for _ in range(calls):
                    with unet_span():
                        den(x, sigma)
                torch.cuda.synchronize()
    events = _trace_events(prof, tmp_path)
    trace = read_events(events)
    assert graphs.stats() == {"captures": 1, "replays": calls,
                              "eager_prior_calls": 0}

    def spans(name):
        return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                for e in events if e.get("name") == name
                and e.get("cat") == "user_annotation"]
    outer = spans("portbench.unet")
    inner, graph = spans(RESTORMER), spans(PRIOR_GRAPH)
    assert len(outer) == len(inner) == len(graph) == calls
    for span, parents in ((s, outer) for s in inner):
        assert sum(p[0] <= span[0] and span[1] <= p[1] for p in parents) == 1
    for span in graph:
        assert sum(p[0] <= span[0] and span[1] <= p[1] for p in inner) == 1
    counted = set(trace.unet_device)
    k7_ops = [(a, b) for a, b, name in trace.device if "mdta_gram" in name]
    assert len(k7_ops) == 2 * RESTORMER_BLOCKS * calls
    assert all(op in counted for op in k7_ops)
    k8_ops = [(a, b) for a, b, name in trace.device
              if "biasfree_layernorm" in name]
    assert len(k8_ops) == 2 * RESTORMER_BLOCKS * calls
    assert all(op in counted for op in k8_ops)
    print(f"Restormer replayed under portbench.unet: {len(trace.device)} "
          f"device ops, {trace.unet_device_s() * 1e3:.3f} ms")


def test_validate_parity_selftest_on_card(dev, capsys):
    """The parity harness's ``--selftest`` with the port on the card: every
    row within 0.05 dB of the oracle, the fused policy's kernels (K1, K2,
    K3) launched by eval and flex, the per-op policy's (K1, K2, K4, K5) by
    the search."""
    from dt4image_restoration_tpu_torch.tools import validate_parity
    small = ["--selftest", "--device", "cuda", "--limit", "2",
             "--max_timesteps", "8", "--iterations", "2", "--flex_rtgs", "3"]
    for modes, want in ((["eval", "flex"], ("conv_block", "kspace",
                                            "dt_decode")),
                        (["mcts"], ("conv_block", "kspace", "attention",
                                    "layernorm"))):
        kernels.reset_launch_counts()
        rc = validate_parity.main(small + ["--modes", *modes])
        counts = kernels.launch_counts()
        out = capsys.readouterr().out
        assert rc == 0 and "Overall: PASS" in out, out
        assert all(counts[k] > 0 for k in want), (modes, counts)


def test_bench_launches_each_dtypes_kernels_on_card(dev, capsys):
    """The port's bench at full width, 3 iterations, no knee: every gate
    passes; ``pallas`` launches K1 and K2, ``pallas_bf16`` the bfloat16 K1
    and K2, and no variant launches the other dtype's K1."""
    import json

    from dt4image_restoration_tpu_torch import bench
    rc = bench.main(["--size", "128", "--iters", "3", "--repeats", "2",
                     "--knee", "none"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, line
    ex = line["extras"]
    assert all(v for k, v in ex.items() if k.endswith("_ok")), ex
    assert ex["platform"] == "gpu"
    launches = ex["launches"]
    assert launches["pallas"]["conv_block"] > 0
    assert launches["pallas"]["kspace"] > 0
    assert launches["pallas_bf16"]["conv_block_bf16"] > 0
    assert launches["pallas_bf16"]["kspace"] > 0
    for name, counts in launches.items():
        other = "conv_block" if bench.VARIANTS[name][1] == "bfloat16" \
            else "conv_block_bf16"
        assert counts[other] == 0, (name, counts)
