"""Restormer as the port's third plug-in prior (models/restormer.py): the
port against the plain forward of utils/torch_reference.py on seeded random
weights, the attention map's plain version (kernel K7's twin), the
BiasFree LayerNorm, Restormer's checkpoint layout, the prior registry, the
loader and the command line, the evaluator driving it, and its span.

Small widths (dim 16, blocks 1-1-1-2, one refinement block, heads 1-2-2-4,
so heads 16 and 32 wide) on 32^2 and 48^2 slices. Tolerances: float32 to
1e-5 (the same products in another order, and the LayerNorm as a centred
norm plus the mean's share; the readings are under 1e-6); bfloat16 within
0.02 of the largest pixel and 0.005 RMS, from 8-bit mantissas over the ~40
products a pixel passes (the readings are 0.004 and 0.0009), while the
refinement block left out reads 0.039 and 0.0098, and the bfloat16 output
must differ from the float32 one by 1e-4 RMS or more, so that a path that
computes float32 under ``dtype="bfloat16"`` fails too."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dt4image_restoration_tpu_torch.config import DENOISER_ARCHS, ModelConfig
from dt4image_restoration_tpu_torch.data import make_mat_record
from dt4image_restoration_tpu_torch.inference import Evaluator
from dt4image_restoration_tpu_torch.models import (DecisionTransformer,
                                                   DRUNetDenoiser,
                                                   RestormerDenoiser,
                                                   UNetDenoiser,
                                                   random_restormer_state_dict)
from dt4image_restoration_tpu_torch.models.restormer import (
    BiasFreeLayerNorm, pixel_shuffle, pixel_unshuffle)
from dt4image_restoration_tpu_torch.ops.kernels.mdta_gram import (
    mdta_gram, mdta_gram_plain)
from dt4image_restoration_tpu_torch.utils import loaders
from dt4image_restoration_tpu_torch.utils.convert import (
    load_strict, restormer_from_reference)
from dt4image_restoration_tpu_torch.utils.profiling import RESTORMER, UNET
from dt4image_restoration_tpu_torch.utils.torch_reference import (
    torch_restormer_denoise)
from torch_port_common import one_torch_thread  # noqa: F401

SMALL = dict(dim=16, num_blocks=(1, 1, 1, 2), num_refinement_blocks=1,
             heads=(1, 2, 2, 4))
SIZE = 48          # the policy's state encoder needs 48 or more
MAXT = 6
CFG = ModelConfig(block_size=18, n_embeds=9, embed_dim=32, n_heads=4,
                  n_blocks=2, image_size=SIZE)
BF16_MAX, BF16_RMS, BF16_MOVES = 0.02, 0.005, 1e-4


def official(sd):
    """A port state dict in ``restormer_arch.py``'s layout."""
    return {k.removeprefix("net."): v.clone() for k, v in sd.items()}


def restormer(seed=1, dtype="float32"):
    den = RestormerDenoiser(**SMALL, dtype=dtype)
    load_strict(den, random_restormer_state_dict(seed, **SMALL), "Restormer")
    return den.eval().requires_grad_(False)


def _plain(seed=1):
    """The plain forward as a prior callable."""
    sd = official(random_restormer_state_dict(seed, **SMALL))
    return lambda img, sigma: torch_restormer_denoise(sd, img, sigma)


def _rms(t):
    return float(t.pow(2).mean().sqrt())


def _inputs(seed, b=3, h=32, w=40):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(b, 1, h, w, generator=g), \
        torch.tensor([0.02, 0.1, 0.25][:b])


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_restormer_matches_the_plain_forward(dtype, seed):
    den = restormer(seed, dtype)
    x, sigma = _inputs(seed)
    with torch.no_grad():
        got = den(x, sigma)
        want = _plain(seed)(x, sigma)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert got.is_contiguous()
    assert _rms(want - x) > 0.01          # the prior moves the image
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        return
    assert float((got - want).abs().max()) <= BF16_MAX
    assert _rms(got - want) <= BF16_RMS
    with torch.no_grad():
        f32 = restormer(seed)(x, sigma)
    assert _rms(got - f32) >= BF16_MOVES


@pytest.mark.parametrize("stage", ["refinement", "latent"])
def test_float32_tolerance_catches_a_stage_left_out(stage):
    """The random prior's correction passes through every level: the
    refinement or the latent level left out moves the answer far past the
    float32 tolerance, and the refinement past the bfloat16 band too."""
    x, sigma = _inputs(1, b=2, h=32, w=32)
    want = _plain(1)(x, sigma)
    for dtype in ("float32", "bfloat16"):
        den = restormer(1, dtype)
        setattr(den.net, stage, torch.nn.Identity())
        with torch.no_grad():
            gap = den(x, sigma) - want
        assert float(gap.abs().max()) > 100 * 1e-5
        if stage == "refinement":
            assert float(gap.abs().max()) > BF16_MAX
            assert _rms(gap) > BF16_RMS


@pytest.mark.parametrize("heads,c", [(1, 16), (2, 16), (4, 32), (1, 96)])
def test_the_attention_maps_plain_version_is_normalize_matmul_softmax(
        heads, c):
    """K7's plain version on a channels-last (B, H, W, 3C) tensor equals
    ``restormer_arch.py:Attention``'s lines on the NCHW tensor: rows that
    sum to 1, and on the CPU the wrapper runs it."""
    g = torch.Generator().manual_seed(heads * c)
    b, h, w, ch = 2, 8, 12, heads * c
    qkv = torch.randn(b, h, w, 3 * ch, generator=g)
    tau = 1.0 + 0.3 * torch.randn(heads, generator=g)
    nchw = qkv.permute(0, 3, 1, 2)
    q, k, _ = nchw.chunk(3, dim=1)
    q = F.normalize(q.reshape(b, heads, c, h * w), dim=-1)
    k = F.normalize(k.reshape(b, heads, c, h * w), dim=-1)
    want = ((q @ k.transpose(-2, -1)) * tau.reshape(heads, 1, 1)) \
        .softmax(dim=-1)
    got = mdta_gram_plain(qkv, tau, heads)
    assert got.shape == (b, heads, c, c) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(got.sum(-1), torch.ones(b, heads, c))
    assert torch.equal(mdta_gram(qkv, tau, heads), got)
    bf = qkv.to(torch.bfloat16)
    torch.testing.assert_close(mdta_gram(bf, tau, heads),
                               mdta_gram_plain(bf.float(), tau, heads),
                               rtol=0, atol=1e-6)


def test_the_biasfree_layernorm_is_not_centred():
    """``x / sqrt(var(x) + eps) * w``: a constant offset of the channels
    leaves the variance and moves the output by offset / std * w, where a
    centred LayerNorm would not move."""
    ln = BiasFreeLayerNorm(24)
    with torch.no_grad():
        ln.weight.copy_(1.0 + 0.1 * torch.randn(24))
    x = torch.randn(2, 5, 7, 24)
    want = x / torch.sqrt(x.var(-1, keepdim=True, unbiased=False) + 1e-5) \
        * ln.weight
    with torch.no_grad():
        got, moved = ln(x, torch.float32), ln(x + 3.0, torch.float32)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    shift = 3.0 / torch.sqrt(x.var(-1, keepdim=True, unbiased=False)
                             + 1e-5) * ln.weight
    torch.testing.assert_close(moved - got, shift, rtol=0, atol=1e-4)
    assert float((moved - got).abs().min()) > 0.5
    centred = F.layer_norm(x, (24,), ln.weight.detach(), None, 1e-5)
    torch.testing.assert_close(
        F.layer_norm(x + 3.0, (24,), ln.weight.detach(), None, 1e-5),
        centred, rtol=0, atol=1e-5)


@pytest.mark.parametrize("c", [1, 3])
def test_the_pixel_shuffles_on_the_last_axis_are_torchs(c):
    x = torch.randn(2, 4 * c, 6, 10)
    nhwc = x.permute(0, 2, 3, 1).contiguous()
    torch.testing.assert_close(
        pixel_shuffle(nhwc), F.pixel_shuffle(x, 2).permute(0, 2, 3, 1),
        rtol=0, atol=0)
    torch.testing.assert_close(
        pixel_unshuffle(nhwc), F.pixel_unshuffle(x, 2).permute(0, 2, 3, 1),
        rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_conv_and_product_runs_on_channels_last_tensors(
        dtype, monkeypatch):
    """The 3x3 and depthwise convs take channels-last inputs and weights in
    the compute dtype (cuDNN needs no layout transform); the 1x1 products
    take contiguous (B, H, W, C) rows; no tensor is made contiguous in
    another layout."""
    cl = torch.channels_last
    seen, rows = [], []

    def conv(x, w, *args, _real=F.conv2d, **kw):
        seen.append((x.is_contiguous(memory_format=cl),
                     w.is_contiguous(memory_format=cl), x.dtype, w.dtype))
        return _real(x, w, *args, **kw)

    def linear(x, w, *args, _real=F.linear, **kw):
        rows.append((x.is_contiguous(), x.dtype, w.dtype))
        return _real(x, w, *args, **kw)
    monkeypatch.setattr(F, "conv2d", conv)
    monkeypatch.setattr(F, "linear", linear)
    with torch.no_grad():
        restormer(1, dtype)(torch.rand(2, 1, 32, 32), 0.1)
    want = getattr(torch, dtype)
    blocks = sum(SMALL["num_blocks"]) + SMALL["num_blocks"][0] \
        + sum(SMALL["num_blocks"][1:3]) + SMALL["num_refinement_blocks"]
    # Patch embedding, 3 down, 3 up, output; two depthwise convs a block.
    assert len(seen) == 8 + 2 * blocks
    assert set(seen) == {(True, True, want, want)}
    # qkv and project_in a block; two reduce convs.
    assert len(rows) == 2 * blocks + 2
    assert set(rows) == {(True, want, want)}


@pytest.mark.parametrize("side", [(36, 32), (32, 44), (12, 16)])
def test_a_side_not_divisible_by_8_is_refused(side):
    with pytest.raises(ValueError, match="divisible by 8"):
        restormer()(torch.rand(1, 1, *side), 0.1)


@pytest.mark.parametrize("fault", [None, "params", "one_channel", "missing",
                                   "extra_leaf", "extra_block", "bias"])
def test_restormer_from_reference_is_strict(fault):
    """A ``restormer_arch.py`` state dict (under BasicSR's ``params`` or a
    ``module.`` prefix) loads; a published one-channel patch embedding
    gains a zero sigma column; a key missing, a leaf or block the layout
    lacks, or a bias is refused."""
    sd = official(random_restormer_state_dict(3, **SMALL))
    if fault is None:
        sd = {"module." + k: v for k, v in sd.items()}
    elif fault == "params":
        sd = {"params": sd}
    elif fault == "one_channel":
        sd["patch_embed.proj.weight"] = sd["patch_embed.proj.weight"][:, :1]
    elif fault == "missing":
        del sd["decoder_level2.0.ffn.dwconv.weight"]
    elif fault == "extra_leaf":
        sd["latent.0.attn.qkv_bias"] = torch.zeros(1)
    elif fault == "extra_block":
        sd["refinement.1.norm1.body.weight"] = \
            sd["refinement.0.norm1.body.weight"]
    else:
        sd["output.bias"] = torch.zeros(1)
    den = RestormerDenoiser(**SMALL)
    if fault in (None, "params", "one_channel"):
        load_strict(den, restormer_from_reference(sd), "Restormer")
        want = random_restormer_state_dict(3, **SMALL)
        if fault == "one_channel":
            w = want["net.patch_embed.proj.weight"]
            want["net.patch_embed.proj.weight"] = torch.cat(
                [w[:, :1], torch.zeros_like(w[:, :1])], dim=1)
        assert all(torch.equal(v, want[k])
                   for k, v in den.state_dict().items())
        return
    with pytest.raises(ValueError, match="key"):
        load_strict(den, restormer_from_reference(sd), "Restormer")


def test_the_registry_resolves_every_prior(tmp_path, capsys):
    """``config.DENOISER_ARCHS`` is the registry's names; each entry builds
    its class at its published widths, and without a file loads its own
    random weights strictly."""
    assert DENOISER_ARCHS == tuple(loaders.PRIORS) \
        == ("unet_nm", "drunet", "restormer")
    classes = {"unet_nm": UNetDenoiser, "drunet": DRUNetDenoiser,
               "restormer": RestormerDenoiser}
    for arch, cls in classes.items():
        prior = loaders.PRIORS[arch]
        assert prior.modes is (arch == "unet_nm")
        den = loaders.load_denoiser(str(tmp_path / "none.pt"), device="cpu",
                                    arch=arch)
        assert type(den) is cls and not den.training
        want = prior.random_state_dict(0)
        assert all(torch.equal(v, want[k])
                   for k, v in den.state_dict().items())
    assert capsys.readouterr().err.count("using random weights") == 3
    assert sum(t.numel() for t in den.state_dict().values()) == 26109508


@pytest.fixture(scope="module")
def policy():
    torch.manual_seed(0)
    dt = DecisionTransformer(CFG).eval().requires_grad_(False)
    with torch.no_grad():
        dt.predict_action.bias[0] = -3.0   # norm mode: T is column 0
    return dt


def _records(n):
    out = []
    for i in range(n):
        mat = make_mat_record(size=SIZE, seed=i)
        states = np.asarray(mat["x0"], np.float32)[..., 0].reshape(1, -1)
        out.append(((states, np.full((1, 1), 0.6, np.float32),
                     np.zeros(3, np.float32), np.asarray([2], np.int32)),
                    mat))
    return out


def test_the_evaluator_drives_restormer(policy):
    """``Evaluator.evaluate_records`` with Restormer equals it with the
    plain forward in its place."""
    def run(denoise):
        return Evaluator(dt=policy, denoise=denoise, cfg=CFG,
                         max_timesteps=MAXT, rtg_target=10.0,
                         device="cpu").evaluate_records(_records(2))
    got, want = run(restormer()), run(_plain())
    np.testing.assert_array_equal(got["episode_len"], want["episode_len"])
    assert np.all(got["episode_len"] == MAXT)
    np.testing.assert_allclose(got["final_state"].x.real.numpy(),
                               want["final_state"].x.real.numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_forward_records_one_restormer_span(dtype):
    den = restormer(1, dtype)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        den(torch.rand(2, 1, 32, 32), torch.tensor([0.1, 0.2]))
    names = [e.name for e in prof.events()]
    assert names.count(RESTORMER) == 1 and UNET not in names


def test_the_eval_verb_runs_restormer(tmp_path, capsys, monkeypatch):
    """``eval --denoiser_arch restormer --dtype bfloat16`` loads the prior
    through the registry from a checkpoint in Restormer's layout (small
    widths here, for the CPU's time; the registry test builds the
    published ones) and evaluates with it."""
    from dt4image_restoration_tpu_torch import __main__ as cli
    from dt4image_restoration_tpu_torch.data import write_eval_dir
    monkeypatch.setattr(loaders, "RestormerDenoiser",
                        lambda dtype: RestormerDenoiser(**SMALL,
                                                        dtype=dtype))
    ckpt = tmp_path / "restormer.pth"
    torch.save({"params": official(random_restormer_state_dict(
        5, **SMALL))}, ckpt)
    d = write_eval_dir(str(tmp_path / "4_10"), "4_10", n=1, size=128)
    cli.main(["--block_size", "18", "--device", "cpu", "eval", "--rtg", "10",
              "--max_timesteps", "6", "--denoiser_arch", "restormer",
              "--dtype", "bfloat16", "--denoiser_ckpt", str(ckpt),
              "--checkpoint", str(tmp_path / "none.pt"), "--data_dirs", d])
    out, err = capsys.readouterr()
    assert "dtype bfloat16, prior restormer" in err
    assert "denoiser checkpoint" not in err
    assert "Average reward" in out
