"""Restormer, the transposed-attention transformer prior, channels-last.

Zamir et al., "Restormer: Efficient Transformer for High-Resolution Image
Restoration", CVPR 2022 (arXiv:2111.09881); ``swz30/Restormer``
``basicsr/models/archs/restormer_arch.py:Restormer`` with the settings of
``Denoising/Options/GaussianGrayDenoising_Restormer.yml`` (``dim`` 48,
``num_blocks`` [4, 6, 6, 8], ``num_refinement_blocks`` 4, ``heads`` [1, 2,
4, 8], ``ffn_expansion_factor`` 2.66, no biases, ``LayerNorm_type``
BiasFree). A block at width C with h heads and H = int(2.66 C):

    x = x + MDTA(LN(x));  x = x + GDFN(LN(x))
    LN(x)   = x / sqrt(var(x) + 1e-5) * w        over the channels, per
                                                 pixel; x is not centred
    MDTA(x) = conv1x1(A v),  q, k, v = dw3x3(conv1x1(x, C -> 3C)),
              A = softmax_j(tau_h * normalize(q_i) . normalize(k_j)) per
              head, over the c = C / h channels and all pixels
    GDFN(x) = conv1x1(gelu(x1) * x2),  x1, x2 = dw3x3(conv1x1(x, C -> 2H))

The network: a 3x3 patch embedding; levels of width 48, 96, 192 and 384
(the last the latent); down as a 3x3 conv to C/2 and PixelUnshuffle(2), up
as a 3x3 conv to 2C and PixelShuffle(2); levels 3 and 2 of the decoder
reduce their skip concat with a 1x1 conv, level 1 keeps it (96 channels,
one head 96 wide); 4 refinement blocks; a 3x3 output conv plus the input
image. The modules keep ``restormer_arch.py``'s names, so a Restormer
state dict loads under a ``net.`` prefix
(``utils/convert.py:restormer_from_reference``).

Layout: every activation from the patch embedding to the output conv is a
contiguous (B, H, W, C) tensor, channels-last memory. The 3x3 and
depthwise convs see it as a channels-last (B, C, H, W) view (parameters
channels-last too), so cuDNN runs them with no layout transform; the 1x1
convs are products over the last axis; the LayerNorms, the pixel
(un)shuffles and the skip concats work on the last axis; the attention
map (kernel K7, ``ops/kernels/mdta_gram.py``) reads q and k in place; the
one-channel output conv runs as a conv of 8 channels, 7 of them zero
weights (cuDNN's bfloat16 engines transpose a one-channel conv's input to
NCHW). So no tensor is ever transposed between layouts. Two products are
rearranged without changing the mathematics: each block's output 1x1 conv
takes its residual as the product's addend, and MDTA's ``conv1x1(A v)``
is one product of v with ``W blockdiag(A)``, made per sample in float32
(W the output conv's (C, C) weight), so that ``A v`` is never stored.

``dtype`` is the compute dtype (float32 parameters, one cached copy each
in the compute dtype, :mod:`.precision`): the convs, products, GELU gate
and residual stream run in it; the LayerNorm statistics (``native_layer_
norm``'s mean and 1/std), the attention map and its softmax are float32.
``RestormerDenoiser`` concatenates the sigma map, adds the image, casts
back and clamps in float32.
"""
from __future__ import annotations

from typing import Dict, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels.mdta_gram import mdta_gram
from ..utils.profiling import RESTORMER, annotate
from .precision import cast_params, compute_dtype, conv2d
from .prior_graphs import run_prior

DIM = 48                    # width of the first level
NUM_BLOCKS = (4, 6, 6, 8)   # blocks a level, the last the latent
NUM_REFINEMENT = 4
HEADS = (1, 2, 4, 8)
FFN_EXPANSION = 2.66
LN_EPS = 1e-5
# Three 2x downsamplings need sides that are a multiple of 8.
SIDE_MULTIPLE = 8
# The output conv's channels as cuDNN runs it (:func:`conv_out_nhwc`).
OUT_PAD = 8
# Random weights (:func:`random_restormer_state_dict`): the damping of each
# block's two output 1x1 convs, the noise around the patch embedding's and
# the output conv's linear image path, the weight of the sigma map in the
# embedding, and the spread of the LayerNorm scales and the temperatures
# around 1.
RES_GAIN = 0.2
EDGE_NOISE = 0.1
SIGMA_GAIN = 10.0
AROUND_ONE = 0.05
# The 3x3 smoothing that the random prior approximates on the image.
SMOOTH = ((1.0, 2.0, 1.0), (2.0, 20.0, 2.0), (1.0, 2.0, 1.0))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """A (B, H, W, C) tensor as its channels-last (B, C, H, W) view."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """A channels-last (B, C, H, W) tensor as its (B, H, W, C) view."""
    return x.permute(0, 2, 3, 1)


def conv_nhwc(layer: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype
              ) -> torch.Tensor:
    """``layer`` (a 3x3 or depthwise conv) on a (B, H, W, C) tensor, in
    ``dtype``; channels-last in and out, so the result is (B, H, W, C')
    contiguous."""
    return _nhwc(conv2d(layer, _nchw(x), dtype))


def conv_out_nhwc(layer: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype
                  ) -> torch.Tensor:
    """:func:`conv_nhwc` for a conv of fewer than :data:`OUT_PAD` output
    channels, run as one of :data:`OUT_PAD` whose extra channels have zero
    weights (a copy of the weight kept beside the layer until it changes):
    cuDNN transposes the input of a one-channel bfloat16 NHWC conv to NCHW
    and back, and runs the padded conv natively. The result is the first
    channels of the padded output, a (B, H, W, C') view."""
    w = cast_params(layer, dtype)[0]
    key = (w.data_ptr(), w._version)
    cache = getattr(layer, "_pad_cache", None)
    if cache is None or cache[0] != key:
        with torch.no_grad():
            pad = w.new_zeros((OUT_PAD, *w.shape[1:])) \
                .contiguous(memory_format=torch.channels_last)
            pad[:w.shape[0]] = w
        cache = layer._pad_cache = (key, pad)
    return _nhwc(F.conv2d(_nchw(x), cache[1], None, layer.stride,
                          layer.padding))[..., :w.shape[0]]


def pointwise(layer: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype
              ) -> torch.Tensor:
    """A bias-free 1x1 conv on a (B, H, W, C) tensor: a product over the
    last axis, in ``dtype``."""
    w = cast_params(layer, dtype)[0]
    return F.linear(x, w.reshape(w.shape[0], w.shape[1]))


def pixel_unshuffle(x: torch.Tensor) -> torch.Tensor:
    """``nn.PixelUnshuffle(2)`` on (B, H, W, C): (B, H/2, W/2, 4C), channel
    ``4c + 2i + j`` from pixel (2y + i, 2x + j)."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4) \
        .reshape(b, h // 2, w // 2, 4 * c)


def pixel_shuffle(x: torch.Tensor) -> torch.Tensor:
    """``nn.PixelShuffle(2)`` on (B, H, W, 4C): (B, 2H, 2W, C)."""
    b, h, w, c4 = x.shape
    c = c4 // 4
    return x.reshape(b, h, w, c, 2, 2).permute(0, 1, 4, 2, 5, 3) \
        .reshape(b, 2 * h, 2 * w, c)


class BiasFreeLayerNorm(nn.Module):
    """``x / sqrt(var(x) + eps) * weight`` over the last axis, the variance
    about the mean and ``x`` itself not centred. Computed as
    ``native_layer_norm``'s centred output (float32 statistics, one pass)
    plus the mean's share ``mean / std * weight``."""
    bias = None     # read by precision.cast_params

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        w = cast_params(self, dtype)[0]
        out, mean, rstd = torch.native_layer_norm(x, (x.shape[-1],), w,
                                                  None, LN_EPS)
        return torch.addcmul(out, (mean * rstd).to(dtype), w)


class LayerNorm(nn.Module):
    """``restormer_arch.py:LayerNorm`` (its ``body`` holds the weight);
    BiasFree only, the type of the published denoisers."""

    def __init__(self, dim: int):
        super().__init__()
        self.body = BiasFreeLayerNorm(dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.body(x, dtype)


class Attention(nn.Module):
    """MDTA: the transposed (channel) attention, returning ``x +
    MDTA(LN(x))`` given ``x`` and ``LN(x)``."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Conv2d(dim, dim * 3, 1, bias=False)
        self.qkv_dwconv = nn.Conv2d(dim * 3, dim * 3, 3, padding=1,
                                    groups=dim * 3, bias=False)
        self.project_out = nn.Conv2d(dim, dim, 1, bias=False)

    def forward(self, x: torch.Tensor, xn: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        b, h, w, c = x.shape
        heads = self.num_heads
        qkv = conv_nhwc(self.qkv_dwconv, pointwise(self.qkv, xn, dtype),
                        dtype)
        attn = mdta_gram(qkv, self.temperature.reshape(heads), heads)
        # conv1x1(A v) = (W blockdiag(A)) v: one (C, C) matrix a sample.
        proj = self.project_out.weight.reshape(c, heads, c // heads)
        m = torch.einsum("ohj,bhji->bohi", proj.float(), attn) \
            .reshape(b, c, c).to(dtype)
        v = qkv.reshape(b, h * w, 3 * c)[:, :, 2 * c:]
        return torch.baddbmm(x.reshape(b, h * w, c), v, m.transpose(1, 2)) \
            .reshape(b, h, w, c)


class FeedForward(nn.Module):
    """GDFN: the gated depthwise feed-forward, returning ``x + GDFN(LN(x))``
    given ``x`` and ``LN(x)``."""

    def __init__(self, dim: int, expansion: float):
        super().__init__()
        hidden = int(dim * expansion)
        self.project_in = nn.Conv2d(dim, hidden * 2, 1, bias=False)
        self.dwconv = nn.Conv2d(hidden * 2, hidden * 2, 3, padding=1,
                                groups=hidden * 2, bias=False)
        self.project_out = nn.Conv2d(hidden, dim, 1, bias=False)

    def forward(self, x: torch.Tensor, xn: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        b, h, w, c = x.shape
        t = conv_nhwc(self.dwconv, pointwise(self.project_in, xn, dtype),
                      dtype)
        x1, x2 = t.chunk(2, dim=-1)
        gated = F.gelu(x1) * x2
        wo = cast_params(self.project_out, dtype)[0].reshape(c, -1)
        return torch.addmm(x.reshape(-1, c),
                           gated.reshape(-1, wo.shape[1]), wo.t()) \
            .reshape(b, h, w, c)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, expansion: float,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads)
        self.norm2 = LayerNorm(dim)
        self.ffn = FeedForward(dim, expansion)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = self.attn(x, self.norm1(x, dt), dt)
        return self.ffn(x, self.norm2(x, dt), dt)


class OverlapPatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, dim, 3, padding=1, bias=False)


class Downsample(nn.Module):
    """A 3x3 conv to C/2, then PixelUnshuffle(2) (:func:`pixel_unshuffle`
    on the last axis); ``body.0`` is the conv, as in ``restormer_arch.py``."""

    def __init__(self, dim: int):
        super().__init__()
        self.body = nn.Sequential(nn.Conv2d(dim, dim // 2, 3, padding=1,
                                            bias=False))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return pixel_unshuffle(conv_nhwc(self.body[0], x, dtype))


class Upsample(nn.Module):
    """A 3x3 conv to 2C, then PixelShuffle(2) (:func:`pixel_shuffle` on the
    last axis); ``body.0`` is the conv."""

    def __init__(self, dim: int):
        super().__init__()
        self.body = nn.Sequential(nn.Conv2d(dim, dim * 2, 3, padding=1,
                                            bias=False))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return pixel_shuffle(conv_nhwc(self.body[0], x, dtype))


class Restormer(nn.Module):
    """``restormer_arch.py:Restormer`` (no dual-pixel task, no biases,
    BiasFree LayerNorms) on (B, H, W, C) channels-last tensors in compute
    ``dtype``: ``forward`` takes the network's input as (B, H, W, in) and
    returns the output conv's (B, H, W, out) in ``dtype``; the global
    residual is the caller's."""

    def __init__(self, in_channels: int = 2, out_channels: int = 1,
                 dim: int = DIM, num_blocks: Sequence[int] = NUM_BLOCKS,
                 num_refinement_blocks: int = NUM_REFINEMENT,
                 heads: Sequence[int] = HEADS,
                 ffn_expansion_factor: float = FFN_EXPANSION,
                 dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        if len(num_blocks) != 4 or len(heads) != 4:
            raise ValueError(f"Restormer has four levels, got num_blocks="
                             f"{num_blocks}, heads={heads}")
        self.dtype = dt = compute_dtype(dtype)

        def level(width, n, h):
            return nn.Sequential(*[TransformerBlock(
                width, h, ffn_expansion_factor, dt) for _ in range(n)])

        d = [dim, dim * 2, dim * 4, dim * 8]
        self.patch_embed = OverlapPatchEmbed(in_channels, dim)
        self.encoder_level1 = level(d[0], num_blocks[0], heads[0])
        self.down1_2 = Downsample(d[0])
        self.encoder_level2 = level(d[1], num_blocks[1], heads[1])
        self.down2_3 = Downsample(d[1])
        self.encoder_level3 = level(d[2], num_blocks[2], heads[2])
        self.down3_4 = Downsample(d[2])
        self.latent = level(d[3], num_blocks[3], heads[3])
        self.up4_3 = Upsample(d[3])
        self.reduce_chan_level3 = nn.Conv2d(d[3], d[2], 1, bias=False)
        self.decoder_level3 = level(d[2], num_blocks[2], heads[2])
        self.up3_2 = Upsample(d[2])
        self.reduce_chan_level2 = nn.Conv2d(d[2], d[1], 1, bias=False)
        self.decoder_level2 = level(d[1], num_blocks[1], heads[1])
        self.up2_1 = Upsample(d[1])
        self.decoder_level1 = level(d[1], num_blocks[0], heads[0])
        self.refinement = level(d[1], num_refinement_blocks, heads[0])
        self.output = nn.Conv2d(d[1], out_channels, 3, padding=1, bias=False)
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        if h % SIDE_MULTIPLE or w % SIDE_MULTIPLE:
            raise ValueError(f"Restormer takes sides divisible by "
                             f"{SIDE_MULTIPLE}, got {h}x{w}; pad the image "
                             "outside the network")
        dt = self.dtype
        enc1 = self.encoder_level1(conv_nhwc(self.patch_embed.proj, x, dt))
        enc2 = self.encoder_level2(self.down1_2(enc1, dt))
        enc3 = self.encoder_level3(self.down2_3(enc2, dt))
        latent = self.latent(self.down3_4(enc3, dt))
        y = torch.cat([self.up4_3(latent, dt), enc3], dim=-1)
        y = self.decoder_level3(pointwise(self.reduce_chan_level3, y, dt))
        y = torch.cat([self.up3_2(y, dt), enc2], dim=-1)
        y = self.decoder_level2(pointwise(self.reduce_chan_level2, y, dt))
        y = torch.cat([self.up2_1(y, dt), enc1], dim=-1)
        y = self.refinement(self.decoder_level1(y))
        return conv_out_nhwc(self.output, y, dt)


class RestormerDenoiser(nn.Module):
    """Frozen plug-in prior with ``UNetDenoiser``'s contract: ``(x (B, 1, H,
    W), sigma scalar or (B,))`` -> clamped (B, 1, H, W), in the dtype of
    ``x`` whatever the compute ``dtype``. The network's input is the image
    and its sigma map (as DPIR's and the DT4IR U-Net's), and its global
    residual adds the image channel. Inside an evaluator's rollout on CUDA
    the forward replays a CUDA graph (:mod:`.prior_graphs`)."""

    def __init__(self, dim: int = DIM, num_blocks: Sequence[int] = NUM_BLOCKS,
                 num_refinement_blocks: int = NUM_REFINEMENT,
                 heads: Sequence[int] = HEADS,
                 ffn_expansion_factor: float = FFN_EXPANSION,
                 dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        self.net = Restormer(2, 1, dim, num_blocks, num_refinement_blocks,
                             heads, ffn_expansion_factor, dtype)

    def forward(self, x: torch.Tensor, sigma) -> torch.Tensor:
        with annotate(RESTORMER):
            return run_prior(self, self._denoise, x, sigma)

    def _denoise(self, x: torch.Tensor, sigma) -> torch.Tensor:
        b, _, h, w = x.shape
        sigma = torch.as_tensor(sigma, dtype=x.dtype, device=x.device)
        inp = torch.cat([x.reshape(b, h, w, 1),
                         sigma.reshape(-1, 1, 1, 1).expand(b, h, w, 1)], -1)
        out = self.net(inp.to(self.net.dtype))
        return torch.clamp(out.to(x.dtype).reshape(b, 1, h, w) + x, 0.0, 1.0)


def random_restormer_state_dict(seed: int = 0, dim: int = DIM,
                                num_blocks: Sequence[int] = NUM_BLOCKS,
                                num_refinement_blocks: int = NUM_REFINEMENT,
                                heads: Sequence[int] = HEADS,
                                ffn_expansion_factor: float = FFN_EXPANSION
                                ) -> Dict[str, torch.Tensor]:
    """Random ``RestormerDenoiser`` weights from ``seed``, near-contractive
    like a trained prior.

    Restormer adds its output conv's result to the image, so random
    weights alone would add a random map of it. Here the linear path from
    the patch embedding through the first level's residual stream (its
    skip into decoder level 1, the last ``dim`` channels there) to the
    output conv makes the prior close to a mild smoothing of the image:
    embedding channel c takes the image's centre tap times a_c, the output
    conv takes channel ``dim + c`` through (smoothing - identity) times
    a_c / |a|^2, each with noise of ``EDGE_NOISE`` of its scale. The sigma
    map enters the embedding along a direction orthogonal to a, times
    ``SIGMA_GAIN``, so that the stream is never near zero where the image
    is dark (a LayerNorm of a near-zero vector would amplify any rounding).
    The other convs keep their input's scale (1 / fan_in), each block's two
    output 1x1 convs are damped by ``RES_GAIN``, so that every level moves
    the answer by a modest, not a negligible, share, and the LayerNorm
    scales and temperatures are N(1, AROUND_ONE^2).
    """
    gen = torch.Generator().manual_seed(seed)
    shapes = RestormerDenoiser(dim, num_blocks, num_refinement_blocks, heads,
                               ffn_expansion_factor).state_dict()

    def randn(*shape):
        return torch.randn(*shape, generator=gen)

    sd = {}
    for name, t in shapes.items():
        if t.ndim != 4:                 # LayerNorm weight, temperature
            sd[name] = 1.0 + AROUND_ONE * randn(*t.shape)
            continue
        fan_in = t.shape[1] * t.shape[2] * t.shape[3]
        gain = RES_GAIN if name.endswith("project_out.weight") else 1.0
        sd[name] = gain * fan_in ** -0.5 * randn(*t.shape)

    a, a2 = randn(dim), randn(dim)
    a2 -= a * (a2.dot(a) / a.dot(a))
    head = EDGE_NOISE / 3.0 * randn(dim, 2, 3, 3)
    head[:, 0, 1, 1] += a
    head[:, 1, 1, 1] += SIGMA_GAIN * a2
    b = a / a.dot(a)
    step = torch.tensor(SMOOTH) / sum(map(sum, SMOOTH))
    step[1, 1] -= 1.0                   # smoothing less the identity
    tail = EDGE_NOISE / 3.0 * b.norm() / dim ** 0.5 * randn(1, 2 * dim, 3, 3)
    tail[0, dim:] += b[:, None, None] * step
    sd["net.patch_embed.proj.weight"], sd["net.output.weight"] = head, tail
    return sd
