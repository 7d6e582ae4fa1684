"""Operations and bytes of the DT4IR models, from their published shapes.

A FLOP is a multiply or an add: a product of (M, K) and (K, N) counts
2 M K N. What implements a layer does not change its count. The U-Net is
counted per forward of one slice: its 27 3x3 convolutions and the 1x1
head (pooling, upsampling, concatenation and activations are not
products). A policy forward counts its state encoder, its projections and
the causal attention products it needs (the lower triangle of the scores,
diagonal included); embeddings, LayerNorms and heads of a few columns are
left out. FFTs and elementwise work of the ADMM step are not counted.
"""
from __future__ import annotations

from typing import Dict, Tuple

from .weights import UNET_CHANNELS, state_conv_hw

# Peak rates of one NVIDIA H100 SXM (dense): float32 products run as
# 3xTF32 (the TF32 rate over three), bfloat16 at its tensor-core rate.
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def conv_flops(h: int, w: int, c_in: int, c_out: int, k: int) -> float:
    """A stride-1, same-padded k x k convolution over an h x w image."""
    return 2.0 * h * w * c_in * c_out * k * k


def unet_block_flops(cfg: Dict) -> Dict[str, float]:
    """FLOPs of each block of one U-Net forward on one slice: ``inc``,
    ``down1``..``down4``, ``up1``..``up4`` (3 convs each) and ``outc``."""
    s = cfg["image_size"]
    c = [cfg["base_channels"] * m for m in UNET_CHANNELS]

    def block(size, c_in, c_out):
        return sum(conv_flops(size, size, a, c_out, 3)
                   for a in (c_in, c_out, c_out))

    out = {"inc": block(s, cfg["in_channels"], c[0])}
    for k in range(1, 5):
        out[f"down{k}"] = block(s >> k, c[k - 1], c[k])
    for k in range(1, 5):
        out[f"up{k}"] = block(s >> (4 - k), c[4 - k] + c[5 - k], c[4 - k])
    out["outc"] = conv_flops(s, s, c[0], cfg["out_channels"], 1)
    return out


def unet_flops(cfg: Dict) -> float:
    """FLOPs of one U-Net forward on one slice."""
    return sum(unet_block_flops(cfg).values())


def unet_params(cfg: Dict) -> int:
    """Weights and biases of the U-Net."""
    s = 0
    c = [cfg["base_channels"] * m for m in UNET_CHANNELS]

    def block(c_in, c_out):
        return sum(a * c_out * 9 + c_out for a in (c_in, c_out, c_out))

    s += block(cfg["in_channels"], c[0])
    for k in range(1, 5):
        s += block(c[k - 1], c[k])
    for k in range(1, 5):
        s += block(c[4 - k] + c[5 - k], c[4 - k])
    return s + c[0] * cfg["out_channels"] + cfg["out_channels"]


def unet_bytes(cfg: Dict, batch: int) -> float:
    """Bytes one denoiser call at ``batch`` must move: its float32 input
    (image and noise map), its float32 output, and the weights in the
    compute dtype, each once."""
    s = cfg["image_size"]
    io = batch * s * s * (cfg["in_channels"] + cfg["out_channels"]) * 4
    return io + unet_params(cfg) * DTYPE_BYTES[cfg["dtype"]]


def bound_s(flops: float, nbytes: float, dtype: str) -> Tuple[float, str]:
    """The least time the card could take, and which bound sets it."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")


def unet_bound_s(cfg: Dict, batch: int) -> float:
    """The bound of one denoiser call at ``batch``."""
    return bound_s(batch * unet_flops(cfg), unet_bytes(cfg, batch),
                   cfg["dtype"])[0]


def state_encoder_flops(cfg: Dict) -> float:
    """The policy's state encoder on one observation."""
    s = cfg["image_size"]
    h0 = (s - 8) // 4 + 1
    h1 = (h0 - 4) // 2 + 1
    h2 = state_conv_hw(s)
    return (2.0 * h0 * h0 * 8 * 64 + 2.0 * h1 * h1 * 16 * 8 * 16
            + 2.0 * h2 * h2 * 16 * 16 * 9
            + 2.0 * 16 * h2 * h2 * cfg["embed_dim"])


def dt_stack_flops(cfg: Dict, tokens: int) -> float:
    """The transformer blocks of one forward over ``tokens`` tokens."""
    e, r = cfg["embed_dim"], cfg["mlp_ratio"]
    proj = 2.0 * tokens * e * (3 * e + e + 2 * r * e)
    attn = 2.0 * 2.0 * e * tokens * (tokens + 1) / 2
    return cfg["n_blocks"] * (proj + attn)


def slice_flops(cfg: Dict) -> float:
    """Model FLOPs of one slice's greedy episode of ``max_timesteps``
    steps, as the evaluator runs it: a U-Net forward a step; two policy
    forwards at the start (two- and three-token windows) and two
    three-token forwards after each step but the last; one state encoding
    a step, of x0 and of the zero image (the embedding cache)."""
    steps = cfg["max_timesteps"]
    ctx = cfg["block_size"] // 3
    forwards = dt_stack_flops(cfg, 2 * ctx) \
        + (1 + 2 * (steps - 1)) * dt_stack_flops(cfg, 3 * ctx)
    encodes = (steps + 1) * state_encoder_flops(cfg)
    return steps * unet_flops(cfg) + forwards + encodes
