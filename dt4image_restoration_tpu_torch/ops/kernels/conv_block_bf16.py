"""K1 in bfloat16: a whole U-Net ConvBlock in one kernel
(``csrc/conv_block_bf16.cu``).

Replaces the TPU kernel ``fused_conv_block``
(``dt4image_restoration_tpu/ops/pallas/conv_block.py``) called with
bfloat16 operands, as the U-Net's ``pallas`` mode does under
``--dtype bfloat16``: L chained [3x3 SAME conv + bias + LeakyReLU] layers
on bfloat16 input, weights and biases, every product summed in float32,
bias and LeakyReLU in float32, and each layer's result rounded to
nearest-even bfloat16. On the H100 the block is bound by tensor-core
operations at the dense bfloat16 rate: each layer is an implicit GEMM on
``mma.sync`` m16n8k16 bfloat16 tiles with float32 accumulators, one product
a term (the float32 K1 takes three). The tiling is the float32 K1's; see
the source for the layout of the activations and of the weights, which
:func:`fragments` packs once.

The weights are packed by ``conv_block.pack_conv_block(...,
dtype=torch.bfloat16)``; ``conv_block.conv_block`` calls
:func:`conv_block_bf16` for such a block. It has its own launch count.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["conv_block_bf16", "conv_block_bf16_plain", "fragments"]

launches = 0  # kernel launches since the last reset

MAX_FEATURES = 32
MAX_LAYERS = 4


def fragments(w: torch.Tensor) -> torch.Tensor:
    """One layer's (Ci, 3, 3, F) weights in the kernel's m16n8k16 B-fragment
    order, as bfloat16.

    Ci is zero-padded to a multiple of 16 (one k16 step) and F to a multiple
    of 8. For each group of 16 input channels, tap and n-tile of 8 outputs,
    lane ``4g + t`` of a warp holds two 32-bit words: the weights of input
    channels (2t, 2t + 1) and (2t + 8, 2t + 9) to output g, the even channel
    in the low half. Shape (Ci/16, 9, F/8, 8, 4, 2, 2), flattened.
    """
    ci, _, _, f = w.shape
    cp, fp = -(-ci // 16) * 16, -(-f // 8) * 8
    w = F.pad(w.detach().to(torch.bfloat16),
              (0, fp - f, 0, 0, 0, 0, 0, cp - ci))
    # channel = 16 group + 8 word + 2 t + half, output = 8 n-tile + g
    w = w.reshape(cp // 16, 2, 4, 2, 9, fp // 8, 8).permute(0, 4, 5, 6, 2, 1,
                                                           3)
    return w.contiguous().reshape(-1)


def conv_block_bf16_plain(x: torch.Tensor, packed,
                          negative_slope: float = 0.2) -> torch.Tensor:
    """Plain PyTorch version: per layer, the nine taps of the 3x3 SAME conv
    as shifted (Ci -> F) products of the bfloat16 values summed in float32,
    then the bfloat16 bias and LeakyReLU in float32, then rounding to
    bfloat16. NCHW in, NCHW bfloat16 out."""
    x = x.to(torch.bfloat16)
    for layer in range(packed.layers):
        w = packed.layer_weight(layer).float()
        xf = F.pad(x.float(), (1, 1, 1, 1))
        _, _, h, wd = x.shape
        acc = None
        for ky in range(3):
            for kx in range(3):
                term = torch.einsum("bchw,cf->bfhw",
                                    xf[:, :, ky:ky + h, kx:kx + wd],
                                    w[:, ky, kx, :])
                acc = term if acc is None else acc + term
        bias = packed.biases[layer].float().view(1, -1, 1, 1)
        x = F.leaky_relu(acc + bias, negative_slope).to(torch.bfloat16)
    return x


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("conv_block_bf16")
    fn = lib.conv_block_bf16_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def conv_block_bf16(x: torch.Tensor, packed,
                    negative_slope: float = 0.2) -> torch.Tensor:
    """L x [3x3 SAME conv + bias + LeakyReLU] on NCHW bfloat16 ``x``
    (B, Cin, H, W) -> bfloat16 (B, F, H, W), with the weights of a
    ``PackedConvBlock`` packed in bfloat16."""
    global launches
    if x.device.type == "cpu":
        return conv_block_bf16_plain(x, packed, negative_slope)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or packed.tc_weights.dtype != torch.bfloat16 \
            or packed.biases.dtype != torch.bfloat16:
        raise TypeError("conv_block_bf16 kernel takes bfloat16 input and "
                        "weights")
    if x.ndim != 4 or x.shape[1] != packed.cin:
        raise ValueError(f"x must be (B, {packed.cin}, H, W), "
                         f"got {tuple(x.shape)}")
    if packed.features % 8 or packed.features > MAX_FEATURES \
            or not 1 <= packed.layers <= MAX_LAYERS:
        raise ValueError(
            f"conv_block_bf16 kernel takes F % 8 == 0, F <= {MAX_FEATURES} "
            f"and 1..{MAX_LAYERS} layers; got F={packed.features}, "
            f"L={packed.layers}")
    for name, t in (("x", x), ("weights", packed.tc_weights),
                    ("biases", packed.biases)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, _, h, w = x.shape
    out = torch.empty((b, packed.features, h, w), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    fn = _lib()
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), packed.tc_weights.data_ptr(),
                packed.biases.data_ptr(), out.data_ptr(), b, packed.cin, h,
                w, packed.features, packed.layers, float(negative_slope),
                _build.stream_handle(x.device))
    _build.check(rc, "conv_block_bf16")
    launches += 1
    return out
