"""K1: a whole U-Net ConvBlock in one kernel (``csrc/conv_block.cu``).

Replaces the TPU kernel ``fused_conv_block``
(``dt4image_restoration_tpu/ops/pallas/conv_block.py``): L chained
[3x3 SAME conv + bias + LeakyReLU] layers of equal width F whose
intermediate activations stay on chip. On the H100 the block is bound by
tensor-core operations: each layer is an implicit GEMM (pixels x F over 9
taps x input channels) on ``mma.sync`` TF32 tiles, and to stay
float32-accurate every operand is split into two TF32 parts and each
product taken three times (3xTF32), so the least time is 3x the flops over
the 495 TFLOP/s TF32 peak. The kernel tiles the output in 16x16 tiles with
a recomputed halo of one pixel per layer, keeps both intermediates in
shared memory and streams layer 0's input channels through it 16 at a
time, the next chunk copied with ``cp.async`` while the current one runs.
:func:`pack_conv_block` splits and swizzles the weights once, into the
order in which the kernel's lanes read them, so the kernel splits only the
activations. See the source for the details.

:func:`conv_block` is the wrapper on NCHW tensors that the U-Net calls;
:func:`fused_conv_block` takes NHWC input and HWIO weights like the JAX
function. :func:`conv_block_plain` is the plain PyTorch version: the same
nine shifted tap products per layer, as float32 matmuls.

A block packed with ``dtype=torch.bfloat16`` runs the bfloat16 K1 of
:mod:`.conv_block_bf16` instead, through the same two calls.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence

import torch
import torch.nn.functional as F

from . import _build
from . import conv_block_bf16 as _bf16

__all__ = ["PackedConvBlock", "conv_block", "conv_block_plain",
           "fused_conv_block", "pack_conv_block", "tf32_round"]

launches = 0  # kernel launches since the last reset

MAX_FEATURES = 32      # the kernel keeps 2 F-channel intermediates on chip
MAX_LAYERS = 4


@dataclasses.dataclass(frozen=True)
class PackedConvBlock:
    """A block's weights in the kernel's layout.

    ``weights`` is one flat buffer: layer 0 as (Cin, 3, 3, F), each later
    layer as (F, 3, 3, F). ``biases`` is (L, F). ``tc_weights`` is what the
    kernel reads: per layer, :func:`_fragments` of its weights. All three
    are float32, or all three bfloat16 for the bfloat16 kernel (whose
    ``tc_weights`` are :func:`.conv_block_bf16.wgmma_weights`).
    """
    weights: torch.Tensor
    biases: torch.Tensor
    cin: int
    features: int
    tc_weights: torch.Tensor

    @property
    def layers(self) -> int:
        return self.biases.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.weights.dtype

    def layer_weight(self, layer: int) -> torch.Tensor:
        """(Ci, 3, 3, F) view of one layer's weights."""
        f, cin = self.features, self.cin
        if layer == 0:
            return self.weights[:cin * 9 * f].view(cin, 3, 3, f)
        start = cin * 9 * f + (layer - 1) * 9 * f * f
        return self.weights[start:start + 9 * f * f].view(f, 3, 3, f)

    def layer_fragments(self, layer: int) -> torch.Tensor:
        """(Ci/8, 9, F/8, 8, 4, 4) view of one layer's ``tc_weights``, Ci
        and F padded to multiples of 8."""
        groups0, nt = -(-self.cin // 8), -(-self.features // 8)
        size = 9 * nt * 128                 # floats per 8-channel group
        groups = groups0 if layer == 0 else nt
        start = 0 if layer == 0 else (groups0 + (layer - 1) * nt) * size
        return self.tc_weights[start:start + groups * size].view(
            groups, 9, nt, 8, 4, 4)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """Float32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` does: the low 13 bits come out zero."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _fragments(w: torch.Tensor) -> torch.Tensor:
    """One layer's (Ci, 3, 3, F) weights in the kernel's B-fragment order.

    Ci and F are zero-padded to multiples of 8. For each group of 8 input
    channels, tap and n-tile of 8 outputs, lane ``4g + t`` of a warp holds
    ``(b0 hi, b1 hi, b0 lo, b1 lo)``: the weights of input channels t and
    t + 4 to output g, each split into ``hi = tf32(w)`` and
    ``lo = tf32(w - hi)``. Shape (Ci/8, 9, F/8, 8, 4, 4), flattened.
    """
    ci, _, _, f = w.shape
    cp, fp = -(-ci // 8) * 8, -(-f // 8) * 8
    w = F.pad(w.detach().float(), (0, fp - f, 0, 0, 0, 0, 0, cp - ci))
    # channel = 8 group + 4 half + t, output = 8 n-tile + g
    w = w.reshape(cp // 8, 2, 4, 9, fp // 8, 8).permute(0, 3, 4, 5, 2, 1)
    hi = tf32_round(w)
    lo = tf32_round(w - hi)
    return torch.cat([hi, lo], dim=-1).reshape(-1)


def pack_conv_block(weights: Sequence[torch.Tensor],
                    biases: Sequence[torch.Tensor],
                    layout: str = "oihw",
                    dtype: torch.dtype = torch.float32) -> PackedConvBlock:
    """Pack per-layer 3x3 weights (``'oihw'``: torch (F, Ci, 3, 3);
    ``'hwio'``: JAX (3, 3, Ci, F)) and (F,) biases for the float32 kernel,
    or rounded to bfloat16 for the bfloat16 one (``dtype``)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"conv_block packs float32 or bfloat16, not {dtype}")
    perm = {"oihw": (1, 2, 3, 0), "hwio": (2, 0, 1, 3)}[layout]
    ws = [w.permute(*perm).contiguous() for w in weights]
    cin, feats = ws[0].shape[0], ws[0].shape[-1]
    for i, w in enumerate(ws):
        want = (cin if i == 0 else feats, 3, 3, feats)
        if tuple(w.shape) != want:
            raise ValueError(f"layer {i}: want {want} (Ci, 3, 3, F), "
                             f"got {tuple(w.shape)}")
    frag = _fragments if dtype == torch.float32 else _bf16.wgmma_weights
    return PackedConvBlock(
        weights=torch.cat([w.reshape(-1) for w in ws]).to(dtype),
        biases=torch.stack(list(biases)).to(dtype).contiguous(),
        cin=cin, features=feats,
        tc_weights=torch.cat([frag(w) for w in ws]))


def conv_block_plain(x: torch.Tensor, packed: PackedConvBlock,
                     negative_slope: float = 0.2) -> torch.Tensor:
    """Plain PyTorch version: per layer, the nine taps of the 3x3 SAME conv
    as shifted (Ci -> F) products summed in float32, then bias and
    LeakyReLU. NCHW in, NCHW out. A bfloat16 block runs
    :func:`.conv_block_bf16.conv_block_bf16_plain`."""
    if packed.dtype == torch.bfloat16:
        return _bf16.conv_block_bf16_plain(x, packed, negative_slope)
    for layer in range(packed.layers):
        w = packed.layer_weight(layer)
        _, _, h, wd = x.shape
        xp = F.pad(x, (1, 1, 1, 1))
        acc = None
        for ky in range(3):
            for kx in range(3):
                term = torch.einsum("bchw,cf->bfhw",
                                    xp[:, :, ky:ky + h, kx:kx + wd],
                                    w[:, ky, kx, :])
                acc = term if acc is None else acc + term
        x = F.leaky_relu(acc + packed.biases[layer].view(1, -1, 1, 1),
                         negative_slope)
    return x


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("conv_block")
    fn = lib.conv_block_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def conv_block(x: torch.Tensor, packed: PackedConvBlock,
               negative_slope: float = 0.2) -> torch.Tensor:
    """L x [3x3 SAME conv + bias + LeakyReLU] on NCHW float32 ``x``
    (B, Cin, H, W) -> (B, F, H, W); a block packed in bfloat16 runs
    :func:`.conv_block_bf16.conv_block_bf16` on bfloat16 ``x``."""
    if packed.dtype == torch.bfloat16:
        return _bf16.conv_block_bf16(x, packed, negative_slope)
    if x.device.type == "cpu":
        return conv_block_plain(x, packed, negative_slope)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or packed.weights.dtype != torch.float32 \
            or packed.biases.dtype != torch.float32:
        raise TypeError("conv_block kernel takes float32 input and weights")
    if x.ndim != 4 or x.shape[1] != packed.cin:
        raise ValueError(f"x must be (B, {packed.cin}, H, W), "
                         f"got {tuple(x.shape)}")
    if packed.features % 8 or packed.features > MAX_FEATURES \
            or not 1 <= packed.layers <= MAX_LAYERS:
        raise ValueError(
            f"conv_block kernel takes F % 8 == 0, F <= {MAX_FEATURES} and "
            f"1..{MAX_LAYERS} layers; got F={packed.features}, "
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
    _build.check(rc, "conv_block")
    _build.count_launch(__name__)
    return out


def fused_conv_block(x: torch.Tensor, weights: Sequence[torch.Tensor],
                     biases: Sequence[torch.Tensor],
                     negative_slope: float = 0.2) -> torch.Tensor:
    """The JAX function's interface: NHWC ``x`` (B, H, W, Cin), HWIO
    weights (3, 3, Ci, F) and (F,) biases -> NHWC (B, H, W, F), in the
    dtype of ``x`` (float32 or bfloat16)."""
    packed = pack_conv_block(weights, biases, layout="hwio", dtype=x.dtype)
    out = conv_block(x.permute(0, 3, 1, 2).contiguous(), packed,
                     negative_slope)
    return out.permute(0, 2, 3, 1).contiguous()
