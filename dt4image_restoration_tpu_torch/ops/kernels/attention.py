"""K4: causal softmax attention for short sequences (``csrc/attention.cu``).

Replaces the TPU kernel ``fused_causal_attention``
(``dt4image_restoration_tpu/ops/pallas/attention.py``), which the per-op
Decision Transformer's attention calls when ``ModelConfig.use_pallas`` is
set and the model is not training. One thread block per (batch, head) pair
and tile of query rows computes ``QK^T / sqrt(D)``, the causal mask, the
softmax and ``PV`` with the keys and values its rows see in shared memory;
the (T, T) scores never reach device memory. The kernel reads q, k and v as
the strided views the per-op forward cuts from its QKV projection and
writes a (B, T, H, D) buffer, so neither side of the call copies. See the
source for the details.

:func:`fused_causal_attention_plain` is the plain PyTorch version of the
same arithmetic (masked with -1e30 like the TPU kernel), which the wrapper
runs for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

__all__ = ["MAX_HEAD_DIM", "MAX_TOKENS", "fused_causal_attention",
           "fused_causal_attention_plain"]

launches = 0  # kernel launches since the last reset

MAX_TOKENS = 96    # three keys per lane of a warp
MAX_HEAD_DIM = 64  # two output columns per lane
NEG_INF = -1e30


def fused_causal_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor) -> torch.Tensor:
    """Causal softmax attention on (B, H, T, D) tensors -> (B, H, T, D)."""
    t, d = q.shape[-2:]
    s = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    causal = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    s = torch.where(causal, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return (p / p.sum(dim=-1, keepdim=True)) @ v


@functools.lru_cache(maxsize=None)
def _lib():
    fn = _build.load("attention").causal_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_causal_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """Causal softmax attention.

    Args:
      q, k, v: (B, H, T, D) float32. On CUDA 1 <= T <= 96 and D <= 64, the
        last stride is 1, and k and v have q's strides: views of one
        (B, T, 3, H, D) or (B, T, 3 H D) buffer, as the per-op forward cuts
        them, are taken as they are, at any alignment (16-byte copies where
        the addresses and strides allow them).
    Returns (B, H, T, D): on CUDA the transposed view of a new contiguous
    (B, T, H, D) tensor, so ``out.transpose(1, 2)`` is contiguous.
    """
    if not q.is_cuda:
        if q.device.type == "cpu":
            return fused_causal_attention_plain(q, k, v)
        raise ValueError(f"unsupported device {q.device}")
    if q.ndim != 4:
        raise ValueError(f"q must be (B, H, T, D), got {tuple(q.shape)}")
    b, h, t, d = shape = q.shape
    if not 1 <= t <= MAX_TOKENS or not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"attention kernel takes T <= {MAX_TOKENS} and "
                         f"D <= {MAX_HEAD_DIM}; got T={t}, D={d}")
    f32 = torch.float32
    if q.dtype is not f32 or k.dtype is not f32 or v.dtype is not f32:
        name, x = next((n, x) for n, x in (("q", q), ("k", k), ("v", v))
                       if x.dtype is not f32)
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    index = q.get_device()
    if k.shape != shape or v.shape != shape or k.get_device() != index \
            or v.get_device() != index:
        name, x = ("k", k) if k.shape != shape or k.device != q.device \
            else ("v", v)
        raise ValueError(f"{name} is {tuple(x.shape)} on {x.device}; "
                         f"q is {tuple(shape)} on {q.device}")
    sb, sh, st, sd = strides = q.stride()
    if sd != 1:
        raise ValueError("q, k and v must have a last stride of 1; q has "
                         f"strides {strides}")
    if k.stride() != strides or v.stride() != strides:
        raise ValueError(f"k and v must have q's strides {strides}; got "
                         f"{k.stride()} and {v.stride()}")
    out = q.new_empty((b, t, h, d))
    if b * h == 0:
        return out.transpose(1, 2)
    with _build.on_device(index):
        rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), b, h, t, d, sb, sh, st,
                    _build.stream_handle(index))
    _build.check(rc, "fused_causal_attention")
    _build.count_launch(__name__)
    return out.transpose(1, 2)
