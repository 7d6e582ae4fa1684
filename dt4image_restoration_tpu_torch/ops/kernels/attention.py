"""K4: causal softmax attention for short sequences (``csrc/attention.cu``).

Replaces the TPU kernel ``fused_causal_attention``
(``dt4image_restoration_tpu/ops/pallas/attention.py``), which the per-op
Decision Transformer's attention calls when ``ModelConfig.use_pallas`` is
set and the model is not training. One thread block per (batch, head) pair
computes ``QK^T / sqrt(D)``, the causal mask, the softmax and ``PV`` with
the pair's Q, K and V in shared memory; the (T, T) scores never reach
device memory. See the source for the details.

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

MAX_TOKENS = 32    # one key per lane of a warp
MAX_HEAD_DIM = 64  # Q, K and V of a pair within 25 KB of shared memory
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
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_causal_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """Causal softmax attention.

    Args:
      q, k, v: (B, H, T, D) float32, contiguous; on CUDA T <= 32 and
        D <= 64.
    Returns a new (B, H, T, D) tensor.
    """
    global launches
    if q.device.type == "cpu":
        return fused_causal_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.ndim != 4:
        raise ValueError(f"q must be (B, H, T, D), got {tuple(q.shape)}")
    b, h, t, d = q.shape
    if not 1 <= t <= MAX_TOKENS or not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"attention kernel takes T <= {MAX_TOKENS} and "
                         f"D <= {MAX_HEAD_DIM}; got T={t}, D={d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.shape != q.shape or x.device != q.device:
            raise ValueError(f"{name} is {tuple(x.shape)} on {x.device}; "
                             f"q is {tuple(q.shape)} on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty_like(q)
    if b * h == 0:
        return out
    with torch.cuda.device(q.device):
        rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), b * h, t, d,
                    _build.stream_handle(q.device))
    _build.check(rc, "fused_causal_attention")
    launches += 1
    return out
