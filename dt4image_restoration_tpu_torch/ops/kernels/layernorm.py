"""K5: row LayerNorm over the last axis (``csrc/layernorm.cu``).

Replaces the TPU kernel ``layernorm_pallas``
(``dt4image_restoration_tpu/ops/pallas/layernorm.py``), which the per-op
Decision Transformer's LayerNorms call when ``ModelConfig.use_pallas`` is
set. On the H100 a LayerNorm of a few hundred 128-wide rows is bound by
memory traffic and, at that size, by launch latency; the kernel is one
pass with one warp per row, in blocks sized so that the rows spread over
every SM; see the source for the details.

:func:`layernorm_plain` is the plain PyTorch version with the same
two-pass (centred) variance, which the wrapper runs for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["MAX_FEATURES", "layernorm", "layernorm_plain"]

launches = 0  # kernel launches since the last reset

MAX_FEATURES = 1024   # 32 lanes x 8 float4 registers per lane


def layernorm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """``(x - mean) * rsqrt(var + eps) * scale + bias`` over the last axis,
    with the variance taken about the mean."""
    mean = x.mean(dim=-1, keepdim=True)
    centered = x - mean
    var = (centered * centered).mean(dim=-1, keepdim=True)
    return centered * torch.rsqrt(var + eps) * scale + bias


@functools.lru_cache(maxsize=None)
def _lib():
    fn = _build.load("layernorm").layernorm_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of a (..., E) float32 tensor over E with (E,) ``scale`` and
    ``bias``. On CUDA, E must be a multiple of 4 up to
    :data:`MAX_FEATURES` and every tensor contiguous and 16-byte aligned.
    Returns a new tensor shaped like ``x``."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return layernorm_plain(x, scale, bias, eps)
        raise ValueError(f"unsupported device {x.device}")
    e = x.shape[-1]
    f32 = torch.float32
    if x.dtype is not f32 or scale.dtype is not f32 \
            or bias.dtype is not f32:
        raise TypeError("x, scale and bias must be float32")
    if scale.shape != (e,) or bias.shape != (e,):
        raise ValueError(f"scale and bias must be ({e},), got "
                         f"{tuple(scale.shape)} and {tuple(bias.shape)}")
    if e % 4 or not 4 <= e <= MAX_FEATURES:
        raise ValueError(f"layernorm kernel takes E a multiple of 4 up to "
                         f"{MAX_FEATURES}; got E={e}")
    index = x.get_device()
    if scale.get_device() != index or bias.get_device() != index:
        name, t = ("scale", scale) if scale.device != x.device \
            else ("bias", bias)
        raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if not (x.is_contiguous() and scale.is_contiguous()
            and bias.is_contiguous()) \
            or (x.data_ptr() | scale.data_ptr() | bias.data_ptr()) % 16:
        name = next(n for n, t in (("x", x), ("scale", scale),
                                   ("bias", bias))
                    if not t.is_contiguous() or t.data_ptr() % 16)
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    out = torch.empty_like(x)
    rows = x.numel() // e
    if rows == 0:
        return out
    with _build.on_device(index):
        rc = _lib()(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                    out.data_ptr(), rows, e, eps,
                    _build.stream_handle(index))
    _build.check(rc, "layernorm")
    _build.count_launch(__name__)
    return out
