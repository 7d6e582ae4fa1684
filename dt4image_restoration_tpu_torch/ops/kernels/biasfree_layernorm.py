"""K8: Restormer's BiasFree LayerNorm (``csrc/biasfree_layernorm.cu``).

Replaces no TPU kernel (the JAX package has no Restormer). Over the last
axis of a contiguous (..., C) tensor, ``x / sqrt(var(x) + eps) * w``: the
variance about the mean, ``x`` itself not centred, the statistics and the
product in float32 and the result rounded once to ``x``'s dtype. The
kernel reads each row once and writes it once, a few neighbouring lanes a
row; see the source for the layout.

:func:`biasfree_layernorm_plain` is the plain PyTorch version
(``restormer_arch.py:BiasFree_LayerNorm`` in float32), which the wrapper
runs for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["MAX_WIDTH", "biasfree_layernorm", "biasfree_layernorm_plain"]

launches = 0  # kernel launches since the last reset

# The widest row (Restormer's latent level); the kernel takes every multiple
# of 8 up to it, with builds of its own for Restormer's 48, 96, 192 and 384.
MAX_WIDTH = 384
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def biasfree_layernorm_plain(x: torch.Tensor, w: torch.Tensor, eps: float
                             ) -> torch.Tensor:
    """``x / sqrt(var(x, unbiased=False) + eps) * w`` over the last axis,
    computed in float32 and cast to ``x``'s dtype."""
    xf = x.float()
    var = xf.var(-1, keepdim=True, unbiased=False)
    return (xf / torch.sqrt(var + eps) * w.float()).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    fn = _build.load("biasfree_layernorm").biasfree_layernorm_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_int, ctypes.c_float,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def biasfree_layernorm(x: torch.Tensor, w: torch.Tensor, eps: float
                       ) -> torch.Tensor:
    """:func:`biasfree_layernorm_plain`'s result. On CUDA, ``x`` is a
    nonempty contiguous bfloat16 or float32 tensor whose last axis C is a
    multiple of 8 up to :data:`MAX_WIDTH`, and ``w`` the (C,) float32
    scale on its device, both 16-byte aligned."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return biasfree_layernorm_plain(x, w, eps)
        raise ValueError(f"unsupported device {x.device}")
    dtype = _DTYPES.get(x.dtype)
    if dtype is None:
        raise TypeError(f"biasfree_layernorm takes bfloat16 or float32 x, "
                        f"got {x.dtype}")
    c = x.shape[-1] if x.ndim else 0
    if c % 8 or not 0 < c <= MAX_WIDTH or x.numel() == 0:
        raise ValueError(f"biasfree_layernorm takes a nonempty x whose last "
                         f"axis is a multiple of 8 up to {MAX_WIDTH}; got "
                         f"{tuple(x.shape)}")
    if w.dtype is not torch.float32 or w.shape != (c,):
        raise ValueError(f"w must be ({c},) float32; got {tuple(w.shape)} "
                         f"{w.dtype}")
    index = x.get_device()
    if w.get_device() != index:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    y = torch.empty_like(x)
    with _build.on_device(index):
        rc = _lib()(x.data_ptr(), w.data_ptr(), y.data_ptr(), dtype,
                    x.numel() // c, c, eps, _build.stream_handle(index))
    _build.check(rc, "biasfree_layernorm")
    _build.count_launch(__name__)
    return y
