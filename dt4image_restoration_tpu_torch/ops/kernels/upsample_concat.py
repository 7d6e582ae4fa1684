"""K6: the U-Net decoder's 2x bilinear upsampling, pad-to-match and skip
concat in one launch (``csrc/upsample_concat.cu``).

Replaces no TPU kernel: the JAX package upsamples with two XLA matmuls
(``dt4image_restoration_tpu/ops/image.py:bilinear_upsample_2x``) and lets
XLA fuse the pad and the concat. On the H100 the same three steps in
PyTorch were ``F.interpolate`` (an NCHW kernel whose parallelism grows
only with the output's height x width), ``F.pad`` and ``torch.cat`` (a
second read and write of the upsampled tensor). The kernel writes the
concat once, bound by memory traffic; see the source for the details. Its
arithmetic is ``F.interpolate``'s, so the two agree bit for bit.

:func:`upsample_concat_plain` is the plain PyTorch version, the
composition the kernel replaces, which the wrapper runs for tensors on the
CPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..image import bilinear_upsample_2x
from . import _build

__all__ = ["upsample_concat", "upsample_concat_plain"]

launches = 0  # kernel launches since the last reset

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _pad_to_match(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Pad x1 spatially to x2's size, splitting the difference like the
    reference decoder (a no-op for power-of-two inputs)."""
    dy = x2.shape[-2] - x1.shape[-2]
    dx = x2.shape[-1] - x1.shape[-1]
    if dy == 0 and dx == 0:
        return x1
    return F.pad(x1, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))


def upsample_concat_plain(a: torch.Tensor, skip: torch.Tensor
                          ) -> torch.Tensor:
    """``cat([skip, up], 1)``, ``up`` being ``bilinear_upsample_2x(a)``
    padded to the size of ``skip``."""
    return torch.cat([skip, _pad_to_match(bilinear_upsample_2x(a), skip)],
                     dim=1)


@functools.lru_cache(maxsize=None)
def _lib():
    fn = _build.load("upsample_concat").upsample_concat_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def upsample_concat(a: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """The decoder's input: ``skip`` (B, Cs, Hs, Ws) and ``a`` (B, Ca, Ha,
    Wa) upsampled 2x (bilinear, align_corners=True) and padded to (Hs, Ws)
    -> a new (B, Cs + Ca, Hs, Ws) tensor. On CUDA both must be float32 or
    both bfloat16, contiguous, on one device."""
    if not a.is_cuda:
        if a.device.type == "cpu":
            return upsample_concat_plain(a, skip)
        raise ValueError(f"unsupported device {a.device}")
    dtype = _DTYPES.get(a.dtype)
    if dtype is None or skip.dtype is not a.dtype:
        raise TypeError(f"upsample_concat takes a and skip both float32 or "
                        f"both bfloat16; got {a.dtype} and {skip.dtype}")
    if a.ndim != 4 or skip.ndim != 4 or a.shape[0] != skip.shape[0]:
        raise ValueError(f"a and skip must be (B, C, H, W) of one batch; "
                         f"got {tuple(a.shape)} and {tuple(skip.shape)}")
    index = a.get_device()
    if skip.get_device() != index:
        raise ValueError(f"skip is on {skip.device}, a on {a.device}")
    if not (a.is_contiguous() and skip.is_contiguous()):
        raise ValueError("a and skip must be contiguous")
    b, ca, ha, wa = a.shape
    _, cs, hs, ws = skip.shape
    out = torch.empty((b, cs + ca, hs, ws), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    with _build.on_device(index):
        rc = _lib()(a.data_ptr(), skip.data_ptr(), out.data_ptr(), dtype, b,
                    cs, ca, ha, wa, hs, ws, (hs - 2 * ha) // 2,
                    (ws - 2 * wa) // 2, _build.stream_handle(index))
    _build.check(rc, "upsample_concat")
    _build.count_launch(__name__)
    return out
