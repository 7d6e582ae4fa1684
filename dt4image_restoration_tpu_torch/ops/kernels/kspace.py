"""K2: masked k-space data consistency (``csrc/kspace.cu``).

Replaces the TPU kernel ``kspace_consistency_pallas``
(``dt4image_restoration_tpu/ops/pallas/kspace.py``). On the H100 the
update is bound by memory traffic (25 bytes per complex element for six
flops), so the kernel is one coalesced pass over the interleaved complex64
data with one thread per element; see the source for the details.

The plain PyTorch version is :func:`..csmri.kspace_consistency`, which the
wrapper runs for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..csmri import kspace_consistency as kspace_consistency_plain
from . import _build

__all__ = ["kspace_consistency_kernel", "kspace_consistency_plain"]

launches = 0  # kernel launches since the last reset


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("kspace")
    fn = lib.kspace_consistency_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kspace_consistency_kernel(z: torch.Tensor, y0: torch.Tensor,
                              mask: torch.Tensor, mu: torch.Tensor
                              ) -> torch.Tensor:
    """``where(mask, (mu*z + y0) / (1 + mu), z)`` with one ``mu`` per slice.

    Args:
      z, y0: (B, ...) complex64 k-space, contiguous.
      mask: (B, ...) bool, the shape of ``z``.
      mu: (B,) float32.
    Returns a new complex64 tensor shaped like ``z``.
    """
    if z.device.type == "cpu":
        return kspace_consistency_plain(z, y0, mask, mu)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    if z.dtype != torch.complex64 or y0.dtype != torch.complex64:
        raise TypeError("z and y0 must be complex64")
    if mask.dtype != torch.bool or mu.dtype != torch.float32:
        raise TypeError("mask must be bool and mu float32")
    if y0.shape != z.shape or mask.shape != z.shape:
        raise ValueError(f"shape mismatch: z {tuple(z.shape)}, "
                         f"y0 {tuple(y0.shape)}, mask {tuple(mask.shape)}")
    if mu.shape != (z.shape[0],):
        raise ValueError(f"mu must be ({z.shape[0]},), got {tuple(mu.shape)}")
    for name, t in (("z", z), ("y0", y0), ("mask", mask), ("mu", mu)):
        if t.device != z.device:
            raise ValueError(f"{name} is on {t.device}, z on {z.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty_like(z)
    n = z.numel()
    if n == 0:
        return out
    fn = _lib()
    with torch.cuda.device(z.device):
        rc = fn(z.data_ptr(), y0.data_ptr(), mask.data_ptr(), mu.data_ptr(),
                out.data_ptr(), n, n // z.shape[0],
                _build.stream_handle(z.device))
    _build.check(rc, "kspace_consistency")
    _build.count_launch(__name__)
    return out
