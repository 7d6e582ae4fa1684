"""Numerics ops of the port. Kernels live in :mod:`.kernels`."""
from .csmri import kspace_consistency
from .fourier import fft2c, ifft2c
from .image import bilinear_upsample_2x
from .metrics import psnr

__all__ = ["bilinear_upsample_2x", "fft2c", "ifft2c", "kspace_consistency",
           "psnr"]
