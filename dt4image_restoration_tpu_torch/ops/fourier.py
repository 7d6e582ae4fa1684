"""Centered orthonormal 2-D FFT pair, the CSMRI forward operator core.

``ifftshift -> fftn(norm='ortho') -> fftshift`` over the last two axes, so
the DC component sits at the image centre in k-space (counterpart of the JAX
package's ``ops/fourier.py``).
"""
from __future__ import annotations

import torch

_DIMS = (-2, -1)


def fft2c(img: torch.Tensor) -> torch.Tensor:
    """Centered orthonormal forward 2-D FFT over the last two axes."""
    out = torch.fft.ifftshift(img, dim=_DIMS)
    out = torch.fft.fftn(out, dim=_DIMS, norm="ortho")
    return torch.fft.fftshift(out, dim=_DIMS)


def ifft2c(ksp: torch.Tensor) -> torch.Tensor:
    """Centered orthonormal inverse 2-D FFT over the last two axes."""
    out = torch.fft.ifftshift(ksp, dim=_DIMS)
    out = torch.fft.ifftn(out, dim=_DIMS, norm="ortho")
    return torch.fft.fftshift(out, dim=_DIMS)
