"""CSMRI data-consistency operator (counterpart of the JAX package's
``ops/csmri.py:kspace_consistency``).

This is the plain PyTorch version of kernel K2
(``ops/kernels/kspace.py``): the same arithmetic, in the same order, on the
interleaved real/imag view of the complex k-space, so that the kernel and
this function agree bit for bit on the card.
"""
from __future__ import annotations

import torch


def kspace_consistency(z: torch.Tensor, y0: torch.Tensor, mask: torch.Tensor,
                       mu) -> torch.Tensor:
    """Masked k-space data-consistency update.

    At sampled k-space locations replace ``z`` with the mu-weighted blend
    ``(mu*z + y0) * 1/(1 + mu)`` of the estimate and the measured data;
    elsewhere keep ``z``.

    Args:
      z: complex64 k-space estimate, (B, ...).
      y0: complex64 measured k-space, same shape as ``z``.
      mask: bool sampling mask, same shape as ``z``.
      mu: ADMM penalty weight, a scalar or one value per slice (B,).
    """
    zr = torch.view_as_real(z)
    y0r = torch.view_as_real(y0)
    mu = torch.as_tensor(mu, dtype=zr.dtype, device=zr.device)
    mu = mu.reshape((-1,) + (1,) * (zr.ndim - 1))
    inv = 1.0 / (1.0 + mu)
    blended = (mu * zr + y0r) * inv
    out = torch.where(mask.unsqueeze(-1), blended, zr)
    return torch.view_as_complex(out.contiguous())
