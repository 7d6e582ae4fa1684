"""CSMRI data-consistency operator and the single-photon-imaging proximal
operator (counterpart of the JAX package's ``ops/csmri.py``).

``kspace_consistency`` is the plain PyTorch version of kernel K2
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


def spi_inverse(ztilde: torch.Tensor, k1: torch.Tensor, k: torch.Tensor,
                mu, n_iters: int = 10) -> torch.Tensor:
    """Proximal operator of single-photon imaging, Prox_{(1/mu) D}.

    Where ``k1 == 0`` the closed form ``ztilde - K0/mu`` applies, with
    K0 = k^2 - k1; elsewhere ``n_iters`` bisection steps on [1e-5, 1.1]
    solve ``k1/(exp(y)-1) - mu*y - K0 + mu*ztilde = 0``. An entry whose
    midpoint is an exact root stops moving. The result is clamped to
    [0, 1].
    """
    k0 = k ** 2 - k1
    frozen = k1 == 0

    def f(y):
        return k1 / (torch.exp(y) - 1.0) - mu * y - k0 + mu * ztilde

    bmin = torch.full_like(ztilde, 1e-5)
    bmax = torch.full_like(ztilde, 1.1)
    bave = (bmin + bmax) / 2.0
    for _ in range(n_iters):
        val = f(bave)
        active = ~frozen
        bmin = torch.where((val > 0) & active, bave, bmin)
        bmax = torch.where((val < 0) & active, bave, bmax)
        frozen = frozen | ((val == 0) & active)
        bave = torch.where(~frozen, (bmin + bmax) / 2.0, bave)
    z = torch.where(k1 == 0, ztilde - k0 / mu, bave)
    return torch.clamp(z, 0.0, 1.0)
