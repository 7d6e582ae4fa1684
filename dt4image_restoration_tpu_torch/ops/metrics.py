"""PSNR, the reward signal (counterpart of the JAX package's
``ops/metrics.py:psnr``)."""
from __future__ import annotations

import torch


def psnr(output: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB for data range [0, 1].

    The real part of ``output`` is clamped to [0, 1]; the MSE is taken per
    image over the flattened pixels. Returns (N, 1).
    """
    n = output.shape[0]
    if output.is_complex():
        output = output.real
    if gt.is_complex():
        gt = gt.real
    out = torch.clamp(output, 0.0, 1.0).reshape(n, -1)
    ref = gt.reshape(n, -1)
    mse = torch.mean((out - ref) ** 2, dim=1)
    return (10.0 * torch.log10(1.0 / mse))[:, None]
