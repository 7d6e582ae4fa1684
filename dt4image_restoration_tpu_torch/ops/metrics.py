"""Image-quality metrics (counterpart of the JAX package's
``ops/metrics.py``): PSNR, the reward signal; SSIM with a Gaussian window;
the band-wise PSNR of multi-band images."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


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


def _gaussian_kernel1d(sigma: float, radius: int) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _symmetric_index(n: int, radius: int) -> torch.Tensor:
    """Indices of a length-``n`` axis padded by ``radius`` on both sides with
    the edge sample repeated (numpy's 'symmetric', scipy's 'reflect')."""
    i = torch.arange(-radius, n + radius) % (2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def _gaussian_filter(img: torch.Tensor, sigma: float, truncate: float
                     ) -> torch.Tensor:
    """``scipy.ndimage.gaussian_filter`` on a 2-D image (reflect boundary),
    as two separable 1-D convolutions in float32."""
    radius = int(truncate * sigma + 0.5)
    k = _gaussian_kernel1d(sigma, radius).to(img.device)
    img = img.float()
    h, w = img.shape
    rows = img[_symmetric_index(h, radius).to(img.device)]
    out = F.conv2d(rows[None, None], k.view(1, 1, -1, 1))[0, 0]
    cols = out[:, _symmetric_index(w, radius).to(img.device)]
    return F.conv2d(cols[None, None], k.view(1, 1, 1, -1))[0, 0]


def ssim(img1: torch.Tensor, img2: torch.Tensor, k1: float = 0.01,
         k2: float = 0.03, win_size: int = 11, data_range: float = 255.0
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Structural similarity of two 2-D images with a Gaussian window
    (sigma 1.5, truncated at ``win_size // 2`` sigmas). Returns
    ``(ssim_map, mean_ssim)``."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    sigma, truncate = 1.5, win_size // 2
    img1, img2 = img1.float(), img2.float()

    def filt(a):
        return _gaussian_filter(a, sigma, truncate)

    mu1, mu2 = filt(img1), filt(img2)
    s1 = filt(img1 ** 2) - mu1 ** 2
    s2 = filt(img2 ** 2) - mu2 ** 2
    s12 = filt(img1 * img2) - mu1 * mu2
    num = (2 * mu1 * mu2 + c1) * (2 * s12 + c2)
    den = (mu1 ** 2 + mu2 ** 2 + c1) * (s1 + s2 + c2)
    ssim_map = num / den
    return ssim_map, torch.mean(ssim_map)


def bandwise_psnr(x: torch.Tensor, y: torch.Tensor,
                  data_range: float = 255.0) -> torch.Tensor:
    """Mean over the bands (axis -3, and any leading axes) of each band's
    PSNR, the MSE taken over (H, W)."""
    err = torch.mean((x.float() - y.float()) ** 2, dim=(-2, -1))
    return torch.mean(10.0 * torch.log10((data_range ** 2) / err))
