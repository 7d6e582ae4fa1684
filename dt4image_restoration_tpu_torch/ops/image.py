"""Image resampling (counterpart of the JAX package's
``ops/image.py:bilinear_upsample_2x``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_upsample_2x(img: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample with align_corners=True on NCHW images (the
    U-Net decoder's ``nn.Upsample``)."""
    return F.interpolate(img, scale_factor=2, mode="bilinear",
                         align_corners=True)
