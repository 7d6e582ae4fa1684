"""Plain functional restatement of the reference CSMRI pipeline's U-Net
prior and fixed-parameter PnP-ADMM loop, on state dicts in the reference
checkpoint's key layout.

The parity oracle (:mod:`.torch_oracle`) denoises through these functions.
They are written against the reference's documented behaviour
(evaluation/noise.py, evaluation/env.py, cited per function) and share no
code with the port's models (``models/unet.py``), so that the yardstick
the port is held to cannot move with the port. Counterpart of the JAX
package's ``utils/torch_reference.py``: the same functions on the same
seeds give the same tensors. The ARNIQA random state dict is
``models/arniqa.py:random_arniqa_state_dict``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

UNET_CHANNELS = [32, 64, 128, 256, 512]


def random_unet_state_dict(seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random U-Net weights in the reference checkpoint's key layout
    (noise.py:101-113 module structure).

    He-scaled (std = sqrt(2/fan_in)) so activations stay O(1) through the
    27-conv network: with exploding weights the 30-iteration ADMM feedback
    loop is numerically chaotic and cross-framework parity is meaningless.
    The residual head is further damped so the random denoiser is
    near-contractive, like a trained one.
    """
    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(name, c_out, c_in, k, gain=1.0):
        std = gain * (2.0 / (c_in * k * k)) ** 0.5
        sd[name + ".weight"] = std * torch.randn(c_out, c_in, k, k,
                                                 generator=gen)
        sd[name + ".bias"] = 0.01 * torch.randn(c_out, generator=gen)

    def add_block(prefix, c_in, c_out):
        chans = [c_in, c_out, c_out, c_out]
        for i in range(3):
            conv(f"{prefix}.conv-{i}.conv2d", chans[i + 1], chans[i], 3)

    add_block("inc.conv", 2, 32)
    for k in range(1, 5):
        add_block(f"down{k}.mpconv.1", UNET_CHANNELS[k - 1],
                  UNET_CHANNELS[k])
    for k in range(1, 5):
        c_skip = UNET_CHANNELS[4 - k]
        c_up = UNET_CHANNELS[5 - k]
        add_block(f"up{k}.conv", c_skip + c_up, c_skip)
    conv("outc.conv", 1, 32, 1, gain=0.1)
    return sd


def torch_unet_forward(sd, x):
    """Residual U-Net forward (noise.py:119-133) via torch.nn.functional."""
    def block(prefix, t):
        for i in range(3):
            t = F.conv2d(t, sd[f"{prefix}.conv-{i}.conv2d.weight"],
                         sd[f"{prefix}.conv-{i}.conv2d.bias"], padding=1)
            t = F.leaky_relu(t, 0.2)
        return t

    def up(prefix, t, skip):
        t = F.interpolate(t, scale_factor=2, mode="bilinear",
                          align_corners=True)
        return block(prefix, torch.cat([skip, t], dim=1))

    x1 = block("inc.conv", x)
    x2 = block("down1.mpconv.1", F.max_pool2d(x1, 2))
    x3 = block("down2.mpconv.1", F.max_pool2d(x2, 2))
    x4 = block("down3.mpconv.1", F.max_pool2d(x3, 2))
    x5 = block("down4.mpconv.1", F.max_pool2d(x4, 2))
    y = up("up1.conv", x5, x4)
    y = up("up2.conv", y, x3)
    y = up("up3.conv", y, x2)
    y = up("up4.conv", y, x1)
    residual = F.conv2d(y, sd["outc.conv.weight"], sd["outc.conv.bias"])
    return x[:, :1] + residual


def torch_denoise(sd, img, sigma: float):
    """UNetDenoiser2D wrapper (noise.py:155-164): sigma noise-map channel,
    clamp to [0,1]."""
    n, _, h, w = img.shape
    noise_map = torch.full((n, 1, h, w), float(sigma))
    return torch.clamp(torch_unet_forward(
        sd, torch.cat([img, noise_map], dim=1)), 0, 1)


def torch_admm_rollout(sd, mat: Mapping[str, np.ndarray], mu: float,
                       sigma_d: float, n_iters: int = 30
                       ) -> Tuple[np.ndarray, float]:
    """Fixed-parameter PnP-ADMM loop (env.py:85-98) on the CPU.

    Returns (final real image (B, 1, H, W), PSNR dB vs gt).
    """
    def fft2c(t):
        t = torch.fft.ifftshift(t, dim=(-2, -1))
        t = torch.fft.fftn(t, dim=(-2, -1), norm="ortho")
        return torch.fft.fftshift(t, dim=(-2, -1))

    def ifft2c(t):
        t = torch.fft.ifftshift(t, dim=(-2, -1))
        t = torch.fft.ifftn(t, dim=(-2, -1), norm="ortho")
        return torch.fft.fftshift(t, dim=(-2, -1))

    s = np.asarray(mat["mask"]).shape[-1]     # square slices, 128 in use
    x0 = torch.from_numpy(np.asarray(mat["x0"], np.float32))
    x = torch.view_as_complex(x0).reshape(-1, 1, s, s)
    y0 = torch.view_as_complex(
        torch.from_numpy(np.asarray(mat["y0"], np.float32))).reshape(
        -1, 1, s, s)
    mask = torch.from_numpy(np.asarray(mat["mask"])).reshape(
        -1, 1, s, s).bool()
    gt = torch.from_numpy(np.asarray(mat["gt"], np.float32)).reshape(
        -1, 1, s, s)

    z = x.clone()
    u = torch.zeros_like(x)
    with torch.no_grad():
        for _ in range(n_iters):
            x = torch_denoise(sd, (z - u).real, sigma_d).to(torch.complex64)
            z = fft2c(x + u)
            temp = (mu * z + y0) / (1 + mu)
            z = torch.where(mask, temp, z)
            z = ifft2c(z)
            u = u + x - z

    out = torch.clamp(x.real, 0, 1)
    mse = torch.mean((out - gt) ** 2)
    psnr = float(10 * torch.log10(1.0 / mse))
    return out.numpy(), psnr
