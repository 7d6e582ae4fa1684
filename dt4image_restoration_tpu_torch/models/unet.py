"""Residual U-Net plug-in denoiser (the PnP prior), NCHW.

Counterpart of the JAX package's ``models/unet.py``, with the same
semantics: encoder of 3-layer 3x3 LeakyReLU(0.2) blocks with 2x2 max-pool
(base/2x/4x/8x/16x channels), decoder of 2x bilinear upsampling
(align_corners=True), pad-to-match and a ``[skip, up]`` concat, a 1x1 head
and a residual add of the image channel. ``UNetDenoiser`` adds the constant
sigma noise-map channel and clamps the output to [0, 1].

The two full-resolution blocks (``inc`` and ``up4``) run as one fused
kernel each (K1, :mod:`..ops.kernels.conv_block`; its plain version on the
CPU). The other seven blocks run ``torch.nn.functional.conv2d``. A block
whose spatial size is odd or below 2 runs the plain conv chain on any
device, the same shape rule as the JAX package's fused modes.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.image import bilinear_upsample_2x
from ..ops.kernels.conv_block import (PackedConvBlock, conv_block,
                                      pack_conv_block)

NEGATIVE_SLOPE = 0.2


class ConvBlock(nn.Module):
    """``num_layer`` x [3x3 conv (pad 1) + LeakyReLU(0.2)]; ``fused`` runs
    the whole block as kernel K1."""

    def __init__(self, in_channels: int, features: int, num_layer: int = 3,
                 fused: bool = False):
        super().__init__()
        self.num_layer = num_layer
        self.fused = fused
        for i in range(num_layer):
            self.add_module(f"conv{i}", nn.Conv2d(
                in_channels if i == 0 else features, features, 3, padding=1))
        self._packed: Optional[PackedConvBlock] = None
        self._packed_key = None

    def convs(self):
        return [getattr(self, f"conv{i}") for i in range(self.num_layer)]

    def packed(self) -> PackedConvBlock:
        """The weights in K1's layout, repacked only when a parameter
        changed (in place or by reassignment)."""
        params = [t for c in self.convs() for t in (c.weight, c.bias)]
        key = tuple((t.data_ptr(), t._version) for t in params)
        if key != self._packed_key:
            with torch.no_grad():
                self._packed = pack_conv_block(
                    [c.weight for c in self.convs()],
                    [c.bias for c in self.convs()], layout="oihw")
            self._packed_key = key
        return self._packed

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        if self.fused and not (h % 2 or w % 2 or h < 2 or w < 2):
            return conv_block(x, self.packed(), NEGATIVE_SLOPE)
        for conv in self.convs():
            x = F.leaky_relu(conv(x), NEGATIVE_SLOPE)
        return x


def _pad_to_match(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Pad x1 spatially to x2's size, splitting the difference like the
    reference decoder (a no-op for power-of-two inputs)."""
    dy = x2.shape[-2] - x1.shape[-2]
    dx = x2.shape[-1] - x1.shape[-1]
    if dy == 0 and dx == 0:
        return x1
    return F.pad(x1, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))


class UNet(nn.Module):
    """2-in (image + noise map) / 1-out residual U-Net on NCHW tensors."""

    def __init__(self, in_channels: int = 2, out_channels: int = 1,
                 base_channels: int = 32):
        super().__init__()
        c = base_channels
        self.out_channels = out_channels
        self.inc = ConvBlock(in_channels, c, fused=True)
        self.down1 = ConvBlock(c, 2 * c)
        self.down2 = ConvBlock(2 * c, 4 * c)
        self.down3 = ConvBlock(4 * c, 8 * c)
        self.down4 = ConvBlock(8 * c, 16 * c)
        self.up1 = ConvBlock(16 * c + 8 * c, 8 * c)
        self.up2 = ConvBlock(8 * c + 4 * c, 4 * c)
        self.up3 = ConvBlock(4 * c + 2 * c, 2 * c)
        self.up4 = ConvBlock(2 * c + c, c, fused=True)
        self.outc = nn.Conv2d(c, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        noisy = x
        x1 = self.inc(x)
        x2 = self.down1(F.max_pool2d(x1, 2))
        x3 = self.down2(F.max_pool2d(x2, 2))
        x4 = self.down3(F.max_pool2d(x3, 2))
        x5 = self.down4(F.max_pool2d(x4, 2))

        def up(a, skip, block):
            a = _pad_to_match(bilinear_upsample_2x(a), skip)
            return block(torch.cat([skip, a], dim=1))

        y = up(x5, x4, self.up1)
        y = up(y, x3, self.up2)
        y = up(y, x2, self.up3)
        y = up(y, x1, self.up4)
        return noisy[:, :self.out_channels] + self.outc(y)


class UNetDenoiser(nn.Module):
    """Frozen plug-in prior: ``(x (B, 1, H, W), sigma scalar or (B,))`` ->
    clamped (B, 1, H, W)."""

    def __init__(self, base_channels: int = 32):
        super().__init__()
        self.net = UNet(base_channels=base_channels)

    def forward(self, x: torch.Tensor, sigma) -> torch.Tensor:
        b, _, h, w = x.shape
        sigma = torch.as_tensor(sigma, dtype=x.dtype, device=x.device)
        sigma_map = sigma.reshape(-1, 1, 1, 1).expand(b, 1, h, w)
        return torch.clamp(self.net(torch.cat([x, sigma_map], dim=1)),
                           0.0, 1.0)


def random_unet_state_dict(seed: int = 0, base_channels: int = 32
                           ) -> Dict[str, torch.Tensor]:
    """Random ``UNetDenoiser`` weights from ``seed``.

    He-scaled (std = sqrt(2 / fan_in)) so activations stay O(1) through the
    27 convs, with the residual head damped tenfold so that the random
    denoiser is near-contractive like a trained one: with larger weights the
    30-iteration ADMM feedback loop is chaotic and no two devices agree.
    """
    gen = torch.Generator().manual_seed(seed)
    model = UNetDenoiser(base_channels)
    sd = {}
    for name, t in model.state_dict().items():
        if name.endswith(".weight"):
            c_out, c_in, kh, kw = t.shape
            gain = 0.1 if name == "net.outc.weight" else 1.0
            std = gain * (2.0 / (c_in * kh * kw)) ** 0.5
            sd[name] = std * torch.randn(t.shape, generator=gen)
        else:
            sd[name] = 0.01 * torch.randn(t.shape, generator=gen)
    return sd
