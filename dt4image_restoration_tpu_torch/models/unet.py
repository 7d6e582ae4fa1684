"""Residual U-Net plug-in denoiser (the PnP prior), NCHW.

Counterpart of the JAX package's ``models/unet.py``, with the same
semantics: encoder of 3-layer 3x3 LeakyReLU(0.2) blocks with 2x2 max-pool
(base/2x/4x/8x/16x channels), decoder of 2x bilinear upsampling
(align_corners=True), pad-to-match and a ``[skip, up]`` concat (one launch
of kernel K6, :mod:`..ops.kernels.upsample_concat`, in every mode; its
plain version on the CPU), a 1x1 head and a residual add of the image
channel. ``UNetDenoiser`` adds the constant sigma noise-map channel and
clamps the output to [0, 1].

``dtype`` is the compute dtype (float32 parameters): under bfloat16 the
convs, pooling, upsampling, concats and the 1x1 head run in bfloat16, the
residual add of the float32 input image in float32, then the clamp, as in
the JAX model. ``packed`` is the execution mode of the JAX CLI's
``--unet_packed``; :meth:`UNet._block_packed` maps it onto the blocks as
the JAX model does:

  * ``none``: ``F.conv2d`` everywhere;
  * ``s2d``: space-to-depth cells (``ops/image.py``), ``dense`` on inc and
    ``shift`` on up4 (float32 only; under bfloat16 up4 stays direct);
  * ``pallas`` (the port's default): inc and up4 each as one launch of
    kernel K1 (:mod:`..ops.kernels.conv_block`; the bfloat16 K1 under
    bfloat16; its plain version on the CPU);
  * ``winograd``: every block by Winograd F(2x2, 3x3) (``ops/winograd.py``);
  * ``winograd_deep``: Winograd on down2, down3, down4, up1 and up2.

A block whose spatial size is odd or below 2 runs the direct convs in
every mode, the JAX package's shape rule. Every mode runs the same
``state_dict``.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.image import (depth_to_space, pack_conv_bias, pack_conv_weights,
                         repad_cells, space_to_depth, space_to_depth_shifted)
from ..ops.kernels.conv_block import (PackedConvBlock, conv_block,
                                      pack_conv_block)
from ..ops.kernels.upsample_concat import upsample_concat
from ..ops.winograd import winograd_apply, winograd_weights
from ..utils.profiling import UNET, annotate
from .precision import compute_dtype, conv2d
from .prior_graphs import run_prior

NEGATIVE_SLOPE = 0.2
# The U-Net's execution modes (--unet_packed) and a block's.
UNET_MODES = ("none", "s2d", "pallas", "winograd", "winograd_deep")
BLOCK_MODES = (None, "dense", "shift", "pallas", "winograd")


class ConvBlock(nn.Module):
    """``num_layer`` x [3x3 conv (pad 1) + LeakyReLU(0.2)] in ``dtype``,
    executed as ``packed`` says: None (direct convs), ``'dense'`` or
    ``'shift'`` (space-to-depth cells), ``'pallas'`` (kernel K1) or
    ``'winograd'``."""

    def __init__(self, in_channels: int, features: int, num_layer: int = 3,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 packed: Optional[str] = None):
        super().__init__()
        if packed not in BLOCK_MODES:
            raise ValueError(f"block mode must be one of {BLOCK_MODES}, got "
                             f"{packed!r}")
        self.num_layer = num_layer
        self.dtype = compute_dtype(dtype)
        self.packed = packed
        for i in range(num_layer):
            self.add_module(f"conv{i}", nn.Conv2d(
                in_channels if i == 0 else features, features, 3, padding=1))
        self._prepared = None
        self._prepared_key = None

    def convs(self):
        return [getattr(self, f"conv{i}") for i in range(self.num_layer)]

    def _weights(self, mode: str):
        """The weights as ``mode`` runs them, in the compute dtype, remade
        only when a parameter changed (in place or by reassignment)."""
        params = [t for c in self.convs() for t in (c.weight, c.bias)]
        key = (mode, tuple((t.data_ptr(), t._version) for t in params))
        if key != self._prepared_key:
            dt, convs = self.dtype, self.convs()
            with torch.no_grad():
                if mode == "pallas":
                    prepared = pack_conv_block(
                        [c.weight for c in convs], [c.bias for c in convs],
                        layout="oihw", dtype=dt)
                elif mode == "winograd":
                    prepared = [(winograd_weights(c.weight.to(dt)),
                                 c.bias.to(dt)) for c in convs]
                else:
                    prepared = [(pack_conv_weights(c.weight.to(dt), mode),
                                 pack_conv_bias(c.bias.to(dt)))
                                for c in convs]
            self._prepared, self._prepared_key = prepared, key
        return self._prepared

    def packed_weights(self) -> PackedConvBlock:
        """The weights in K1's layout for the compute dtype."""
        return self._weights("pallas")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        mode, dt = self.packed, self.dtype
        if mode and (h % 2 or w % 2 or h < 2 or w < 2):
            mode = None
        if mode == "pallas":
            return conv_block(x.to(dt).contiguous(), self.packed_weights(),
                              NEGATIVE_SLOPE)
        if mode == "winograd":
            y = x.to(dt)
            for u, b in self._weights(mode):
                y = F.leaky_relu(winograd_apply(y, u, b), NEGATIVE_SLOPE)
            return y
        if mode in ("dense", "shift"):
            y = x.to(dt)
            y = space_to_depth(y) if mode == "dense" \
                else space_to_depth_shifted(y)
            for i, (wp, bp) in enumerate(self._weights(mode)):
                if mode == "shift" and i > 0:
                    y = repad_cells(y)
                y = F.leaky_relu(F.conv2d(y, wp, bp,
                                          padding=1 if mode == "dense" else 0),
                                 NEGATIVE_SLOPE)
            return depth_to_space(y)
        for conv in self.convs():
            x = F.leaky_relu(conv2d(conv, x, dt), NEGATIVE_SLOPE)
        return x


class UNet(nn.Module):
    """2-in (image + noise map) / 1-out residual U-Net on NCHW tensors, in
    compute ``dtype``, executed in mode ``packed`` (``UNET_MODES``)."""

    # The >= 4 x base-channel blocks, where the JAX package's
    # winograd_deep mode runs Winograd.
    _DEEP_WINO_BLOCKS = ("down2", "down3", "down4", "up1", "up2")

    def __init__(self, in_channels: int = 2, out_channels: int = 1,
                 base_channels: int = 32,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 packed: str = "pallas"):
        super().__init__()
        if packed not in UNET_MODES:
            raise ValueError(f"U-Net mode must be one of {UNET_MODES}, got "
                             f"{packed!r}")
        c = base_channels
        self.out_channels = out_channels
        self.dtype = compute_dtype(dtype)
        self.packed = packed

        def block(name, cin, feats):
            return ConvBlock(cin, feats, dtype=self.dtype,
                             packed=self._block_packed(name))

        self.inc = block("inc", in_channels, c)
        self.down1 = block("down1", c, 2 * c)
        self.down2 = block("down2", 2 * c, 4 * c)
        self.down3 = block("down3", 4 * c, 8 * c)
        self.down4 = block("down4", 8 * c, 16 * c)
        self.up1 = block("up1", 16 * c + 8 * c, 8 * c)
        self.up2 = block("up2", 8 * c + 4 * c, 4 * c)
        self.up3 = block("up3", 4 * c + 2 * c, 2 * c)
        self.up4 = block("up4", 2 * c + c, c)
        self.outc = nn.Conv2d(c, out_channels, 1)

    def _block_packed(self, name: str) -> Optional[str]:
        """Block ``name``'s mode under the U-Net's mode (the JAX
        ``UNet._block_packed``)."""
        p = self.packed
        if p == "winograd":
            return "winograd"
        if p == "winograd_deep":
            return "winograd" if name in self._DEEP_WINO_BLOCKS else None
        if name == "inc":
            return {"pallas": "pallas", "s2d": "dense"}.get(p)
        if name == "up4":
            if p == "pallas":
                return "pallas"
            return "shift" if p == "s2d" and self.dtype == torch.float32 \
                else None
        return None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        noisy = x
        x1 = self.inc(x)
        x2 = self.down1(F.max_pool2d(x1, 2))
        x3 = self.down2(F.max_pool2d(x2, 2))
        x4 = self.down3(F.max_pool2d(x3, 2))
        x5 = self.down4(F.max_pool2d(x4, 2))

        def up(a, skip, block):
            return block(upsample_concat(a.contiguous(), skip.contiguous()))

        y = up(x5, x4, self.up1)
        y = up(y, x3, self.up2)
        y = up(y, x2, self.up3)
        y = up(y, x1, self.up4)
        return noisy[:, :self.out_channels] \
            + conv2d(self.outc, y, self.dtype)


class UNetDenoiser(nn.Module):
    """Frozen plug-in prior: ``(x (B, 1, H, W), sigma scalar or (B,))`` ->
    clamped (B, 1, H, W), in the dtype of ``x`` whatever the compute
    ``dtype``; ``packed`` is the U-Net's execution mode. Inside an
    evaluator's rollout on CUDA the forward replays a CUDA graph
    (:mod:`.prior_graphs`)."""

    def __init__(self, base_channels: int = 32,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 packed: str = "pallas"):
        super().__init__()
        self.net = UNet(base_channels=base_channels, dtype=dtype,
                        packed=packed)

    def forward(self, x: torch.Tensor, sigma) -> torch.Tensor:
        with annotate(UNET):
            return run_prior(self, self._denoise, x, sigma)

    def _denoise(self, x: torch.Tensor, sigma) -> torch.Tensor:
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
