"""ARNIQA no-reference image-quality scorer, the tree search's value model.

Counterpart of the JAX package's ``models/arniqa.py``. ARNIQA is a
ResNet-50 encoder whose pooled features at full and half scale are
concatenated, L2-normalised and fed to a linear regressor; ``scale_score``
maps the KADID-10k MOS range onto [0, 1]. This module provides:

  * ``ResNet50`` and ``ARNIQA`` as modules with torchvision's parameter
    names under ``encoder.model.``, so a hub state dict loads strictly
    (``utils/loaders.py:load_arniqa``; the classification head ``fc.*`` is
    dropped on load);
  * ``score_images`` and ``make_value_fn``: the scoring wrapper (greyscale
    zero-padded to "RGB", the half scale by antialiased bilinear resizing,
    as torchvision's ``Resize`` does on tensors; no ImageNet normalisation);
  * ``proxy_value_fn``: the deterministic no-reference proxy the search
    uses when no ARNIQA weights are given;
  * ``make_value_fn_batched`` and ``proxy_value_fn_batched``: the two
    scorers over a (B, H, W) batch on its device, (B,) scores out, for the
    device-resident search (``inference/mcts_device.py``), which scores a
    batch of leaves in one call without a trip to the host;
  * ``random_arniqa_state_dict``: hub-layout random weights from a seed.

The scorers take a compute ``dtype`` (the CLI's ``--dtype``, the
reference's autocast around ARNIQA): under bfloat16 the ResNet-50's convs
run in bfloat16 and its BatchNorms compute in float32 and round to
bfloat16, as the JAX model's do; the pooling, the normalisation and the
regressor stay float32.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .precision import compute_dtype, conv2d

KADID_RANGE = (1.0, 5.0)  # MOS range used by scale_score
RESNET50_STAGES = (3, 4, 6, 3)


class Bottleneck(nn.Module):
    """torchvision's ResNet-50 bottleneck (1x1, 3x3 with the stride, 1x1
    to 4x the width), eval-mode BatchNorm."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, features, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride=stride,
                               padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(features)
        self.conv3 = nn.Conv2d(features, 4 * features, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(4 * features)
        self.downsample = nn.Sequential(
            nn.Conv2d(in_channels, 4 * features, 1, stride=stride,
                      bias=False),
            nn.BatchNorm2d(4 * features)) if downsample else None

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        y = F.relu(_bn(self.bn1, conv2d(self.conv1, x, dtype)))
        y = F.relu(_bn(self.bn2, conv2d(self.conv2, y, dtype)))
        y = _bn(self.bn3, conv2d(self.conv3, y, dtype))
        res = x if self.downsample is None else _bn(
            self.downsample[1], conv2d(self.downsample[0], x, dtype))
        return F.relu(y + res)


def _bn(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode BatchNorm computed in float32 and returned in the dtype of
    ``x`` (Flax's ``BatchNorm(dtype=...)``)."""
    return bn(x.float()).to(x.dtype)


class ResNet50(nn.Module):
    """torchvision-layout ResNet-50 feature extractor: NCHW images ->
    (B, 2048) globally pooled features."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        c_in = 64
        for stage, n_blocks in enumerate(RESNET50_STAGES):
            feats = 64 * 2 ** stage
            blocks = []
            for block in range(n_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                blocks.append(Bottleneck(c_in, feats, stride, block == 0))
                c_in = 4 * feats
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Features in float32, computed in ``dtype``."""
        x = F.relu(_bn(self.bn1, conv2d(self.conv1, x, dtype)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage in range(len(RESNET50_STAGES)):
            for block in getattr(self, f"layer{stage + 1}"):
                x = block(x, dtype)
        return x.float().mean(dim=(2, 3))


class ARNIQA(nn.Module):
    """Encoder on full and half scale, concatenated and normalised, then a
    linear regressor."""

    def __init__(self):
        super().__init__()
        self.encoder = nn.ModuleDict({"model": ResNet50()})
        self.regressor = nn.Linear(2 * 2048, 1)

    def forward(self, img: torch.Tensor, img_ds: torch.Tensor,
                scale_score: bool = True,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        enc = self.encoder["model"]
        f = torch.cat([enc(img, dtype), enc(img_ds, dtype)], dim=-1)
        f = f / f.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        score = self.regressor(f)[:, 0]
        if scale_score:
            lo, hi = KADID_RANGE
            score = (score - lo) / (hi - lo)
        return score


@torch.no_grad()
def score_images(model: ARNIQA, x: torch.Tensor, image_size: int = 128,
                 dtype="float32") -> torch.Tensor:
    """Scaled ARNIQA scores of (B, H, W) greyscale images in [0, 1] -> (B,)
    float32, the encoder computing in ``dtype``. The image goes in as
    (x, 0, 0) "RGB"; the half scale is an antialiased bilinear resize to
    ``image_size // 2``."""
    zeros = torch.zeros_like(x)
    rgb = torch.stack([x, zeros, zeros], dim=1)
    half = F.interpolate(rgb, size=(image_size // 2, image_size // 2),
                         mode="bilinear", align_corners=False,
                         antialias=True)
    return model(rgb, half, scale_score=True, dtype=compute_dtype(dtype))


def make_value_fn(model: ARNIQA, image_size: int = 128, dtype="float32"
                  ) -> Callable[[np.ndarray], float]:
    """The search's value function: one (1, H, W) image (array or tensor)
    -> its ARNIQA score, computed on the device of ``model`` in
    ``dtype``."""
    model.eval()
    dev = next(model.parameters()).device

    def value(x) -> float:
        img = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        return float(score_images(model, img.reshape(1, *img.shape[-2:]),
                                  image_size, dtype)[0])
    return value


def make_value_fn_batched(model: ARNIQA, image_size: int = 128,
                          dtype="float32"
                          ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Batched twin of :func:`make_value_fn`: (B, H, W) images in [0, 1] on
    the device of ``model`` -> (B,) ARNIQA scores in float32, left on that
    device."""
    model.eval()

    def value(x: torch.Tensor) -> torch.Tensor:
        return score_images(model, x.float(), image_size, dtype)
    return value


def proxy_value_fn_batched(x: torch.Tensor) -> torch.Tensor:
    """Batched twin of :func:`proxy_value_fn`: (B, H, W) -> (B,) on the
    device of ``x``. The same formula in float32; the 95th percentile
    interpolates linearly, as ``np.percentile`` does."""
    img = x.float()
    gy, gx = torch.gradient(img, dim=(1, 2))
    grad_mag = torch.sqrt(gx ** 2 + gy ** 2)
    lap = (torch.diff(img, n=2, dim=1).abs().mean(dim=(1, 2))
           + torch.diff(img, n=2, dim=2).abs().mean(dim=(1, 2)))
    edge = torch.quantile(grad_mag.reshape(img.shape[0], -1), 0.95, dim=1,
                          interpolation="linear")
    return edge - 5.0 * lap


def proxy_value_fn(x: np.ndarray) -> float:
    """Deterministic no-reference quality proxy: rewards piecewise-smooth
    images with strong edges, penalises high-frequency noise. The search
    uses it in place of ARNIQA when no ARNIQA weights are given."""
    img = np.asarray(x, np.float32).reshape(x.shape[-2], x.shape[-1])
    gy, gx = np.gradient(img)
    grad_mag = np.sqrt(gx ** 2 + gy ** 2)
    lap = (np.abs(np.diff(img, 2, axis=0)).mean()
           + np.abs(np.diff(img, 2, axis=1)).mean())
    edge_strength = float(np.percentile(grad_mag, 95))
    noise = float(lap)
    return edge_strength - 5.0 * noise


def random_arniqa_state_dict(seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random weights in the ARNIQA hub layout (``encoder.model.*`` with
    torchvision's ResNet-50 names, ``regressor.*``) from ``seed``: conv
    weights N(0, 0.05), BatchNorm scale 1 + N(0, 0.1), shift and running
    mean N(0, 0.1), running variance 1 + U(0, 0.2)."""
    gen = torch.Generator().manual_seed(seed)
    sd: Dict[str, torch.Tensor] = {}
    pre = "encoder.model."

    def conv(name, c_out, c_in, k):
        sd[pre + name + ".weight"] = 0.05 * torch.randn(
            c_out, c_in, k, k, generator=gen)

    def bn(name, c):
        sd[pre + name + ".weight"] = 1 + 0.1 * torch.randn(c, generator=gen)
        sd[pre + name + ".bias"] = 0.1 * torch.randn(c, generator=gen)
        sd[pre + name + ".running_mean"] = 0.1 * torch.randn(c,
                                                             generator=gen)
        sd[pre + name + ".running_var"] = 1 + 0.2 * torch.rand(
            c, generator=gen)
        sd[pre + name + ".num_batches_tracked"] = torch.zeros(
            (), dtype=torch.long)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    c_in = 64
    for stage, n_blocks in enumerate(RESNET50_STAGES):
        feats = 64 * 2 ** stage
        for block in range(n_blocks):
            p = f"layer{stage + 1}.{block}."
            conv(p + "conv1", feats, c_in, 1)
            bn(p + "bn1", feats)
            conv(p + "conv2", feats, feats, 3)
            bn(p + "bn2", feats)
            conv(p + "conv3", 4 * feats, feats, 1)
            bn(p + "bn3", 4 * feats)
            if block == 0:
                conv(p + "downsample.0", 4 * feats, c_in, 1)
                bn(p + "downsample.1", 4 * feats)
            c_in = 4 * feats
    sd["regressor.weight"] = 0.01 * torch.randn(1, 4096, generator=gen)
    sd["regressor.bias"] = 0.01 * torch.randn(1, generator=gen)
    return sd
