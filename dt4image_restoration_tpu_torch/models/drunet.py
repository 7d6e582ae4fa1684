"""DRUNet, DPIR's deep residual U-Net prior, channels-last.

Zhang et al., "Plug-and-Play Image Restoration with Deep Denoiser Prior",
TPAMI 2021 (arXiv:2008.13751); ``cszn/DPIR`` ``models/network_unet.py:
UNetRes`` with the ``drunet_gray`` settings (``in_nc=2``: the image and a
sigma noise-map channel; ``nc=[64, 128, 256, 512]``, ``nb=4``, ReLU,
strided-conv down, transposed-conv up, no biases):

    x1 = m_head(x0)                3x3 conv, in -> nc[0]
    x2 = m_down1(x1)               nb ResBlocks(nc[0]), 2x2 stride-2 conv
    x3 = m_down2(x2)               nb ResBlocks(nc[1]), 2x2 stride-2 conv
    x4 = m_down3(x3)               nb ResBlocks(nc[2]), 2x2 stride-2 conv
    y  = m_body(x4)                nb ResBlocks(nc[3])
    y  = m_up3(y + x4)             2x2 stride-2 transposed conv, nb ResBlocks
    y  = m_up2(y + x3)
    y  = m_up1(y + x2)
    out = m_tail(y + x1)           3x3 conv, nc[0] -> out
    ResBlock(h) = h + conv3x3(relu(conv3x3(h)))

There is no global residual and no normalisation. The modules keep DPIR's
names, so a ``UNetRes`` state dict loads under a ``net.`` prefix
(``utils/convert.py:drunet_from_reference``).

Every activation is channels-last (NHWC in memory) from the head's input to
the tail's output, and so are the parameters and their cached casts, so
cuDNN runs each convolution on NHWC tensors without layout transforms. The
down- and up-sampling are cuDNN's 2x2 stride-2 convolution and transposed
convolution (on the H100 they beat their GEMM form over
``ops/image.py``'s space-to-depth by 1.7-3.5x; PERF.md, section 6).

``dtype`` is the compute dtype (float32 parameters, one cached copy each
in the compute dtype, :mod:`.precision`): the convolutions, ReLUs and the
residual and skip adds run in it; ``DRUNetDenoiser`` concatenates the
sigma map, casts back and clamps in float32.
"""
from __future__ import annotations

from typing import Dict, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.profiling import DRUNET, annotate
from .precision import compute_dtype, conv2d, conv_transpose2d
from .prior_graphs import run_prior

NC = (64, 128, 256, 512)   # channels per scale (drunet_gray)
NB = 4                     # ResBlocks per scale
# DPIR's sides: three 2x downsamplings need a multiple of 8.
SIDE_MULTIPLE = 8
# Random weights (:func:`random_drunet_state_dict`): the damping of each
# residual branch's second conv, of the deep path's last transposed conv,
# and of the noise around the head's and tail's linear image path.
RES_GAIN = 0.3
DEEP_GAIN = 0.3
EDGE_NOISE = 0.1
# The 3x3 smoothing that tail(head(.)) approximates on the image channel.
SMOOTH = ((1.0, 2.0, 1.0), (2.0, 20.0, 2.0), (1.0, 2.0, 1.0))


def _conv3(c_in: int, c_out: int) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, 3, padding=1, bias=False)


class ResBlock(nn.Module):
    """``h + conv3x3(relu(conv3x3(h)))`` in ``dtype``; DPIR's ``res``
    Sequential (conv, ReLU, conv) holds the convs."""

    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.res = nn.Sequential(_conv3(channels, channels), nn.ReLU(),
                                 _conv3(channels, channels))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        r = F.relu(conv2d(self.res[0], h, self.dtype), inplace=True)
        return h + conv2d(self.res[2], r, self.dtype)


class DRUNet(nn.Module):
    """DPIR's ``UNetRes`` on channels-last tensors in compute ``dtype``;
    returns the tail's output in ``dtype``."""

    def __init__(self, in_channels: int = 2, out_channels: int = 1,
                 nc: Sequence[int] = NC, nb: int = NB,
                 dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        if len(nc) != 4:
            raise ValueError(f"DRUNet has four scales, got nc={nc}")
        self.dtype = dt = compute_dtype(dtype)

        def blocks(c):
            return [ResBlock(c, dt) for _ in range(nb)]

        self.m_head = _conv3(in_channels, nc[0])
        for k in range(1, 4):
            setattr(self, f"m_down{k}", nn.Sequential(
                *blocks(nc[k - 1]),
                nn.Conv2d(nc[k - 1], nc[k], 2, stride=2, bias=False)))
        self.m_body = nn.Sequential(*blocks(nc[3]))
        for k in range(3, 0, -1):
            setattr(self, f"m_up{k}", nn.Sequential(
                nn.ConvTranspose2d(nc[k], nc[k - 1], 2, stride=2, bias=False),
                *blocks(nc[k - 1])))
        self.m_tail = _conv3(nc[0], out_channels)
        self.to(memory_format=torch.channels_last)

    def _down(self, seq: nn.Sequential, h: torch.Tensor) -> torch.Tensor:
        for block in seq[:-1]:
            h = block(h)
        return conv2d(seq[-1], h, self.dtype)

    def _up(self, seq: nn.Sequential, h: torch.Tensor) -> torch.Tensor:
        h = conv_transpose2d(seq[0], h, self.dtype)
        for block in seq[1:]:
            h = block(h)
        return h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        if h % SIDE_MULTIPLE or w % SIDE_MULTIPLE:
            raise ValueError(f"DRUNet takes sides divisible by "
                             f"{SIDE_MULTIPLE}, got {h}x{w}; pad the image "
                             "outside the network, as DPIR does")
        x0 = x.to(dtype=self.dtype, memory_format=torch.channels_last)
        x1 = conv2d(self.m_head, x0, self.dtype)
        x2 = self._down(self.m_down1, x1)
        x3 = self._down(self.m_down2, x2)
        x4 = self._down(self.m_down3, x3)
        y = self.m_body(x4)
        y = self._up(self.m_up3, y + x4)
        y = self._up(self.m_up2, y + x3)
        y = self._up(self.m_up1, y + x2)
        return conv2d(self.m_tail, y + x1, self.dtype)


class DRUNetDenoiser(nn.Module):
    """Frozen plug-in prior with ``UNetDenoiser``'s contract: ``(x (B, 1, H,
    W), sigma scalar or (B,))`` -> clamped (B, 1, H, W), in the dtype of
    ``x`` whatever the compute ``dtype``. The sigma map is the second input
    channel, as in DPIR. Inside an evaluator's rollout on CUDA the forward
    replays a CUDA graph (:mod:`.prior_graphs`)."""

    def __init__(self, nc: Sequence[int] = NC, nb: int = NB,
                 dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        self.net = DRUNet(in_channels=2, out_channels=1, nc=nc, nb=nb,
                          dtype=dtype)

    def forward(self, x: torch.Tensor, sigma) -> torch.Tensor:
        with annotate(DRUNET):
            return run_prior(self, self._denoise, x, sigma)

    def _denoise(self, x: torch.Tensor, sigma) -> torch.Tensor:
        b, _, h, w = x.shape
        sigma = torch.as_tensor(sigma, dtype=x.dtype, device=x.device)
        sigma_map = sigma.reshape(-1, 1, 1, 1).expand(b, 1, h, w)
        out = self.net(torch.cat([x, sigma_map], dim=1))
        return torch.clamp(out.to(x.dtype), 0.0, 1.0)


def _init_std(name: str, shape: torch.Size) -> float:
    """The std of a random weight: He before a ReLU, 1 / fan_in elsewhere,
    damped where :func:`random_drunet_state_dict` says."""
    if ".res." not in name and "m_up" in name:      # transposed, 2x2 s2:
        return (DEEP_GAIN if "m_up1." in name else 1.0) \
            * (1.0 / shape[0]) ** 0.5                  # one tap an output
    fan_in = shape[1] * shape[2] * shape[3]
    if name.endswith("res.0.weight"):
        return (2.0 / fan_in) ** 0.5
    return (RES_GAIN if name.endswith("res.2.weight") else 1.0) \
        * (1.0 / fan_in) ** 0.5


def random_drunet_state_dict(seed: int = 0, nc: Sequence[int] = NC,
                             nb: int = NB) -> Dict[str, torch.Tensor]:
    """Random ``DRUNetDenoiser`` weights from ``seed``, near-contractive
    like a trained prior.

    DRUNet has no global residual, so He-scaled weights alone would make a
    random map of the image. Here ``m_tail(m_head(.))`` is close to a mild
    smoothing of the image channel: each head channel takes the image's
    centre tap times a_c, the tail takes channel c through the smoothing
    kernel times a_c / |a|^2, and both carry noise of ``EDGE_NOISE`` of
    their scale. The convs in between keep the activations' scale (He
    before each ReLU, 1/fan_in elsewhere), each residual branch's second
    conv is damped by ``RES_GAIN``, and the deep path's last transposed
    conv by ``DEEP_GAIN``, so that the path through the three lower
    scales gives a modest, not a negligible, part of the output.
    """
    gen = torch.Generator().manual_seed(seed)
    shapes = DRUNetDenoiser(nc=nc, nb=nb).state_dict()

    def randn(*shape):
        return torch.randn(*shape, generator=gen)

    sd = {}
    for name, t in shapes.items():
        sd[name] = _init_std(name, t.shape) * randn(*t.shape)

    c0 = nc[0]
    a = randn(c0)
    smooth = torch.tensor(SMOOTH) / sum(map(sum, SMOOTH))
    head = EDGE_NOISE / 3.0 * randn(c0, 2, 3, 3)
    head[:, 0, 1, 1] += a
    b = a / a.dot(a)
    tail = EDGE_NOISE / 3.0 * b.norm() / c0 ** 0.5 * randn(1, c0, 3, 3)
    tail[0] += b[:, None, None] * smooth
    sd["net.m_head.weight"], sd["net.m_tail.weight"] = head, tail
    return sd
