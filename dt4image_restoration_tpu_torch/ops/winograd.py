"""Winograd F(2x2, 3x3) convolution (counterpart of the JAX package's
``ops/winograd.py``), on NCHW images and OIHW weights.

Each 2x2 output tile takes 16 multiplies instead of 36: the 4x4 input
tiles and the 3x3 filters are transformed into 16 positions, the channels
are contracted by 16 independent (pixels, Cin) x (Cin, Cout) products, and
the result is transformed back. Everything after the operands runs in
float32: the input and the weights are taken in the input's dtype, the
transforms and the channel contraction are computed and summed in float32,
and the output is rounded to the input's dtype once. (The JAX function
rounds each transform to a bfloat16 input's dtype as well, which roughly
doubles its distance from float32 at random weights.) It is algebraically a
direct convolution; the float sums differ by reassociation.
The U-Net's ``winograd`` and ``winograd_deep`` modes run it; it is plain
PyTorch, as the JAX function is plain XLA (no kernel).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# F(2x2, 3x3) transform matrices (Lavin & Gray 2015).
_BT = np.array([[1., 0., -1., 0.],
                [0., 1., 1., 0.],
                [0., -1., 1., 0.],
                [0., 1., 0., -1.]], np.float32)
_G = np.array([[1., 0., 0.],
               [0.5, 0.5, 0.5],
               [0.5, -0.5, 0.5],
               [0., 0., 1.]], np.float32)
_AT = np.array([[1., 1., 1., 0.],
                [0., 1., -1., -1.]], np.float32)


def _const(m: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(m).to(like.device)


def winograd_weights(kernel: torch.Tensor) -> torch.Tensor:
    """OIHW (Cout, Cin, 3, 3) -> transformed (4, 4, Cin, Cout) in float32,
    the JAX function's layout: U = G g G^T for every (Cin, Cout) tap
    plane."""
    g = _const(_G, kernel)
    return torch.einsum("ai,bj,ocij->abco", g, g, kernel.float())


def winograd_apply(x: torch.Tensor, u: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The convolution of :func:`winograd_conv3x3_same` on weights already
    transformed by :func:`winograd_weights` (a frozen denoiser transforms
    them once); ``bias`` is taken in the dtype of ``x``."""
    n, cin, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"winograd_conv3x3_same needs even H, W; got "
                         f"{(h, w)}")
    bt, at = _const(_BT, x), _const(_AT, x)
    xp = F.pad(x.float(), (1, 1, 1, 1))
    nh, nw = h // 2, w // 2
    # d[a, b][..., i, j] = xp[..., 2i + a, 2j + b]: the 16 strided views
    # that assemble every overlapping 4x4 tile: (4, 4, N, Cin, nh, nw).
    d = torch.stack([torch.stack([xp[:, :, a:a + 2 * nh:2, b:b + 2 * nw:2]
                                  for b in range(4)]) for a in range(4)])
    v = torch.einsum("ad,be,dencij->abncij", bt, bt, d)
    # The 16 channel contractions.
    m = torch.einsum("abncij,abco->abnoij", v, u.float())
    # Y = A^T M A: (N, Cout, nh, 2, nw, 2) -> (N, Cout, H, W).
    y = torch.einsum("pa,qb,abnoij->noipjq", at, at, m)
    y = y.reshape(n, -1, h, w)
    if bias is not None:
        y = y + bias.to(x.dtype).float().view(1, -1, 1, 1)
    return y.to(x.dtype)


def winograd_conv3x3_same(x: torch.Tensor, kernel: torch.Tensor,
                          bias: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """3x3 stride-1 SAME convolution of NCHW ``x`` with OIHW ``kernel`` by
    Winograd F(2x2, 3x3). Needs even H and W (the U-Net falls back to the
    direct conv otherwise). The output has the dtype of ``x``."""
    return winograd_apply(x, winograd_weights(kernel.to(x.dtype)), bias)
