"""Image resampling and layout utilities (counterpart of the JAX package's
``ops/image.py``), on NCHW tensors.

``bilinear_upsample_2x`` is the U-Net decoder's upsampling (in the plain
version of kernel K6, ``ops/kernels/upsample_concat.py``). The
space-to-depth family runs the U-Net's ``s2d`` mode: it packs 2x2 pixel
cells into channels, and turns a SAME 3x3 pixel conv into an exact cell
conv (``dense``: SAME 3x3 over plain cells; ``shift``: VALID 2x2 over the
cells of the (1, 1)-padded image, chained by :func:`repad_cells`). The
channel order within a cell is (sy, sx, c), major to minor, as in the JAX
package, so every function here equals its JAX twin after the NHWC/HWIO
transposes.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def bilinear_upsample_2x(img: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample with align_corners=True on NCHW images (the
    U-Net decoder's ``nn.Upsample``)."""
    return F.interpolate(img, scale_factor=2, mode="bilinear",
                         align_corners=True)


@functools.lru_cache(maxsize=None)
def _interp_matrix(in_size: int, out_size: int, align_corners: bool
                   ) -> np.ndarray:
    """(out_size, in_size) bilinear interpolation matrix, float32.

    align_corners=True:  src = i * (in-1)/(out-1)
    align_corners=False: src = (i + 0.5) * in/out - 0.5, clamped to >= 0
    (``F.interpolate``'s source coordinates; one output takes pixel 0.)
    """
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if out_size == 1:
        m[0, 0] = 1.0
        return m
    for i in range(out_size):
        if align_corners:
            src = i * (in_size - 1) / (out_size - 1)
        else:
            src = max((i + 0.5) * in_size / out_size - 0.5, 0.0)
        lo = min(int(np.floor(src)), in_size - 1)
        hi = min(lo + 1, in_size - 1)
        frac = src - lo
        m[i, lo] += 1.0 - frac
        m[i, hi] += frac
    return m


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize (no antialiasing) of (..., H, W) images as two
    products with interpolation matrices, in float32; the result has the
    dtype of ``img``."""
    h, w = img.shape[-2:]
    a = torch.from_numpy(_interp_matrix(h, out_h, align_corners)).to(
        img.device)
    b = torch.from_numpy(_interp_matrix(w, out_w, align_corners)).to(
        img.device)
    out = torch.einsum("ih,...hw->...iw", a, img.float())
    return torch.einsum("jw,...iw->...ij", b, out).to(img.dtype)


def complex2channel(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W, 2) real/imag pairs -> (N, 2C, H, W) channels."""
    n, c, h, w, _ = x.shape
    return x.permute(0, 1, 4, 2, 3).reshape(n, 2 * c, h, w)


def greyscale_to_rgb(x: torch.Tensor) -> torch.Tensor:
    """(1, H, W) greyscale -> (3, H, W), the two added channels zero (the
    reference pads zeros rather than repeating the channel)."""
    zeros = torch.zeros((2,) + tuple(x.shape[1:]), dtype=x.dtype,
                        device=x.device)
    return torch.cat([x, zeros], dim=0)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4C, H/2, W/2) plain 2x2 cell packing."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, 4 * c, h // 2, w // 2)


def space_to_depth_shifted(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4C, H/2+1, W/2+1): cells of the (1, 1)-padded
    image, so a SAME 3x3 pixel conv becomes a VALID 2x2 cell conv."""
    return space_to_depth(F.pad(x, (1, 1, 1, 1)))


def depth_to_space(y: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    b, c4, hc, wc = y.shape
    c = c4 // 4
    y = y.reshape(b, 2, 2, c, hc, wc).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(b, c, 2 * hc, 2 * wc)


def repad_cells(y: torch.Tensor) -> torch.Tensor:
    """Plain cells -> pad-shifted cells without leaving the cell domain: a
    channel shuffle of four shifted cell views (the chaining step between
    VALID 2x2 cell convs)."""
    c = y.shape[1] // 4
    tl = F.pad(y[:, 3 * c:4 * c], (1, 0, 1, 0))   # A(i-1, j-1), sub (1, 1)
    tr = F.pad(y[:, 2 * c:3 * c], (0, 1, 1, 0))   # A(i-1, j),   sub (1, 0)
    bl = F.pad(y[:, 1 * c:2 * c], (1, 0, 0, 1))   # A(i, j-1),   sub (0, 1)
    br = F.pad(y[:, 0 * c:1 * c], (0, 1, 0, 1))   # A(i, j),     sub (0, 0)
    return torch.cat([tl, tr, bl, br], dim=1)


def pack_conv_weights(w: torch.Tensor, mode: str) -> torch.Tensor:
    """(Cout, Cin, 3, 3) SAME-conv weights -> the cell-domain equivalent:
    ``mode='dense'``: (4Cout, 4Cin, 3, 3) SAME weights on plain cells;
    ``mode='shift'``: (4Cout, 4Cin, 2, 2) VALID weights on pad-shifted
    cells. Output channel blocks are (oy, ox) major, so
    :func:`depth_to_space` unpacks them."""
    cout, cin = w.shape[:2]
    if mode == "dense":
        k, delta, base = 3, -1, 1   # pixel offset u = oy + ky - 1
    elif mode == "shift":
        k, delta, base = 2, 0, 0    # pad-shifted: u = oy + ky
    else:
        raise ValueError(f"unknown packing mode {mode!r}")
    w2 = w.new_zeros((4 * cout, 4 * cin, k, k))
    for oy in range(2):
        for ox in range(2):
            o = (oy * 2 + ox) * cout
            for ky in range(3):
                for kx in range(3):
                    cy, sy = divmod(oy + ky + delta, 2)
                    cx, sx = divmod(ox + kx + delta, 2)
                    i = (sy * 2 + sx) * cin
                    w2[o:o + cout, i:i + cin, cy + base, cx + base] = \
                        w[:, :, ky, kx]
    return w2


def pack_conv_bias(b: torch.Tensor) -> torch.Tensor:
    """Bias for a packed conv: one copy per (oy, ox) output block."""
    return torch.cat([b, b, b, b])
