"""Synthetic CSMRI fixtures: undersampling masks, phantoms, .mat-style
records (the port's own copy of the JAX package's ``data/synthetic.py``).

The reference ships no data generator (its eval .mat files are downloaded,
README.md:30-33, and training data is email-gated, README.md:11). These
fixtures provide the same record schema — x0/y0/mask/ATy0/gt — for tests and
benchmarks, built from the zero-filled reconstruction of an undersampled
phantom exactly as the CSMRI forward model implies.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def radial_mask(size: int = 128, n_spokes: int = 30, seed: int = 0
                ) -> np.ndarray:
    """Pseudo-radial k-space sampling mask (golden-angle spokes through the
    center), the standard CSMRI undersampling pattern for this task family.
    Returns (size, size) bool with DC (center) always sampled."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((size, size), bool)
    center = (size - 1) / 2.0
    radius = np.arange(-size // 2, size // 2 + 1)
    golden = np.pi * (3 - np.sqrt(5))
    theta0 = rng.uniform(0, np.pi)
    for k in range(n_spokes):
        theta = theta0 + k * golden
        rows = np.clip(np.round(center + radius * np.sin(theta)), 0,
                       size - 1).astype(int)
        cols = np.clip(np.round(center + radius * np.cos(theta)), 0,
                       size - 1).astype(int)
        mask[rows, cols] = True
    mask[size // 2, size // 2] = True
    return mask


def cartesian_mask(size: int = 128, acceleration: int = 4,
                   center_fraction: float = 0.08, seed: int = 0
                   ) -> np.ndarray:
    """1-D random Cartesian line mask (fastMRI-style) as an alternative
    undersampling pattern."""
    rng = np.random.default_rng(seed)
    n_center = max(int(size * center_fraction), 1)
    mask_cols = np.zeros(size, bool)
    pad = (size - n_center) // 2
    mask_cols[pad:pad + n_center] = True
    n_remaining = max(size // acceleration - n_center, 0)
    candidates = np.flatnonzero(~mask_cols)
    mask_cols[rng.choice(candidates, n_remaining, replace=False)] = True
    return np.broadcast_to(mask_cols, (size, size)).copy()


def shepp_logan(size: int = 128) -> np.ndarray:
    """A simple Shepp-Logan-like ellipse phantom in [0, 1], (size, size)."""
    y, x = np.mgrid[-1:1:complex(0, size), -1:1:complex(0, size)]
    img = np.zeros((size, size), np.float32)
    ellipses = [  # (value, a, b, x0, y0, phi)
        (1.0, 0.69, 0.92, 0.0, 0.0, 0.0),
        (-0.8, 0.6624, 0.874, 0.0, -0.0184, 0.0),
        (-0.2, 0.11, 0.31, 0.22, 0.0, -np.pi / 10),
        (-0.2, 0.16, 0.41, -0.22, 0.0, np.pi / 10),
        (0.1, 0.21, 0.25, 0.0, 0.35, 0.0),
        (0.1, 0.046, 0.046, 0.0, 0.1, 0.0),
        (0.1, 0.046, 0.023, -0.08, -0.605, 0.0),
        (0.1, 0.023, 0.046, 0.06, -0.605, 0.0),
    ]
    for val, a, b, x0, y0, phi in ellipses:
        xr = (x - x0) * np.cos(phi) + (y - y0) * np.sin(phi)
        yr = -(x - x0) * np.sin(phi) + (y - y0) * np.cos(phi)
        img[(xr / a) ** 2 + (yr / b) ** 2 <= 1.0] += val
    return np.clip(img, 0, 1).astype(np.float32)


def _fft2c_np(img: np.ndarray) -> np.ndarray:
    out = np.fft.ifftshift(img, axes=(-2, -1))
    out = np.fft.fftn(out, axes=(-2, -1), norm="ortho")
    return np.fft.fftshift(out, axes=(-2, -1))


def _ifft2c_np(ksp: np.ndarray) -> np.ndarray:
    out = np.fft.ifftshift(ksp, axes=(-2, -1))
    out = np.fft.ifftn(out, axes=(-2, -1), norm="ortho")
    return np.fft.fftshift(out, axes=(-2, -1))


def make_mat_record(size: int = 128, acceleration: int = 4,
                    noise_sigma: float = 0.0, seed: int = 0,
                    gt: np.ndarray | None = None) -> Dict[str, np.ndarray]:
    """Build a .mat-style eval record matching the schema the reference
    consumes (datasets.py:153-160): x0/y0 as (1, H, W, 2) real-imag pairs,
    mask (1, H, W), ATy0 (1, H, W, 2), gt (1, H, W).

    The zero-filled recon x0 = F^-1(mask * (F(gt) + noise)) — the standard
    CSMRI initialization the downloaded eval sets encode.
    """
    rng = np.random.default_rng(seed)
    if gt is None:
        gt = shepp_logan(size)
        if seed:
            # Slight per-seed deformation for dataset variety.
            shift = rng.integers(-6, 7, 2)
            gt = np.roll(gt, shift, axis=(0, 1))
    n_spokes = max(size // acceleration // 1, 8)
    mask = radial_mask(size, n_spokes=n_spokes, seed=seed)
    ksp = _fft2c_np(gt.astype(np.complex64))
    if noise_sigma > 0:
        noise = rng.normal(0, noise_sigma / 255.0, (size, size)) \
            + 1j * rng.normal(0, noise_sigma / 255.0, (size, size))
        ksp = ksp + noise.astype(np.complex64)
    y0 = np.where(mask, ksp, 0).astype(np.complex64)
    x0 = _ifft2c_np(y0).astype(np.complex64)
    aty0 = x0  # A^T y0 == zero-filled recon for this sampling operator

    def ri(c):  # complex (H, W) -> (1, H, W, 2)
        return np.stack([c.real, c.imag], axis=-1)[None].astype(np.float32)

    return {
        "x0": ri(x0),
        "y0": ri(y0),
        "mask": mask[None],
        "ATy0": ri(aty0),
        "gt": gt[None].astype(np.float32),
    }


def write_eval_dir(path: str, token: str, n: int = 7, size: int = 128,
                   seed: int = 0) -> str:
    """Write ``n`` records ``img_{token}_s{i}.mat`` for the eval-set token
    ``{acceleration}_{noise}`` (e.g. ``"4_15"``) into ``path``, the layout
    ``EvaluationDataset`` reads. Returns ``path``."""
    import os

    from scipy.io import savemat

    acc, noise = (int(v) for v in token.split("_"))
    os.makedirs(path, exist_ok=True)
    for i in range(n):
        rec = make_mat_record(size=size, acceleration=acc,
                              noise_sigma=float(noise), seed=seed + i)
        savemat(os.path.join(path, f"img_{token}_s{i}.mat"), rec)
    return path
