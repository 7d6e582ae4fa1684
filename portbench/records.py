"""The slices a cell restores, made from the run's seed.

The generator is a copy of the port's ``data/synthetic.py:make_mat_record``
(a Shepp-Logan phantom shifted per slice, a golden-angle radial k-space
mask of ``128 / acceleration`` spokes, complex Gaussian noise of
``noise / 255`` on the sampled k-space, and the zero-filled
reconstruction as x0), kept here so that the yardstick's inputs cannot
move with the program. A pool holds ``per_task`` slices of every task of
the configuration; the traffic draws from it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch


def radial_mask(size: int, n_spokes: int, seed: int) -> np.ndarray:
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


def shepp_logan(size: int) -> np.ndarray:
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


def _fft2c(img):
    out = np.fft.ifftshift(img, axes=(-2, -1))
    out = np.fft.fftn(out, axes=(-2, -1), norm="ortho")
    return np.fft.fftshift(out, axes=(-2, -1))


def _ifft2c(ksp):
    out = np.fft.ifftshift(ksp, axes=(-2, -1))
    out = np.fft.ifftn(out, axes=(-2, -1), norm="ortho")
    return np.fft.fftshift(out, axes=(-2, -1))


def make_record(size: int, acceleration: int, noise_sigma: float,
                seed: int, phantom: np.ndarray) -> Dict[str, np.ndarray]:
    """One .mat-style record: x0 and y0 as (1, H, W, 2) real/imaginary
    pairs, mask (1, H, W), gt (1, H, W)."""
    rng = np.random.default_rng(seed)
    gt = np.roll(phantom, rng.integers(-6, 7, 2), axis=(0, 1))
    mask = radial_mask(size, max(size // acceleration, 8), seed)
    ksp = _fft2c(gt.astype(np.complex64))
    if noise_sigma > 0:
        noise = rng.normal(0, noise_sigma / 255.0, (size, size)) \
            + 1j * rng.normal(0, noise_sigma / 255.0, (size, size))
        ksp = ksp + noise.astype(np.complex64)
    y0 = np.where(mask, ksp, 0).astype(np.complex64)
    x0 = _ifft2c(y0).astype(np.complex64)

    def ri(c):
        return np.stack([c.real, c.imag], axis=-1)[None].astype(np.float32)

    return {"x0": ri(x0), "y0": ri(y0), "mask": mask[None],
            "gt": gt[None].astype(np.float32)}


def normalised_rtg(cfg: Dict) -> float:
    """The RTG target min-max normalised over the experiment's range
    (datasets.py's ``minmax_normalize``)."""
    lo, hi = cfg["rtg_range"]
    return (float(cfg["rtg_target"]) - lo) / (hi - lo)


@dataclasses.dataclass
class Pool:
    """``per_task`` slices of each task, task by task: ``records[i]`` is
    the raw record of slice i and ``tasks[i]`` its task token."""
    records: List[Dict[str, np.ndarray]]
    tasks: List[int]
    rtg: float
    per_task: int

    def eval_record(self, i: int):
        """Slice i as the evaluation dataset yields it: ((states, rtg,
        actions, task), record), the record's x0 clipped at 0 and the
        states the unclipped x0's real part."""
        rec = dict(self.records[i])
        states = rec["x0"][..., 0].reshape(1, -1).astype(np.float32)
        rec["x0"] = np.clip(rec["x0"], 0, None)
        return ((states, np.full((1, 1), self.rtg, np.float32),
                 np.zeros((3,), np.float32),
                 np.asarray([self.tasks[i]], np.int32)), rec)

    def reference_inputs(self, idx: Sequence[int], device) -> Dict:
        """The rows ``idx`` as the reference takes them, on ``device``."""
        def cplx(key):
            ri = np.concatenate([self.records[i][key] for i in idx])
            t = torch.from_numpy(np.ascontiguousarray(ri)).to(device)
            return torch.complex(t[..., 0], t[..., 1])
        return {
            "x0": cplx("x0"), "y0": cplx("y0"),
            "mask": torch.from_numpy(np.concatenate(
                [self.records[i]["mask"] for i in idx])).to(device),
            "gt": torch.from_numpy(np.concatenate(
                [self.records[i]["gt"] for i in idx])).to(device),
            "rtg": torch.full((len(idx),), self.rtg, device=device),
            "task": torch.tensor([self.tasks[i] for i in idx],
                                 device=device)}


def make_pool(cfg: Dict, per_task: int, seed: int) -> Pool:
    """The pool of a run: the slices' seeds come from ``seed``; the task
    mix (every task of ``cfg["tasks"]``, ``per_task`` each) does not."""
    rng = np.random.default_rng(seed)
    size = int(cfg["image_size"])
    phantom = shepp_logan(size)
    records, tasks = [], []
    for task in cfg["tasks"]:
        acc, noise = task.split("x_")
        for s in rng.integers(1, 2 ** 31, per_task):
            records.append(make_record(size, int(acc), float(noise), int(s),
                                       phantom))
            tasks.append(list(cfg["tasks"]).index(task))
    return Pool(records, tasks, normalised_rtg(cfg), per_task)
