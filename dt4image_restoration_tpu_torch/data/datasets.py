"""Evaluation data: .mat slices (the port's own copy of the JAX package's
``data/datasets.py`` evaluation part; training data is a later slice).

Pure numpy and scipy: records stay on the host until ``reset_from_mat``
moves them to the device.
"""
from __future__ import annotations

import os
import re

import numpy as np

from ..config import (
    FLEX_RTG_RANGE,
    FLEX_TASKS,
    OPTIMAL_RTG_RANGE,
    OPTIMAL_TASKS,
)


def extract_task(s: str) -> str:
    """Filename -> task id, e.g. 'img_4_15_slice0.mat' -> '4_15'
    (reference datasets.py:13-16)."""
    match = re.search(r"\d+_\d+", s)
    if match is None:
        raise ValueError(f"no task pattern in: {s}")
    return match.group()


def minmax_normalize(value, lo: float, hi: float):
    return (np.asarray(value, np.float32) - lo) / (hi - lo)


class EvaluationDataset:
    """Evaluation slices from .mat files, covering both reference variants:

      * ``kind='optimal'`` — task token parsed from the filename pattern
        ``{acc}_{noise}`` (datasets.py:171-207)
      * ``kind='flex'`` — task token from the RTG target value
        (datasets.py:135-168)

    ``__getitem__`` returns ``((states, rtg, actions, task), mat)`` where
    ``mat['x0']`` is clipped at 0 like the reference (:160, :199) while
    ``states`` reads the raw unclipped x0 (:163 reads ``mat['x0']``, which
    the clip's rebinding never touched).
    """

    def __init__(self, data_dir: str, rtg_target: float,
                 kind: str = "optimal", action_dim: int = 3,
                 image_size: int = 128) -> None:
        self.data_dir = data_dir
        self.rtg_target = float(rtg_target)
        self.kind = kind
        self.action_dim = action_dim
        self.image_size = image_size
        if kind == "flex":
            self.tasks, (self.min_rtg, self.max_rtg) = (
                FLEX_TASKS, FLEX_RTG_RANGE)
        else:
            self.tasks, (self.min_rtg, self.max_rtg) = (
                OPTIMAL_TASKS, OPTIMAL_RTG_RANGE)
        self.task_tokenizer = {t: i for i, t in enumerate(self.tasks)}
        self.fns = sorted(f for f in os.listdir(data_dir)
                          if f.endswith(".mat"))

    def __len__(self) -> int:
        return len(self.fns)

    def _task_token(self, fn: str) -> int:
        if self.kind == "flex":
            # 'rtg_3' vs 'rtg_3.0': reproduce str() of the python value
            # (datasets.py:150).
            val = self.rtg_target
            label = f"rtg_{int(val) if val == int(val) else val}"
        else:
            t = extract_task(fn)
            label = t[0] + "x" + t[1:]
        return self.task_tokenizer[label]

    def __getitem__(self, index: int):
        from scipy.io import loadmat
        fn = self.fns[index]
        mat = loadmat(os.path.join(self.data_dir, fn))
        record = {k: np.asarray(mat[k]) for k in
                  ("x0", "y0", "mask", "ATy0", "gt")}
        # The policy's initial observation comes from the UNCLIPPED x0: the
        # reference's np.clip rebinds only the env record entry
        # (datasets.py:160-164); ``states`` reads the raw mat['x0'], which
        # typically has negative reals (zero-filled recon).
        states = record["x0"][..., 0].reshape(1, -1).astype(np.float32)
        record["x0"] = np.clip(record["x0"], 0, None)
        rtg = minmax_normalize(self.rtg_target, self.min_rtg, self.max_rtg)
        rtg = np.full((1, 1), rtg, np.float32)
        actions = np.zeros((self.action_dim,), np.float32)
        task = np.asarray([self._task_token(fn)], np.int32)
        return (states, rtg, actions, task), record


class EvaluationFlexibleDataset(EvaluationDataset):
    """Reference-familiar alias (datasets.py:135-168)."""

    def __init__(self, data_dir: str, rtg_target: float, action_dim: int = 3,
                 block_size: int = None, **kw) -> None:
        super().__init__(data_dir, rtg_target, kind="flex",
                         action_dim=action_dim, **kw)


class EvaluationOptimalDataset(EvaluationDataset):
    """Reference-familiar alias (datasets.py:171-207)."""

    def __init__(self, data_dir: str, rtg_target: float, action_dim: int = 3,
                 block_size: int = None, **kw) -> None:
        super().__init__(data_dir, rtg_target, kind="optimal",
                         action_dim=action_dim, **kw)
