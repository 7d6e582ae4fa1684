"""Host-side data: trajectory training data (json + h5) and evaluation .mat
slices (the port's own copy of the JAX package's ``data/datasets.py``).

Host numpy (and h5py, scipy where a file is read; the preloaded batch
gather in C++, :mod:`.native_loader`): batches and records stay on the host
until the trainer or ``reset_from_mat`` moves them to the device. The numpy
code is the JAX package's, so a batch is bit-identical to its batch for the
same files and seeds.
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from ..config import (
    FLEX_RTG_RANGE,
    FLEX_TASKS,
    OPTIMAL_RTG_RANGE,
    OPTIMAL_TASKS,
)
from .native_loader import gather_scale_u8

ACTION_KEYS_JSON = ("T", "sigma_d", "mu")  # dict order in trajectory json
BATCH_KEYS = ("states", "actions", "rtg", "traj_masks", "timesteps", "task")


def extract_task(s: str) -> str:
    """Filename -> task id, e.g. 'img_4_15_slice0.mat' -> '4_15'
    (reference datasets.py:13-16)."""
    match = re.search(r"\d+_\d+", s)
    if match is None:
        raise ValueError(f"no task pattern in: {s}")
    return match.group()


def minmax_normalize(value, lo: float, hi: float):
    return (np.asarray(value, np.float32) - lo) / (hi - lo)


class TrainingDataset:
    """Offline trajectories: one json per trajectory (keys ``RTG``,
    ``Actions`` (dict of 3 per-step lists), ``State Paths``, ``Task``),
    with observation images stored in a single HDF5 file keyed by the
    trailing part of each state path (reference datasets.py:38-132).

    ``__getitem__`` returns numpy arrays
    (states, actions, rtg, traj_masks, timesteps, task) with a random
    ``block_size`` window crop of longer trajectories (from ``rng``) and
    zero-pad + mask for shorter ones. ``block_size`` counts timesteps.
    RTGs are min-max normalised to [min_rtg, max_rtg] when
    ``normalize_rtg``.

    ``preload=True`` parses every json and reads every uint8 state once,
    and assembles a batch's states with one native gather
    (:func:`.native_loader.gather_scale_u8`); the batches are the same bit
    for bit.
    """

    def __init__(self, block_size: int, data_dir: str, action_dim: int,
                 state_file_path: str, tasks: Sequence[str],
                 min_rtg: float, max_rtg: float, image_size: int = 128,
                 normalize_rtg: bool = True,
                 path_prefix_len: int = 10,
                 rng: Optional[np.random.Generator] = None,
                 preload: bool = False) -> None:
        self.block_size = block_size
        self.data_dir = data_dir
        self.action_dim = action_dim
        self.state_file_path = state_file_path
        self.task_tokenizer = {t: i for i, t in enumerate(tasks)}
        self.min_rtg = min_rtg
        self.max_rtg = max_rtg
        self.image_size = image_size
        self.normalize_rtg = normalize_rtg
        # The reference strips the first 10 chars of each state path to get
        # the h5 key (datasets.py:50).
        self.path_prefix_len = path_prefix_len
        self.files = sorted(os.listdir(data_dir))
        self.rng = rng or np.random.default_rng(0)
        self._h5 = None
        self._cache = None
        self._states_u8 = None
        if preload:
            self._preload()

    def __len__(self) -> int:
        return len(self.files)

    def close(self) -> None:
        """Close the state file's read handle, if one is open."""
        if self._h5 is not None:
            self._h5.close()
            self._h5 = None

    def _get_image(self, traj_path: str) -> np.ndarray:
        # One persistent read handle; batch assembly runs on one thread
        # (training/sharding.background_batches).
        if self._h5 is None:
            import h5py
            self._h5 = h5py.File(self.state_file_path, "r")
        key = traj_path[self.path_prefix_len:]
        return np.float32(self._h5[key][:] / 255)

    def _preload(self) -> None:
        """Parse every trajectory json and load every referenced uint8
        state image once into a contiguous (n_images, H*W) array."""
        import h5py
        cache, key_rows, key_order = [], {}, []
        for fn in self.files:
            with open(os.path.join(self.data_dir, fn)) as f:
                traj = json.load(f)
            rtg = np.asarray(traj["RTG"], np.float32)
            if self.normalize_rtg:
                rtg = minmax_normalize(rtg, self.min_rtg, self.max_rtg)
            # Per-key truncation to len(RTG) before stacking: action lists
            # may be longer than RTG and ragged across keys; the streaming
            # path never reads past len(RTG) of any key.
            actions = np.stack(
                [np.asarray(traj["Actions"][k][:len(traj["RTG"])],
                            np.float32)
                 for k in ACTION_KEYS_JSON], axis=1)
            rows = np.empty(len(traj["State Paths"]), np.int64)
            for i, p in enumerate(traj["State Paths"]):
                key = p[self.path_prefix_len:]
                if key not in key_rows:
                    key_rows[key] = len(key_order)
                    key_order.append(key)
                rows[i] = key_rows[key]
            cache.append({
                "length": len(traj["RTG"]), "rtg": rtg, "actions": actions,
                "rows": rows,
                "task_id": self.task_tokenizer[traj["Task"]],
            })
        with h5py.File(self.state_file_path, "r") as f:
            first = np.asarray(f[key_order[0]]) if key_order else None
            if first is not None and first.dtype != np.uint8:
                raise ValueError(
                    f"preload=True requires uint8 state images, got "
                    f"{first.dtype}; use the streaming path")
            elems = first.size if first is not None else 0
            states = np.empty((len(key_order), elems), np.uint8)
            for i, key in enumerate(key_order):
                img = np.asarray(f[key])
                if img.dtype != np.uint8 or img.size != elems:
                    raise ValueError(
                        f"preload=True requires homogeneous uint8 states; "
                        f"{key} is {img.dtype} with {img.size} elems")
                states[i] = img.reshape(-1)
        self._cache, self._states_u8 = cache, states

    def _item_meta(self, index: int):
        """Preloaded per-item assembly: everything but the state pixels,
        plus the image row indices (-1 = zero padding). Mirrors
        ``__getitem__``'s two branches exactly, including the single
        ``rng.integers`` call for the window start."""
        c = self._cache[index]
        traj_len, block = c["length"], self.block_size
        task = np.full((block,), c["task_id"], np.int32)
        if traj_len >= block:
            start = 0 if traj_len == block else int(
                self.rng.integers(0, traj_len - block))
            sl = slice(start, start + block)
            actions = c["actions"][sl]
            rtg = c["rtg"][sl].reshape(-1, 1)
            masks = np.ones((block,), np.float32)
            rows = c["rows"][sl]
            timesteps = np.arange(start, start + block,
                                  dtype=np.int32).reshape(-1, 1)
        else:
            pad = block - traj_len
            actions = np.concatenate(
                [c["actions"][:traj_len],
                 np.zeros((pad, c["actions"].shape[1]), np.float32)])
            rtg = np.concatenate(
                [c["rtg"].reshape(-1, 1), np.zeros((pad, 1), np.float32)])
            masks = np.concatenate(
                [np.ones(traj_len, np.float32), np.zeros(pad, np.float32)])
            rows = np.concatenate(
                [c["rows"][:traj_len], np.full(pad, -1, np.int64)])
            timesteps = np.arange(block, dtype=np.int32).reshape(-1, 1)
        return rows, actions, rtg, masks[:, None], timesteps, task

    def __getitem__(self, index: int):
        if self._cache is not None:
            rows, actions, rtg, masks, timesteps, task = \
                self._item_meta(index)
            states = gather_scale_u8(self._states_u8, rows)
            # actions/rtg can be views into the preload cache; hand the
            # caller copies so in-place edits cannot corrupt later items.
            return (states, actions.copy(), rtg.copy(), masks, timesteps,
                    task)
        with open(os.path.join(self.data_dir, self.files[index])) as f:
            traj = json.load(f)

        traj_len = len(traj["RTG"])
        block = self.block_size
        task_id = self.task_tokenizer[traj["Task"]]
        task = np.full((block,), task_id, np.int32)

        rtg_all = np.asarray(traj["RTG"], np.float32)
        if self.normalize_rtg:
            rtg_all = minmax_normalize(rtg_all, self.min_rtg, self.max_rtg)

        if traj_len >= block:
            start = 0 if traj_len == block else int(
                self.rng.integers(0, traj_len - block))
            sl = slice(start, start + block)
            # Explicit key order: the (T, sigma_d, mu) columns must not
            # depend on the json dict's serialization order.
            actions = np.stack(
                [np.asarray(traj["Actions"][k][sl], np.float32)
                 for k in ACTION_KEYS_JSON], axis=1)
            rtg = rtg_all[sl].reshape(-1, 1)
            timesteps = np.arange(start, start + block,
                                  dtype=np.int32).reshape(-1, 1)
            paths = traj["State Paths"][sl]
            states = np.stack([self._get_image(p) for p in paths])
            masks = np.ones((block,), np.float32)
        else:
            pad = block - traj_len
            actions = np.stack(
                [np.asarray(traj["Actions"][k][:traj_len], np.float32)
                 for k in ACTION_KEYS_JSON], axis=1)
            actions = np.concatenate(
                [actions, np.zeros((pad, actions.shape[1]), np.float32)])
            rtg = np.concatenate(
                [rtg_all.reshape(-1, 1), np.zeros((pad, 1), np.float32)])
            masks = np.concatenate(
                [np.ones(traj_len, np.float32), np.zeros(pad, np.float32)])
            states = np.stack(
                [self._get_image(p) for p in traj["State Paths"][:traj_len]])
            states = np.concatenate(
                [states, np.zeros((pad,) + states.shape[1:], np.float32)])
            timesteps = np.arange(block, dtype=np.int32).reshape(-1, 1)

        states = states.reshape(block, -1)
        return (states, actions, rtg, masks[:, None], timesteps, task)

    def batches(self, batch_size: int, shuffle: bool = True,
                drop_remainder: bool = True,
                seed: int = 0,
                shard_index: int = 0, num_shards: int = 1
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Host-side batch iterator of stacked numpy dicts (keys
        ``BATCH_KEYS``).

        ``shard_index``/``num_shards`` split the data over the processes of
        a data-parallel run: every process shuffles with the same ``seed``
        (each must derive the same permutation), and the permutation is
        wrap-padded to a multiple of ``num_shards`` before striding, so
        every process yields the same number of batches (unequal counts
        would leave a rank waiting in a collective). Shuffle defaults on
        (PARITY.md D8).
        """
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        if num_shards > 1 and len(order) % num_shards:
            total = -(-len(order) // num_shards) * num_shards
            # np.resize repeats cyclically, so a pad longer than the
            # dataset still gives every shard the same count.
            order = np.resize(order, total)
        order = order[shard_index::num_shards]
        n = len(order) - (len(order) % batch_size if drop_remainder else 0)
        for i in range(0, n, batch_size):
            idx = order[i:i + batch_size]
            if len(idx) < batch_size and drop_remainder:
                break
            if self._cache is not None:
                # Preloaded: one native gather (GIL released, threaded)
                # assembles every state window of the batch.
                metas = [self._item_meta(j) for j in idx]
                batch = {k: np.stack([m[j + 1] for m in metas])
                         for j, k in enumerate(BATCH_KEYS[1:])}
                batch["states"] = gather_scale_u8(
                    self._states_u8, np.stack([m[0] for m in metas]))
                yield {k: batch[k] for k in BATCH_KEYS}
                continue
            items = [self[j] for j in idx]
            yield {k: np.stack([it[j] for it in items])
                   for j, k in enumerate(BATCH_KEYS)}


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
