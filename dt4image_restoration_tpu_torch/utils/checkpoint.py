"""Checkpoints of training (the port's counterpart of the training roles of
the JAX package's ``utils/checkpoint.py``).

Two kinds of file, both written with ``torch.save``:

  * a full training state (``state_latest.pt``): model, optimizer,
    scheduler, step and RNG states, read back by
    :func:`restore_checkpoint` to resume;
  * a model in the reference's ``.pt`` layout (``model_<epoch>.pt``,
    :func:`save_dt_reference`), which the port's ``eval --checkpoint``
    and the JAX package's ``load_dt_checkpoint`` both read.

Every write goes to a temporary file that is then renamed over the target,
so a process killed mid-write leaves the previous checkpoint intact.
"""
from __future__ import annotations

import concurrent.futures as cf
import os
import tempfile
from typing import Any, Callable, List

import torch

from ..config import ModelConfig
from .convert import dt_to_reference


def to_host(obj: Any) -> Any:
    """A copy of ``obj`` (nested dicts, lists and tuples) whose tensors are
    detached CPU copies: what a queued save holds, so that later steps
    cannot change it."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def save_checkpoint(path: str, obj: Any) -> None:
    """``torch.save(obj)`` to ``path`` through a temporary file in the same
    directory and an atomic rename."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".ckpt_")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(obj, f)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def restore_checkpoint(path: str) -> Any:
    """Read a checkpoint written by :func:`save_checkpoint` onto the CPU.
    Only tensors and plain Python values are unpickled
    (``weights_only``)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def save_dt_reference(path: str, state_dict, cfg: ModelConfig) -> None:
    """Write a port DT state dict as a reference-layout ``.pt`` file
    (:func:`utils.convert.dt_to_reference`)."""
    save_checkpoint(path, dt_to_reference(state_dict, cfg.block_size))


class AsyncCheckpointSaver:
    """:func:`save_checkpoint` on one background writer, so a training
    loop does not wait for checkpoint I/O. Pass host copies
    (:func:`to_host`) taken before :meth:`submit`. Saves run in submission
    order; :meth:`wait` blocks until all are written and re-raises the
    first failure."""

    def __init__(self) -> None:
        self._ex = cf.ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="ckpt_saver")
        self._futures: List[cf.Future] = []

    def submit(self, path: str, obj: Any) -> cf.Future:
        """Queue ``save_checkpoint(path, obj)``; returns its future."""
        return self.defer(save_checkpoint, path, obj)

    def defer(self, fn: Callable, *args) -> cf.Future:
        """Queue ``fn(*args)`` behind every save submitted so far (e.g.
        retention of old checkpoints, which must run once they are
        written)."""
        fut = self._ex.submit(fn, *args)
        self._futures.append(fut)
        return fut

    def wait(self) -> None:
        """Block until every queued job is done; re-raises the first
        failure."""
        futs, self._futures = self._futures, []
        for f in futs:
            f.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._ex.shutdown()
