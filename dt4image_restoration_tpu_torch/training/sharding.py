"""Data-parallel training (the port's counterpart of the JAX package's
``training/sharding.py``).

  * :func:`maybe_initialize_distributed` - ``torch.distributed`` from the
    ``torchrun`` environment, one process per device;
  * :func:`background_batches` - host batch assembly on a thread;
  * :func:`shard_batch`, :func:`prefetch_shard` - a process's batch onto its
    device from pinned host memory, one batch ahead of the step;
  * :func:`make_train_step` - one update; across processes, the gradients
    are all-reduced with each rank's weight, its count of valid target
    values, so the update follows the masked mean over the global batch,
    as the JAX package's ``psum`` of weighted shards does. Averaging each
    rank's own masked mean (``DistributedDataParallel``) differs whenever
    ranks hold different numbers of padded steps.
"""
from __future__ import annotations

import contextlib
import os
import queue as queue_mod
import threading
from typing import Callable, Dict, Iterable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from .trainer import TrainState, loss_fn


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def maybe_initialize_distributed(device="cuda") -> torch.device:
    """Join the process group that ``torchrun`` describes (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL on
    CUDA, Gloo on the CPU. A no-op when ``WORLD_SIZE`` is unset or 1, or
    the group exists. Returns the process's device: ``cuda:LOCAL_RANK`` on
    CUDA."""
    dev = torch.device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dev.type == "cuda" and world > 1:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if world > 1 and not dist.is_initialized():
        dist.init_process_group(
            backend="nccl" if dev.type == "cuda" else "gloo",
            init_method="env://", world_size=world,
            rank=int(os.environ["RANK"]))
    return dev


def background_batches(iterator: Iterable, size: int = 2) -> Iterator:
    """Run a host batch iterator (file reads, window crops) on a background
    thread with a bounded queue, so input assembly overlaps the device. An
    error of the iterator is raised in the consumer: a corrupt file fails
    the epoch instead of shortening it."""
    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=size)
    end = object()
    stop = threading.Event()

    def bounded_put(item) -> bool:
        # A consumer that stops early (preemption) sets ``stop``; the
        # bounded wait lets this thread end instead of blocking forever on
        # a full queue.
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not bounded_put(item):
                    return
            bounded_put(end)
        except BaseException as exc:  # noqa: BLE001 - raised in consumer
            bounded_put(exc)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def shard_batch(batch: Dict[str, np.ndarray], device
                ) -> Dict[str, torch.Tensor]:
    """This process's host batch onto ``device``: on CUDA through pinned
    host memory with non-blocking copies, so the copy overlaps the device
    work already queued."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def prefetch_shard(iterator: Iterator, shard_fn: Callable) -> Iterator:
    """Yield ``shard_fn(batch)`` for each batch, with the next batch's
    ``shard_fn`` already issued when one is handed out: its host-to-device
    copy is queued before the current step runs."""
    current = next(iterator, None)
    if current is None:
        return
    current = shard_fn(current)
    for batch in iterator:
        upcoming = shard_fn(batch)
        yield current
        current = upcoming
    yield current


def valid_count(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The number of valid target values of a batch: its mask's sum times
    the target width (action_dim + 1), the masked mean's denominator."""
    return batch["traj_masks"].sum() * (batch["actions"].shape[-1] + 1)


def all_reduce_weighted(params, loss: torch.Tensor, weight: torch.Tensor,
                        group=None) -> torch.Tensor:
    """All-reduce the gradients of ``params`` and ``loss`` across the
    group, each rank's scaled by ``weight / sum(weight)``: with the valid
    count as the weight, the result is the gradient and the value of the
    masked mean over the union of the ranks' batches. One all-reduce of
    one flat buffer. Returns the global loss."""
    total = weight.detach().float().clone()
    dist.all_reduce(total, group=group)
    scale = weight.detach().float() / total.clamp_min(1.0)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [loss.detach().float().reshape(1)]) * scale
    dist.all_reduce(flat, group=group)
    offset = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[offset:offset + n].view_as(p)
        offset += n
    return flat[-1]


def make_train_step(dtype: str = "float32") -> Callable:
    """``(state, batch) -> loss``: one update of ``state`` in place (the
    model in training mode, forward and masked MSE, backward, the weighted
    all-reduce when a process group of more than one rank exists, clip and
    AdamW, the scheduler, ``state.step += 1``). Returns the loss of the
    global batch, detached, on the device.

    ``dtype='bfloat16'`` runs forward and loss under ``torch.autocast``
    (bfloat16 matmuls and convolutions); parameters, gradients and the
    optimizer stay float32."""
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unsupported training dtype {dtype!r}")

    def step(state: TrainState, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        model = state.model
        model.train()
        device = next(model.parameters()).device
        autocast = torch.autocast(device.type, dtype=torch.bfloat16) \
            if dtype == "bfloat16" else contextlib.nullcontext()
        with autocast:
            loss = loss_fn(model, batch)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if process_count() > 1:
            params = [p for p in model.parameters() if p.requires_grad]
            loss = all_reduce_weighted(params, loss, valid_count(batch))
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return loss.detach()
    return step
