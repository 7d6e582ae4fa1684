"""Data- and tensor-parallel training (the port's counterpart of the JAX
package's ``training/sharding.py``).

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
    ranks hold different numbers of padded steps. On a mesh the all-reduce
    runs over its data axis (:func:`make_shard_map_train_step` is the step
    on a mesh without a model axis);
  * :class:`Mesh`, :func:`make_mesh` - a ``(data, model)`` mesh: for
    inference, this process's local devices along a data axis, times the
    processes; for training with a model axis, one device a process, rank
    ``r`` at ``(r // n_model, r % n_model)``, with a process group along
    each axis;
  * :func:`param_partition_spec`, :func:`shard_params`,
    :func:`gather_params` - the Decision Transformer's parameters over the
    model axis (Megatron's column and row splits, ``tensor_parallel.py``):
    which are split, this rank's shard, and the full reference-layout
    state dict back;
  * :func:`sync_processes`, :func:`shard_eval_inputs`,
    :func:`gather_eval_outputs`, :func:`local_output_offset`,
    :func:`padded_per_process` - the inference helpers: inputs split over
    the local shards, outputs joined on the host and, across processes,
    gathered over a Gloo group of their own (:func:`host_group`);
  * :func:`replicate`, :func:`run_sharded` - one copy of a model per local
    device, and one call per local shard, a host thread per distinct
    device.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import datetime
import itertools
import os
import queue as queue_mod
import threading
from typing import (Any, Callable, Dict, Iterable, Iterator, List,
                    Optional, Sequence, Tuple)

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .tensor_parallel import (COLUMN, ModelShard, gather_state_dict,
                              shard_of, split_of)
from .trainer import TrainState, loss_fn

# Seconds a process waits at a barrier of the inference helpers.
BARRIER_TIMEOUT_S = 600


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


def prefetch_shard(iterator: Iterator, shard_fn: Callable, size: int = 2
                   ) -> Iterator:
    """Yield ``shard_fn(batch)`` for each batch, with ``shard_fn`` issued
    ``size - 1`` batches ahead of the one handed out (the next batch's
    host-to-device copy is queued before the current step runs, at the
    default of 2)."""
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    iterator = iter(iterator)
    ahead: collections.deque = collections.deque()

    def enqueue(n: int) -> None:
        for _ in range(n):
            batch = next(iterator, None)
            if batch is None:
                return
            ahead.append(shard_fn(batch))

    enqueue(size)
    while ahead:
        yield ahead.popleft()
        enqueue(1)


def prefetch_to_device(iterator: Iterator, mesh: "Mesh", size: int = 2
                       ) -> Iterator:
    """:func:`prefetch_shard` onto ``mesh``: each host batch (a dict of
    arrays, leading axis the batch) is split over the mesh's local shards
    and yielded as one dict of tensors per shard, on the shard's device."""
    return prefetch_shard(
        iterator, lambda b: [shard_batch(part, dev) for part, dev in zip(
            split_local(b, mesh), mesh.devices)], size)


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


def make_train_step(dtype: str = "float32", mesh: Optional["Mesh"] = None
                    ) -> Callable:
    """``(state, batch) -> loss``: one update of ``state`` in place (the
    model in training mode, forward and masked MSE, backward, the weighted
    all-reduce when a process group of more than one rank exists, clip and
    AdamW, the scheduler, ``state.step += 1``). Returns the loss of the
    global batch, detached, on the device.

    With ``mesh`` the all-reduce runs over its ``data_group``, for the
    model's sharded and replicated parameters alike, each data rank
    weighted by the valid count of its rows; the model-axis collectives of
    a model from :func:`shard_params` run in its layers. Without a mesh it
    runs over every process, and a sharded model is refused.

    ``dtype='bfloat16'`` runs forward and loss under ``torch.autocast``
    (bfloat16 matmuls and convolutions); parameters, gradients and the
    optimizer stay float32."""
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unsupported training dtype {dtype!r}")
    if mesh is None:
        group, reduce = None, process_count() > 1
    else:
        group, reduce = mesh.data_group, mesh.data_processes > 1

    def step(state: TrainState, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        model = state.model
        if mesh is None and model.tp is not None:
            raise ValueError("a model sharded over a model axis trains "
                             "with make_train_step(mesh=...)")
        model.train()
        device = next(model.parameters()).device
        autocast = torch.autocast(device.type, dtype=torch.bfloat16) \
            if dtype == "bfloat16" else contextlib.nullcontext()
        with autocast:
            loss = loss_fn(model, batch)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if reduce:
            params = [p for p in model.parameters() if p.requires_grad]
            loss = all_reduce_weighted(params, loss, valid_count(batch),
                                       group=group)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return loss.detach()
    return step


def make_shard_map_train_step(mesh: "Mesh", dtype: str = "float32"
                              ) -> Callable:
    """The JAX package's explicit data-parallel step (per-shard gradients,
    a weighted ``psum`` over the data axis, replicated parameters): the
    port's :func:`make_train_step` on ``mesh``, whose model axis must be
    1."""
    if mesh.n_model != 1:
        raise ValueError(f"make_shard_map_train_step is data-parallel "
                         f"only; the mesh has a model axis of "
                         f"{mesh.n_model} (use make_train_step(mesh=...))")
    return make_train_step(dtype, mesh)


# -- the mesh ----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` mesh. ``devices`` are this process's local
    devices along the data axis, repeated over the processes of the data
    axis; ``shape`` is the global one, as a JAX mesh's is:
    ``{"data": len(devices) * process_count() // n_model, "model":
    n_model}``.

    ``devices`` may name one device more than once (``["cpu", "cpu"]``,
    ``[cuda:0, cuda:0]``): each entry is a shard of its own, and shards on
    one device run one after another. That is how a CPU, or a machine with
    one card, holds a mesh of two shards.

    With a model axis (``n_model > 1``) every process holds one device,
    and rank ``r`` sits at ``(data_index, model_index) = (r // n_model,
    r % n_model)``, the row-major layout of JAX's ``reshape(n_data,
    n_model)``. ``model_group`` holds the ``n_model`` ranks of this rank's
    data index, ``data_group`` the ranks of its model index (None for the
    default group, without a model axis). Inference on such a mesh shards
    over the data axis and is replicated over the model axis."""
    devices: Tuple[torch.device, ...]
    n_model: int = 1
    data_group: Any = dataclasses.field(default=None, compare=False,
                                        repr=False)
    model_group: Any = dataclasses.field(default=None, compare=False,
                                         repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices) * self.data_processes,
                "model": self.n_model}

    @property
    def data_processes(self) -> int:
        """The processes along the data axis: every process, over the
        model axis's size."""
        return process_count() // self.n_model

    @property
    def data_index(self) -> int:
        """This process's place along the data axis."""
        return process_index() // self.n_model

    @property
    def model_index(self) -> int:
        """This process's place along the model axis."""
        return process_index() % self.n_model

    def model_shard(self) -> ModelShard:
        """This rank's place on the model axis, for its model's layers."""
        return ModelShard(group=self.model_group, index=self.model_index,
                          size=self.n_model)

    @property
    def distinct_devices(self) -> List[torch.device]:
        """The local devices, each once, in order of first appearance."""
        return list(dict.fromkeys(self.devices))


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A :class:`Mesh` over ``devices``, this process's local devices
    (default: every visible GPU when the world is one process, else the
    process's own ``cuda:LOCAL_RANK``). ``n_data``, if given, must equal
    the local devices times the processes over ``n_model``.

    ``n_model > 1`` needs ``n_data * n_model`` processes of one device
    each (``torchrun --nproc_per_node``): one process holds one model
    shard, where JAX's GSPMD splits the model over the devices of one
    process. It makes the axes' process groups with ``dist.new_group`` on
    the default group's backend (NCCL under ``torchrun`` on distinct
    GPUs, Gloo where ranks share a GPU or run on the CPU); that call is
    collective, so every rank makes the same meshes in the same order."""
    if n_model < 1:
        raise ValueError(f"n_model must be >= 1, got {n_model}")
    n_proc = process_count()
    if n_model > 1:
        return _model_mesh(n_data, n_model, devices, n_proc)
    if devices is None:
        if n_proc > 1:
            devices = [torch.device(
                "cuda", int(os.environ.get("LOCAL_RANK", "0")))]
        else:
            resolve_device("cuda")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
    devices = tuple(_indexed(resolve_device(d)) for d in devices)
    if not devices:
        raise ValueError("make_mesh needs at least one device")
    if n_data is not None and n_data != len(devices) * n_proc:
        raise ValueError(
            f"n_data = {n_data} must equal the local devices times the "
            f"processes, {len(devices)} * {n_proc}")
    return Mesh(devices=devices)


def _model_mesh(n_data: Optional[int], n_model: int,
                devices: Optional[Sequence], n_proc: int) -> Mesh:
    """:func:`make_mesh` with a model axis: the checks, this rank's device
    and the axes' groups."""
    if n_proc == 1:
        raise ValueError(
            f"a model axis of {n_model} needs one process per model shard: "
            f"launch n_data * n_model processes (torchrun "
            f"--nproc_per_node), one device each; one process cannot hold "
            f"a model axis")
    if n_proc % n_model or (n_data is not None
                            and n_data * n_model != n_proc):
        raise ValueError(
            f"n_data * n_model = {n_data} * {n_model} must equal the "
            f"processes, {n_proc}")
    if devices is None:
        devices = [torch.device("cuda",
                                int(os.environ.get("LOCAL_RANK", "0")))]
    devices = tuple(_indexed(resolve_device(d)) for d in devices)
    if len(devices) != 1:
        raise ValueError(f"a mesh with a model axis holds one device a "
                         f"process, got {len(devices)}")
    data_group, model_group = _axis_groups(n_model)
    return Mesh(devices=devices, n_model=n_model, data_group=data_group,
                model_group=model_group)


_AXIS_GROUPS: Dict[int, Any] = {}


def _axis_groups(n_model: int):
    """This rank's (data group, model group) on a mesh with a model axis
    of ``n_model``, made once per default group and axis size: every
    group of both axes, on every rank, in one order (``dist.new_group``
    is collective)."""
    world = dist.group.WORLD
    cached = _AXIS_GROUPS.get(n_model)
    if cached is None or cached[0] is not world:
        n_proc, backend = process_count(), dist.get_backend()
        ranks = np.arange(n_proc).reshape(-1, n_model)
        model_groups = [dist.new_group(row.tolist(), backend=backend)
                        for row in ranks]
        data_groups = [dist.new_group(col.tolist(), backend=backend)
                       for col in ranks.T]
        cached = (world, model_groups, data_groups)
        _AXIS_GROUPS[n_model] = cached
    _, model_groups, data_groups = cached
    r = process_index()
    return data_groups[r % n_model], model_groups[r // n_model]


# -- parameters over the model axis -----------------------------------------

def _names(model_or_state_dict) -> List[str]:
    if isinstance(model_or_state_dict, torch.nn.Module):
        return [n for n, _ in model_or_state_dict.named_parameters()]
    return list(model_or_state_dict)


def param_partition_spec(model_or_state_dict, tensor_parallel: bool
                         ) -> Dict[str, tuple]:
    """Per parameter name, its partition over the mesh axes in the torch
    layout (weights ``(out, in)``, the transpose of JAX's kernels): ``()``
    replicated; with ``tensor_parallel``, ``("model", None)`` for the
    column-split ``qkv_proj`` and ``fc`` weights (their output features;
    ``qkv_proj``'s by heads within each of q, k and v) and ``(None,
    "model")`` for the row-split ``o_proj`` and ``fc_proj`` weights (their
    input features). Biases and every other parameter are replicated, as
    in the JAX package's ``param_partition_spec``."""
    out = {}
    for name in _names(model_or_state_dict):
        how = split_of(name) if tensor_parallel else None
        out[name] = () if how is None else \
            (("model", None) if how[0] == COLUMN else (None, "model"))
    return out


def shard_params(model_or_state_dict, mesh: Mesh,
                 tensor_parallel: bool = False):
    """This rank's shard of the Decision Transformer's parameters on
    ``mesh``. A state dict (the reference layout) gives a new dict of
    shards. A model is changed in place and returned: its split weights
    become this rank's shards and its blocks run on them (``Block.tp``,
    ``Attention.tp``); shard it before building its optimizer. Without
    ``tensor_parallel``, or on a mesh without a model axis, every
    parameter is replicated and the input is returned as it is."""
    if not tensor_parallel or mesh.n_model == 1:
        return model_or_state_dict
    shard = mesh.model_shard()
    if not isinstance(model_or_state_dict, torch.nn.Module):
        return {k: shard_of(k, v, shard)
                for k, v in model_or_state_dict.items()}
    model = model_or_state_dict
    if model.tp is not None:
        raise ValueError("the model is already sharded")
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            if split_of(name) is not None:
                owner, leaf = name.rsplit(".", 1)
                setattr(model.get_submodule(owner), leaf,
                        torch.nn.Parameter(shard_of(name, p, shard)))
    model.tp = shard
    for blk in model.blocks:
        blk.tp = blk.attn.tp = shard
    return model


def gather_params(model_or_state_dict, mesh: Optional[Mesh] = None
                  ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_params`: the full state dict, in the
    reference layout, on every rank. A model gives its own (its shard
    names the group; ``mesh`` may be omitted); a state dict of this
    rank's shards needs ``mesh``. Collective over the model axis: every
    model rank calls it. Without shards (a model that holds none, a mesh
    without a model axis) it is the state dict as it is."""
    if isinstance(model_or_state_dict, torch.nn.Module):
        shard = model_or_state_dict.tp
        sd = model_or_state_dict.state_dict()
    else:
        shard = None if mesh is None or mesh.n_model == 1 \
            else mesh.model_shard()
        sd = dict(model_or_state_dict)
    return sd if shard is None else gather_state_dict(sd, shard)


# -- multi-device and multi-process inference ------------------------------


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the current CUDA device's index, as tensors report it."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


_HOST_GROUP: Dict[str, Any] = {}
_SYNC_COUNTER = [0]


def host_group():
    """The Gloo group that the inference helpers gather and wait over, made
    once per process group (``dist.new_group`` is collective: every rank
    reaches it at the same call of a helper). Gloo, whatever the default
    backend: the outputs are a few values a slice, gathered to the host,
    and two ranks may share one GPU, which NCCL refuses."""
    world = dist.group.WORLD
    if _HOST_GROUP.get("world") is not world:
        _HOST_GROUP.update(world=world, group=dist.new_group(backend="gloo"))
    return _HOST_GROUP["group"]


def sync_processes(tag: str = "eval") -> None:
    """Align every process at a barrier before a multi-process inference
    dispatch; a no-op for one process. Barriers are numbered by a
    process-local counter, so a rank that raises between two matched
    dispatches must exit, not catch and go on: the sequences then differ
    and every later barrier times out. The error names the barrier and
    this cause."""
    if process_count() <= 1:
        return
    _SYNC_COUNTER[0] += 1
    name = f"dt4ir_{tag}_{_SYNC_COUNTER[0]}"
    try:
        dist.monitored_barrier(
            group=host_group(),
            timeout=datetime.timedelta(seconds=BARRIER_TIMEOUT_S))
    except RuntimeError as e:
        raise RuntimeError(
            f"multi-process barrier '{name}' failed: {e}. A barrier "
            f"timeout here usually means another process raised or "
            f"skipped a dispatch and the per-process barrier sequence "
            f"desynced; a rank that fails mid-sequence must exit, not "
            f"catch and continue.") from e


def tree_map(fn: Callable, tree):
    """``fn`` on every tensor and numpy leaf of ``tree`` (tuples, lists,
    dicts and dataclasses of them; None and other values pass through)."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def tree_leaves(tree) -> list:
    leaves: list = []
    tree_map(leaves.append, tree)
    return leaves


def split_local(tree, mesh: Mesh, axis: int = 0) -> list:
    """``tree`` split along ``axis`` into one tree per local shard of
    ``mesh``, in shard order; the axis must divide evenly."""
    n = len(mesh.devices)
    sizes = {x.shape[axis] for x in tree_leaves(tree)}
    if any(s % n for s in sizes):
        raise ValueError(f"axis {axis} of sizes {sorted(sizes)} does not "
                         f"split into {n} local shards")

    def part(i):
        def take(x):
            per = x.shape[axis] // n
            index = (slice(None),) * axis + (slice(i * per, (i + 1) * per),)
            return x[index]
        return tree_map(take, tree)
    return [part(i) for i in range(n)]


def shard_eval_inputs(tree, mesh: Optional[Mesh], axis: int = 0,
                      device=None) -> list:
    """Split a tree of batched inference inputs (this process's slice of
    the global batch) along ``axis`` over the local shards of ``mesh``, and
    move each part to its shard's device as tensors. Returns one tree per
    local shard. The entry of every multi-process inference dispatch: it
    aligns the processes first (:func:`sync_processes`). With
    ``mesh=None`` the whole tree is the one shard, on ``device``, and no
    process is waited for."""
    if mesh is None:
        parts, devices = [tree], [resolve_device(device)]
    else:
        sync_processes("shard_eval")
        parts, devices = split_local(tree, mesh, axis), mesh.devices

    def put(dev):
        def move(x):
            t = torch.as_tensor(x)
            return t.to(dev) if t.device != dev else t
        return move
    return [tree_map(put(dev), part) for part, dev in zip(parts, devices)]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def gather_eval_outputs(shards: Sequence, mesh: Optional[Mesh] = None,
                        axis: int = 0):
    """Inference outputs as host numpy arrays. ``shards`` holds one tree
    per local shard (one with ``mesh=None``), joined along ``axis`` in
    shard order. With a mesh over several processes of its data axis,
    every process's join is then gathered in the data axis's order, so
    that each sees the global batch (as JAX's
    ``process_allgather(tiled=True)``); of the model ranks of a data index,
    which hold the same rows, the first one's are taken. With
    ``mesh=None`` no collective is issued, even in a multi-process job: a
    per-process serving queue holds process-local outputs."""
    local = _join([tree_map(_host, t) for t in shards], axis)
    if mesh is None or mesh.data_processes <= 1:
        return local
    everyone: list = [None] * process_count()
    dist.all_gather_object(everyone, local, group=host_group())
    return _join(everyone[::mesh.n_model], axis)


def _join(trees: Sequence, axis: int):
    """Trees of one structure joined leaf by leaf along ``axis``."""
    if len(trees) == 1:
        return trees[0]
    return _zip_map(lambda *xs: np.concatenate(xs, axis), trees)


def _zip_map(fn: Callable, trees: Sequence):
    """``fn`` over the corresponding leaves of trees of one structure."""
    leaves = [tree_leaves(t) for t in trees]
    it = iter([fn(*xs) for xs in zip(*leaves)])
    return tree_map(lambda _: next(it), trees[0])


def local_output_offset(n_local_padded: int, mesh: Optional[Mesh] = None
                        ) -> int:
    """This process's row offset in the gathered global outputs:
    ``mesh.data_index * n_local_padded``. That holds only when every
    process submitted the same padded count, which this checks with a
    gather: a mismatch raises instead of attributing another process's
    rows. 0 for one process along the data axis or ``mesh=None``."""
    if mesh is None or mesh.data_processes <= 1:
        return 0
    counts: list = [None] * process_count()
    dist.all_gather_object(counts, int(n_local_padded), group=host_group())
    if any(c != n_local_padded for c in counts):
        raise ValueError(
            f"multi-host inference needs equal per-process record counts; "
            f"got {counts} (pad every process to the same length)")
    return mesh.data_index * n_local_padded


def padded_per_process(n_global: int, mesh: Mesh) -> int:
    """The length of each process's slice when a global record list is cut
    into equal contiguous slices, one for each process along the data
    axis: ceil(n_global / those processes), rounded up to this process's
    share of the data axis. Callers wrap-pad the global list to
    ``mesh.data_processes * padded_per_process``."""
    n_proc = mesh.data_processes
    per = -(-n_global // n_proc)
    unit = max(1, mesh.shape["data"] // n_proc)
    return per + (-per) % unit


def _module_device(module: torch.nn.Module) -> Optional[torch.device]:
    for t in itertools.chain(module.parameters(), module.buffers()):
        return t.device
    return None


def replicate(module, mesh: Mesh) -> list:
    """One ``module`` per local shard of ``mesh``: shards on one device
    share one copy, the module itself on its own device and a deep copy
    moved to each other device (each copy keeps its own weight caches). A
    callable that is not an ``nn.Module`` is returned for every shard as
    it is."""
    if not isinstance(module, torch.nn.Module):
        return [module] * len(mesh.devices)
    home = _module_device(module)
    copies = {}
    for dev in mesh.distinct_devices:
        if home is None or dev == home:
            copies[dev] = module
        else:
            copies[dev] = copy.deepcopy(module).to(dev)
    return [copies[dev] for dev in mesh.devices]


def run_sharded(fn: Callable, devices: Sequence[torch.device],
                args: Sequence) -> list:
    """``[fn(*args[i]) for each shard i]`` with shard i on ``devices[i]``:
    shards on one device run one after another in shard order; with more
    than one distinct device, each device's shards run on a host thread of
    their own (inside ``torch.cuda.device`` of it, for a CUDA device), so
    that one device's host work overlaps another's kernels. The caller's
    grad mode holds in every thread. The first error of a shard, in shard
    order, is raised."""
    groups: Dict[torch.device, List[int]] = {}
    for i, dev in enumerate(devices):
        groups.setdefault(dev, []).append(i)
    out: list = [None] * len(devices)
    if len(groups) == 1:
        for i in range(len(devices)):
            out[i] = fn(*args[i])
        return out
    grad = torch.is_grad_enabled()
    errors: Dict[int, BaseException] = {}

    def work(dev, idx):
        current = torch.cuda.device(dev) if dev.type == "cuda" \
            else contextlib.nullcontext()
        with torch.set_grad_enabled(grad), current:
            for i in idx:
                try:
                    out[i] = fn(*args[i])
                except BaseException as exc:  # noqa: BLE001 - in caller
                    errors[i] = exc
                    return

    threads = [threading.Thread(target=work, args=item, daemon=True)
               for item in groups.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[min(errors)]
    return out


def synchronize(devices: Iterable[torch.device]) -> None:
    """Wait for every CUDA device among ``devices``."""
    for dev in dict.fromkeys(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
