"""The multichip dry run of the port: the twin of the JAX package's
``__graft_entry__.py:dryrun_multichip``. Over a ``(data, model)`` mesh of
``--devices`` ranks (``n_model = 2`` when the count is even and at least 4,
else 1), on tiny shapes, it runs three stages:

  1. the full train step (:func:`training.make_train_step` on the mesh),
     the batch over ``data`` and, with a model axis, the attention and MLP
     projections tensor-parallel over ``model``
     (:func:`training.shard_params`);
  2. a sharded greedy-eval rollout: one image per data shard through
     ``Evaluator`` with the U-Net prior (kernels K1, K2 and, through the
     fused policy forward, K3);
  3. a ``DeviceMCTS`` search, one tree per data shard (K1, K2 and, through
     the per-op policy forward, K4 and K5).

Stages 2 and 3 run the unsharded weights, replicated over ``model``, as the
JAX dry run evaluates and searches with ``params_host``. Each rank prints
the JAX run's ``OK`` lines with its rank and the kernel launches of the
stage (none on the CPU, where every kernel runs its plain version).

    python -m dt4image_restoration_tpu_torch.tools.dryrun_multichip \\
        --devices 4 [--device cpu]

spawns the ranks in one Gloo group (ranks share ``cuda:0`` when the
machine has fewer GPUs than ranks); under ``torchrun`` (``WORLD_SIZE``
set) the process runs as the launched rank.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import socket
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np

JOIN_S = 900          # every spawned rank ends within this, or the run fails
CONTEXT = 18          # ModelConfig(block_size=18)
MAX_TIMESTEPS = 6
SEARCH_ITERATIONS = 2


def mesh_axes(n_devices: int):
    """``(n_data, n_model)``: a model axis of 2 where ``n_devices`` is even
    and at least 4, as in the JAX dry run."""
    n_model = 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1
    return n_devices // n_model, n_model


def _records(n: int) -> list:
    from ..data import make_mat_record
    out = []
    for i in range(n):
        mat = dict(make_mat_record(seed=i))
        states = mat["x0"][..., 0].reshape(1, -1).astype(np.float32)
        mat["x0"] = np.clip(mat["x0"], 0, None)
        out.append(((states, np.full((1, 1), 0.6, np.float32),
                     np.zeros(3, np.float32), np.asarray([2], np.int32)),
                    mat))
    return out


def _train_batch(b: int, t: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(0)
    return {
        "states": rng.uniform(0, 1, (b, t, 128 * 128)).astype(np.float32),
        "actions": rng.uniform(0, 1, (b, t, 3)).astype(np.float32),
        "rtg": rng.uniform(0, 1, (b, t, 1)).astype(np.float32),
        "traj_masks": np.ones((b, t, 1), np.float32),
        "timesteps": np.broadcast_to(
            np.arange(t, dtype=np.int32)[None, :, None], (b, t, 1)).copy(),
        "task": rng.integers(0, 9, (b, t)).astype(np.int32),
    }


def run_rank(n_devices: int, device) -> dict:
    """The three stages as this rank of a process group of ``n_devices``
    ranks, on ``device``. Prints the ``OK`` lines; returns each stage's
    numbers and kernel launches. Raises if a stage's output is not
    finite."""
    import torch

    from ..config import MCTSConfig, ModelConfig, TrainerConfig
    from ..inference import DeviceMCTS, Evaluator
    from ..models import (DecisionTransformer, UNetDenoiser, init_dt_params,
                          random_unet_state_dict)
    from ..ops import kernels
    from ..training import (init_train_state, make_mesh, make_train_step,
                            shard_batch, shard_params)
    from ..training.sharding import padded_per_process, process_index
    from ..utils.convert import load_strict

    world = torch.distributed.get_world_size()
    if world != n_devices:
        raise ValueError(f"the process group has {world} ranks, the dry "
                         f"run {n_devices}")
    rank = process_index()
    n_data, n_model = mesh_axes(n_devices)
    mesh = make_mesh(n_data=n_data, n_model=n_model, devices=[device])
    dev = mesh.devices[0]
    out = {"rank": rank, "mesh": [n_data, n_model]}

    def synced():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return kernels.launch_counts()

    # (1) The train step: this data index's one row; with a model axis the
    # projections are this rank's shards.
    cfg = ModelConfig(block_size=CONTEXT, n_embeds=9, mode="norm")
    params = init_dt_params(cfg, seed=0)
    model = load_strict(DecisionTransformer(cfg), params, "DT").to(dev)
    shard_params(model, mesh, tensor_parallel=n_model > 1)
    state = init_train_state(model, TrainerConfig(), max_steps=100)
    step = make_train_step(mesh=mesh)
    batch = _train_batch(n_data, cfg.context_length)
    row = slice(mesh.data_index, mesh.data_index + 1)
    kernels.reset_launch_counts()
    loss = float(step(state, shard_batch({k: v[row] for k, v in
                                          batch.items()}, dev)))
    out["train"] = {"loss": loss, "launches": synced()}
    if not np.isfinite(loss):
        raise AssertionError(f"rank {rank}: train loss {loss}")
    print(f"dryrun_multichip OK: rank={rank}, mesh=(data={n_data}, "
          f"model={n_model}), loss={loss:.4f}, "
          f"launches={out['train']['launches']}", flush=True)

    # (2) Greedy evaluation, one image per data shard, on the unsharded
    # weights; each data index runs its slice and sees every row.
    policy = load_strict(DecisionTransformer(ModelConfig(
        block_size=CONTEXT, n_embeds=9, mode="norm", use_pallas=True)),
        params, "DT").to(dev).eval().requires_grad_(False)
    denoise = load_strict(UNetDenoiser(), random_unet_state_dict(0),
                          "U-Net").to(dev).eval().requires_grad_(False)
    records = _records(n_data)
    per = padded_per_process(n_data, mesh)
    mine = records[mesh.data_index * per:(mesh.data_index + 1) * per]
    ev = Evaluator(dt=policy, denoise=denoise, cfg=policy.cfg,
                   max_timesteps=MAX_TIMESTEPS, device=dev, mesh=mesh)
    kernels.reset_launch_counts()
    m = ev.evaluate_records(mine, return_global=True)
    reward = np.asarray(m["reward"], np.float64)
    out["eval"] = {"reward": reward.tolist(), "launches": synced()}
    if reward.shape != (n_data,) or not np.isfinite(reward).all():
        raise AssertionError(f"rank {rank}: eval rewards {reward}")
    print(f"dryrun_multichip eval OK: rank={rank}, {n_data} images sharded "
          f"over data={n_data}, mean reward={reward.mean():.3f}, "
          f"launches={out['eval']['launches']}", flush=True)

    # (3) The device-resident search, one tree per data shard, scorer 0.
    search = DeviceMCTS(
        dt=policy, denoise=denoise, model_cfg=policy.cfg,
        cfg=MCTSConfig(iterations=SEARCH_ITERATIONS,
                       max_timesteps=MAX_TIMESTEPS),
        value_fn=lambda x: 0.0,
        value_fn_batched=lambda x: torch.zeros(x.shape[0], device=x.device),
        device=dev, mesh=mesh)
    kernels.reset_launch_counts()
    rewards = np.asarray(search.run_global_batches(
        records, seeds=list(range(n_data)), batch_size=n_data), np.float64)
    out["mcts"] = {"reward": rewards.tolist(), "launches": synced()}
    if rewards.shape != (n_data,) or not np.isfinite(rewards).all():
        raise AssertionError(f"rank {rank}: search rewards {rewards}")
    print(f"dryrun_multichip mcts OK: rank={rank}, {n_data} trees sharded "
          f"over data={n_data}, mean reward={rewards.mean():.3f}, "
          f"launches={out['mcts']['launches']}", flush=True)
    return out


def _rank_device(device: str, rank: int):
    """``device`` for ``rank``: its own GPU where there are enough, else
    the GPUs in turn (ranks share ``cuda:0`` on a machine with one)."""
    import torch

    from ..utils.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def _spawned_rank(rank: int, n_devices: int, port: int, device: str,
                  out_path: str) -> None:
    """One spawned rank: join the Gloo group at ``port``, run the stages,
    write their results to ``out_path.<rank>`` as JSON."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=n_devices, rank=rank)
    try:
        result = run_rank(n_devices, _rank_device(device, rank))
        with open(f"{out_path}.{rank}", "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     join_s: float = JOIN_S) -> List[dict]:
    """Spawn ``n_devices`` ranks (``spawn`` context, one Gloo group) and run
    the dry run in them; returns every rank's results, in rank order. A
    rank that fails, or outlives ``join_s`` seconds (then killed), fails
    the run."""
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        return _spawn(n_devices, device, join_s, os.path.join(tmp, "rank"))


def _spawn(n_devices: int, device: str, join_s: float, out_path: str
           ) -> List[dict]:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_spawned_rank,
                         args=(r, n_devices, port, device, out_path))
             for r in range(n_devices)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=max(1.0, join_s - (time.perf_counter() - t0)))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
    if alive or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"dry run ranks: exit codes "
                           f"{[p.exitcode for p in procs]}, {len(alive)} "
                           f"killed after {join_s} s")
    results = []
    for r in range(n_devices):
        with open(f"{out_path}.{r}") as f:
            results.append(json.load(f))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=4,
                    help="ranks of the mesh (spawned here unless launched "
                         "by torchrun)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from ..training import maybe_initialize_distributed
        import torch.distributed as dist
        dev = maybe_initialize_distributed(args.device)
        try:
            run_rank(args.devices, dev)
        finally:
            dist.destroy_process_group()
        return 0
    dryrun_multichip(args.devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
