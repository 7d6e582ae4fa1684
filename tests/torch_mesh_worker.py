"""One rank of the port's multi-process inference, for the 2-process Gloo
tests in test_torch_multiprocess.py. Imports PyTorch and the port only, so
that a spawned process starts quickly."""
import contextlib
import functools
import io
import os

import numpy as np
import torch

SIZE = 36
CFG_KW = dict(block_size=18, n_embeds=9, embed_dim=32, n_heads=4,
              n_blocks=2, image_size=SIZE)
MAXT = 8


def stub_denoise(img, sigma):
    return torch.clamp(0.85 * img + 0.05 + 0.1 * sigma[:, None, None, None],
                       0.0, 1.0)


def policy():
    """The small random policy (seed 0) whose stop output T sits at -3."""
    from dt4image_restoration_tpu_torch.config import ModelConfig
    from dt4image_restoration_tpu_torch.models import (DecisionTransformer,
                                                       init_dt_params)
    from dt4image_restoration_tpu_torch.utils.convert import load_strict
    cfg = ModelConfig(**CFG_KW, use_pallas=True)
    dt = load_strict(DecisionTransformer(cfg), init_dt_params(cfg, 0), "dt")
    with torch.no_grad():
        dt.predict_action.bias[0] = -3.0      # norm mode: T is column 0
    return dt.eval().requires_grad_(False)


def records(n):
    from dt4image_restoration_tpu_torch.data import make_mat_record
    out = []
    for i in range(n):
        mat = dict(make_mat_record(size=SIZE, seed=i))
        states = mat["x0"][..., 0].reshape(1, -1).astype(np.float32)
        mat["x0"] = np.clip(mat["x0"], 0, None)
        out.append(((states, np.full((1, 1), 0.6, np.float32),
                     np.zeros(3, np.float32), np.asarray([2], np.int32)),
                    mat))
    return out


def wrap_pad(items, n):
    return [items[i % len(items)] for i in range(n)]


def _join(rank: int, world: int, port: int) -> None:
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))


def api_checks(rank: int, dirs) -> dict:
    """The inference API on a mesh of 2 CPU shards in each of the ranks (a
    data axis of 4): Evaluator.run, evaluate_records(return_global=True),
    DeviceMCTS.run_global_batches, a detailed DeviceMCTS.run_batch of the
    rank's own records, and the two errors."""
    from dt4image_restoration_tpu_torch.config import MCTSConfig
    from dt4image_restoration_tpu_torch.inference import (BatchedMCTS,
                                                          DeviceMCTS,
                                                          Evaluator)
    from dt4image_restoration_tpu_torch.models import proxy_value_fn
    from dt4image_restoration_tpu_torch.training import sharding
    from dt4image_restoration_tpu_torch.training.sharding import (
        make_mesh, sync_processes)
    dt = policy()
    mesh = make_mesh(devices=["cpu", "cpu"])
    out = {"shape": mesh.shape}
    ev = Evaluator(dt=dt, denoise=stub_denoise, cfg=dt.cfg,
                   max_timesteps=MAXT, device="cpu", mesh=mesh)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed), \
            spy_on(Evaluator, "evaluate_records") as seen:
        out["run_total"] = ev.run(dirs)
    out["run_printed"] = printed.getvalue()
    out["run_local_counts"] = seen
    out["run_metrics"] = {k: ev.last_metrics[k] for k in
                          ("reward", "increment", "episode_len")}

    padded = wrap_pad(records(5), 8)
    m = ev.evaluate_records(padded[4 * rank:4 * rank + 4],
                            return_global=True)
    out["global"] = {k: m[k] for k in ("reward", "episode_len")}

    search = DeviceMCTS(dt=dt, denoise=stub_denoise, model_cfg=dt.cfg,
                        cfg=MCTSConfig(iterations=3, max_timesteps=MAXT),
                        value_fn=proxy_value_fn, device="cpu", mesh=mesh)
    out["search"] = search.run_global_batches(records(5), list(range(5)),
                                              batch_size=2)
    # A detailed search of this rank's own 2 of 4 records: its rows, from
    # its own shards, with no gather.
    with count_calls(sharding.dist, "all_gather_object") as gathers:
        out["detailed"] = search.run_batch(
            records(4)[2 * rank:2 * rank + 2],
            seeds=[2 * rank, 2 * rank + 1], detailed=True, verbose=False)
    out["detailed_gathers"] = gathers
    sync_processes("worker")

    host = BatchedMCTS(dt=dt, denoise=stub_denoise, model_cfg=dt.cfg,
                       cfg=MCTSConfig(iterations=1, max_timesteps=MAXT),
                       value_fn=proxy_value_fn, device="cpu", mesh=mesh)
    try:
        host.run_batch(records(1))
    except ValueError as e:
        out["host_error"] = str(e)
    # Unequal local counts: both ranks gather, then both raise.
    try:
        ev.evaluate_records(records(2 if rank == 0 else 4))
    except ValueError as e:
        out["offset_error"] = str(e)
    return out


@contextlib.contextmanager
def count_calls(owner, name):
    """Count the calls of ``owner.name`` (one entry per call)."""
    original = getattr(owner, name)
    calls = []

    def counted(*args, **kw):
        calls.append(name)
        return original(*args, **kw)
    setattr(owner, name, counted)
    try:
        yield calls
    finally:
        setattr(owner, name, original)


@contextlib.contextmanager
def spy_on(cls, name):
    """Record the number of records of every call of ``cls.name``."""
    original = getattr(cls, name)
    seen = []

    def spy(self, records, *args, **kw):
        seen.append(len(records))
        return original(self, records, *args, **kw)
    setattr(cls, name, spy)
    try:
        yield seen
    finally:
        setattr(cls, name, original)


def cli_run(argv, iterations=None):
    """The command line's stdout, the search cut to ``iterations`` rounds
    where given, and the number of records of each evaluate_records or
    device search run_batch call."""
    from dt4image_restoration_tpu_torch import __main__ as cli
    from dt4image_restoration_tpu_torch import config
    from dt4image_restoration_tpu_torch.inference import (DeviceMCTS,
                                                          Evaluator)
    original = config.MCTSConfig
    if iterations is not None:
        config.MCTSConfig = functools.partial(original,
                                              iterations=iterations)
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed), \
                spy_on(Evaluator, "evaluate_records") as evaluated, \
                spy_on(DeviceMCTS, "run_batch") as searched:
            cli.main(argv)
    finally:
        config.MCTSConfig = original
    return printed.getvalue(), evaluated + searched


def rank_main(rank: int, world: int, ports, dirs, cli_jobs,
              out_path: str) -> None:
    """Join a ``world``-rank Gloo group through the ``torchrun``
    environment on ``ports[0]``, run :func:`api_checks`, leave the group,
    then run each command line of ``cli_jobs`` (argv, rounds) as its own
    group on the next port; save what each printed or returned to
    ``out_path.<rank>``."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from dt4image_restoration_tpu_torch.training import (
        maybe_initialize_distributed)
    _join(rank, world, ports[0])
    maybe_initialize_distributed("cpu")
    try:
        result = {"api": api_checks(rank, dirs)}
    finally:
        dist.destroy_process_group()
    result["cli"] = []
    for (argv, iterations), port in zip(cli_jobs, ports[1:]):
        _join(rank, world, port)
        result["cli"].append(cli_run(argv, iterations))
    torch.save(result, f"{out_path}.{rank}")
