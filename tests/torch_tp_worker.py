"""One rank of the port's tensor-parallel training, for the 4-process Gloo
tests in test_torch_tensor_parallel.py: a mesh of data 2 x model 2 on the
CPU. Imports PyTorch and the port only, so that a spawned process starts
quickly."""
import contextlib
import io
import os

import torch
import torch.distributed as dist

N_DATA, N_MODEL = 2, 2


def _rows(batch, mesh):
    """This rank's rows of a numpy batch: its data index's contiguous half,
    as JAX's ``P("data")`` cuts the batch axis."""
    half = next(iter(batch.values())).shape[0] // N_DATA
    lo = mesh.data_index * half
    return {k: v[lo:lo + half] for k, v in batch.items()}


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _model(cfg, weights, mesh=None):
    """The port DT on ``weights``; sharded over ``mesh``'s model axis when
    a mesh is given."""
    from dt4image_restoration_tpu_torch.models import DecisionTransformer
    from dt4image_restoration_tpu_torch.training import shard_params
    from dt4image_restoration_tpu_torch.utils.convert import load_strict
    model = load_strict(DecisionTransformer(cfg), weights, "DT")
    if mesh is not None:
        shard_params(model, mesh, tensor_parallel=True)
    return model


def _updates(cfg, weights, batches, tcfg, mesh, sharded=True):
    """Three updates on ``mesh`` (this rank's rows of each batch): the
    losses, the full weights after them and, after each step, the global
    norm of the clipped gradients."""
    from dt4image_restoration_tpu_torch.training import (gather_params,
                                                         init_train_state,
                                                         make_train_step)
    model = _model(cfg, weights, mesh if sharded else None)
    state = init_train_state(model, tcfg, 10)
    step = make_train_step(mesh=mesh)
    losses, norms = [], []
    for b in batches:
        losses.append(float(step(state, _tensors(_rows(b, mesh)))))
        norms.append(float(state.optimizer._global_norm()))
    return {"losses": losses, "norms": norms,
            "params": gather_params(model)}


def _round_trip(cfg, weights, mesh):
    """shard_params then gather_params, of a state dict and of a model;
    the shapes of this rank's shards."""
    from dt4image_restoration_tpu_torch.training import (gather_params,
                                                         shard_params)
    shards = shard_params(weights, mesh, tensor_parallel=True)
    model = _model(cfg, weights, mesh)
    return {"from_dict": gather_params(shards, mesh),
            "from_model": gather_params(model),
            "shapes": {k: tuple(v.shape) for k, v in shards.items()},
            "model_shapes": {n: tuple(p.shape)
                             for n, p in model.named_parameters()}}


def _trainer(cfg, weights, batches, tcfg, mesh, ckpt, stop_after=None,
             **kw):
    from dt4image_restoration_tpu_torch.training import (Trainer,
                                                         init_train_state,
                                                         make_train_step)
    step = make_train_step(mesh=mesh)
    calls = []

    def counted(state, batch):
        loss = step(state, batch)
        calls.append(1)
        if stop_after is not None and len(calls) == stop_after:
            trainer.request_stop()
        return loss

    trainer = Trainer(train_step=counted,
                      state=init_train_state(_model(cfg, weights, mesh),
                                             tcfg, 8),
                      config=tcfg,
                      batches=lambda epoch: iter([_rows(b, mesh)
                                                  for b in batches]),
                      checkpoint_dir=ckpt, **kw)
    return trainer


def _resume(data, mesh, out_dir):
    """A straight TP run of 4 updates (dropout on) against 2 updates, a
    stop and a resume of 2 more, from weights of another seed."""
    from dt4image_restoration_tpu_torch.training import gather_params
    cfg = data["cfg_dropout"]
    tcfg = data["tcfg_resume"]
    batches = data["batches4"]
    straight = _trainer(cfg, data["weights"], batches, tcfg, mesh,
                        os.path.join(out_dir, "straight"))
    straight.train()
    first = _trainer(cfg, data["weights"], batches, tcfg, mesh,
                     os.path.join(out_dir, "first"), stop_after=2)
    first.train()
    at_stop = gather_params(first.state.model)
    dist.barrier()          # rank 0 has written first/state_latest.pt
    resumed = _trainer(cfg, data["weights_other"], batches[2:], tcfg, mesh,
                       os.path.join(out_dir, "resumed"),
                       resume_from=os.path.join(out_dir, "first",
                                                "state_latest.pt"))
    resumed.train()
    return {"straight": gather_params(straight.state.model),
            "straight_losses": straight.last_losses,
            "steps": [first.state.step, resumed.state.step],
            "at_stop": at_stop,
            "resumed": gather_params(resumed.state.model),
            "resumed_losses": resumed.last_losses}


def rank_main(rank: int, world: int, port: int, in_path: str,
              out_dir: str) -> None:
    """Join a ``world``-rank Gloo group at ``port``, run every check on a
    mesh of data 2 x model 2 and write this rank's results to
    ``out_dir/rank.<rank>``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        from dt4image_restoration_tpu_torch.tools.dryrun_multichip import (
            run_rank)
        from dt4image_restoration_tpu_torch.training import make_mesh
        data = torch.load(in_path, weights_only=False)
        mesh = make_mesh(n_data=N_DATA, n_model=N_MODEL, devices=["cpu"])
        cfg, weights = data["cfg"], data["weights"]
        out = {"place": (mesh.data_index, mesh.model_index),
               "shape": mesh.shape}
        out["round_trip"] = _round_trip(cfg, weights, mesh)
        out["jax"] = _updates(cfg, weights, data["batches"], data["tcfg"],
                              mesh)
        out["clip"] = _updates(cfg, weights, data["batches"],
                               data["tcfg_clip"], mesh)
        out["dropout"] = _updates(data["cfg_dropout"], weights,
                                  data["batches"], data["tcfg"], mesh)
        out["dropout_unsharded"] = _updates(
            data["cfg_dropout"], weights, data["batches"], data["tcfg"],
            mesh, sharded=False)
        out["resume"] = _resume(data, mesh, out_dir)
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            out["dryrun"] = run_rank(world, torch.device("cpu"))
        out["dryrun_printed"] = printed.getvalue()
        torch.save(out, os.path.join(out_dir, f"rank.{rank}"))
    finally:
        dist.destroy_process_group()

