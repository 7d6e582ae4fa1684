"""One rank of the port's data-parallel train step, for the 2-process Gloo
test in test_torch_train.py. Imports PyTorch and the port only, so that a
spawned process starts quickly."""
import os

import torch


def dp_steps(rank: int, world: int, port: int, in_path: str,
             out_path: str) -> None:
    """Join a ``world``-rank Gloo group through the ``torchrun``
    environment, take this rank's rows of each batch in ``in_path`` and
    run one train step per batch; rank 0 saves the weights, the last
    step's gradients and the losses to ``out_path``."""
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import torch.distributed as dist

    from dt4image_restoration_tpu_torch.models import DecisionTransformer
    from dt4image_restoration_tpu_torch.training import (
        init_train_state, make_train_step, maybe_initialize_distributed)

    data = torch.load(in_path, weights_only=False)
    dev = maybe_initialize_distributed("cpu")
    try:
        model = DecisionTransformer(data["cfg"])
        model.load_state_dict(data["weights"])
        state = init_train_state(model.to(dev), data["tcfg"], 10)
        step = make_train_step()
        losses = [float(step(state, {k: v[data["rows"][rank]]
                                     for k, v in batch.items()}))
                  for batch in data["batches"]]
        if rank == 0:
            torch.save({"weights": model.state_dict(), "losses": losses,
                        "grads": {n: p.grad.clone() for n, p in
                                  model.named_parameters()}}, out_path)
    finally:
        dist.destroy_process_group()
