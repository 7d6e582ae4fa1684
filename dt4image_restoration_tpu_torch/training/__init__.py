"""Training of the Decision Transformer: the port's counterpart of the JAX
package's ``training/``, over a ``(data, model)`` mesh, and the mesh that
evaluation, search and serving shard over."""
from .sharding import (Mesh, background_batches, gather_params, make_mesh,
                       make_shard_map_train_step, make_train_step,
                       maybe_initialize_distributed, param_partition_spec,
                       prefetch_shard, prefetch_to_device, shard_batch,
                       shard_params)
from .trainer import (Trainer, TrainState, init_train_state,
                      make_lr_schedule, make_optimizer, make_watch_grad_fn,
                      masked_mse_loss)

__all__ = ["Mesh", "Trainer", "TrainState", "background_batches",
           "gather_params", "init_train_state", "make_lr_schedule",
           "make_mesh", "make_optimizer", "make_shard_map_train_step",
           "make_train_step", "make_watch_grad_fn", "masked_mse_loss",
           "maybe_initialize_distributed", "param_partition_spec",
           "prefetch_shard", "prefetch_to_device", "shard_batch",
           "shard_params"]
