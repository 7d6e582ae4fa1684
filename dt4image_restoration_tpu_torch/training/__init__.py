"""Training of the Decision Transformer: the port's counterpart of the JAX
package's ``training/``, and the mesh that evaluation, search and serving
shard over."""
from .sharding import (Mesh, background_batches, make_mesh,
                       make_train_step, maybe_initialize_distributed,
                       prefetch_shard, prefetch_to_device, shard_batch)
from .trainer import (Trainer, TrainState, init_train_state,
                      make_lr_schedule, make_optimizer, make_watch_grad_fn,
                      masked_mse_loss)

__all__ = ["Mesh", "Trainer", "TrainState", "background_batches",
           "init_train_state", "make_lr_schedule", "make_mesh",
           "make_optimizer", "make_train_step", "make_watch_grad_fn",
           "masked_mse_loss", "maybe_initialize_distributed",
           "prefetch_shard", "prefetch_to_device", "shard_batch"]
