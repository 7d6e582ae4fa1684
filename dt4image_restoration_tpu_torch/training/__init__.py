"""Training of the Decision Transformer: the port's counterpart of the JAX
package's ``training/``."""
from .sharding import (background_batches, make_train_step,
                       maybe_initialize_distributed, prefetch_shard,
                       shard_batch)
from .trainer import (Trainer, TrainState, init_train_state,
                      make_lr_schedule, make_optimizer, make_watch_grad_fn,
                      masked_mse_loss)

__all__ = ["Trainer", "TrainState", "background_batches",
           "init_train_state", "make_lr_schedule", "make_optimizer",
           "make_train_step", "make_watch_grad_fn", "masked_mse_loss",
           "maybe_initialize_distributed", "prefetch_shard", "shard_batch"]
