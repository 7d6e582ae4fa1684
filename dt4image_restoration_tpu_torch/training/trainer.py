"""Decision Transformer training: AdamW with the reference's LR policy,
masked MSE loss, checkpoints with resume (the port's counterpart of the
JAX package's ``training/trainer.py``).

The same policy as the JAX trainer:

  * AdamW, betas (0.9, 0.95), lr 3e-4, weight decay 0.1 on the weights of
    Linear and Conv layers only: biases, LayerNorms and embedding tables
    are not decayed (two parameter groups);
  * the gradients' global norm clipped to 1.0 before each update;
  * linear warmup over 1250 steps, then cosine decay floored at 0.1x,
    evaluated at the count of updates made before the step, so the first
    update runs at lr 0 (PARITY.md D12);
  * masked MSE over the concatenated [actions, rtg] targets.

One update is plain PyTorch (autograd, cuBLAS, cuDNN): the hand-written
kernels K3, K4 and K5 have no backward, so a model built with
``use_pallas=True`` is refused, and so is one built with
``ModelConfig(dtype='bfloat16')`` (an inference setting; bfloat16 training
is autocast over the float32 model).
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import math
import os
import re
import signal
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import TrainerConfig
from ..models.decision_transformer import DecisionTransformer
from .tensor_parallel import gather, gather_state_dict, shard_of, split_of

logger = logging.getLogger(__name__)

MODEL_FILE = "model_{epoch}.pt"
STATE_FILE = "state_latest.pt"


def make_lr_schedule(cfg: TrainerConfig, max_steps: int
                     ) -> Callable[[int], float]:
    """``step -> lr``: ``lr * step / warmup`` while ``step < warmup``, else
    ``lr * max(floor, 0.5 * (1 + cos(pi * step / max_steps)))``."""
    def schedule(step: int) -> float:
        if step < cfg.warmup_steps:
            return cfg.learning_rate * step / cfg.warmup_steps
        cos = 0.5 * (1.0 + math.cos(math.pi * step / max_steps))
        return cfg.learning_rate * max(cfg.lr_floor_mult, cos)
    return schedule


def decay_split(model: torch.nn.Module
                ) -> Tuple[Dict[str, torch.nn.Parameter],
                           Dict[str, torch.nn.Parameter]]:
    """``(decayed, not_decayed)`` parameters by name: the weights of Linear
    and Conv layers decay; biases, LayerNorm parameters and embedding
    tables do not (the JAX package's ``_decay_mask``)."""
    decayed = {}
    for mod_name, mod in model.named_modules():
        if isinstance(mod, (torch.nn.Linear, torch.nn.Conv2d)):
            decayed[f"{mod_name}.weight" if mod_name else "weight"] = \
                mod.weight
    rest = {n: p for n, p in model.named_parameters() if n not in decayed}
    return decayed, rest


class ClippedAdamW(torch.optim.AdamW):
    """AdamW whose :meth:`step` first scales the gradients down to a global
    norm of ``max_grad_norm`` when they exceed it, as
    ``optax.chain(clip_by_global_norm, adamw)``. The scale is computed on
    the device (no host synchronisation).

    For a model sharded over a model axis, ``sharded`` names the
    parameters that hold one shard each and ``model_group`` the ranks that
    hold the others: their squared norms are summed over the group, the
    replicated parameters' counted once, so every rank clips by the
    unsharded model's norm. AdamW and the decay are elementwise, so the
    sharded state is slices of the unsharded one.

    The weight decay is the same as optax's: optax updates
    ``p -= lr * (adam + wd * p)``, PyTorch ``p *= 1 - lr * wd`` and then
    ``p -= lr * adam``; both give ``p - lr * wd * p - lr * adam``."""

    def __init__(self, params, max_grad_norm: float, model_group=None,
                 sharded: Iterable[torch.nn.Parameter] = (),
                 **kwargs) -> None:
        super().__init__(params, **kwargs)
        self.max_grad_norm = max_grad_norm
        self.model_group = model_group
        self._sharded = {id(p) for p in sharded}

    def _global_norm(self) -> Optional[torch.Tensor]:
        params = [p for g in self.param_groups for p in g["params"]
                  if p.grad is not None]
        if not params:
            return None
        if self.model_group is None:
            return torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm([p.grad for p in params])))
        sums = []
        for sharded in (True, False):
            grads = [p.grad for p in params
                     if (id(p) in self._sharded) == sharded]
            sums.append(torch.stack(torch._foreach_norm(grads)).square()
                        .sum() if grads else params[0].grad.new_zeros(()))
        dist.all_reduce(sums[0], group=self.model_group)
        return torch.sqrt(sums[0] + sums[1])

    @torch.no_grad()
    def step(self, closure=None):
        grads = [p.grad for g in self.param_groups for p in g["params"]
                 if p.grad is not None]
        if grads:
            norm = self._global_norm()
            # g / norm * max_norm where the norm exceeds max_norm, in
            # optax's order of operations; g / 1 * 1 elsewhere.
            within = norm < self.max_grad_norm
            one = torch.ones_like(norm)
            torch._foreach_div_(grads, torch.where(within, one, norm))
            torch._foreach_mul_(grads, torch.where(
                within, one, torch.full_like(norm, self.max_grad_norm)))
        return super().step(closure)


def make_optimizer(cfg: TrainerConfig, max_steps: int,
                   model: torch.nn.Module
                   ) -> Tuple[ClippedAdamW, torch.optim.lr_scheduler.LambdaLR]:
    """The optimizer and its LR scheduler. Step the scheduler once after
    each ``optimizer.step()``: update k then runs at ``schedule(k - 1)``.
    A model sharded over a model axis clips by the norm over the axis."""
    decayed, rest = decay_split(model)
    tp = getattr(model, "tp", None)
    opt = ClippedAdamW(
        [{"params": list(decayed.values()),
          "weight_decay": cfg.weight_decay},
         {"params": list(rest.values()), "weight_decay": 0.0}],
        max_grad_norm=cfg.grad_norm_clipping,
        model_group=None if tp is None else tp.group,
        sharded=[p for n, p in model.named_parameters()
                 if tp is not None and split_of(n) is not None],
        lr=cfg.learning_rate, betas=tuple(cfg.betas), eps=1e-8)
    schedule = make_lr_schedule(cfg, max_steps)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: schedule(step) / cfg.learning_rate)
    return opt, scheduler


def masked_mse_loss(preds: torch.Tensor, targets: torch.Tensor,
                    traj_masks: torch.Tensor) -> torch.Tensor:
    """MSE over the valid (unpadded) positions:
    ``sum(err^2 * mask) / max(sum(mask), 1)`` with the per-timestep mask
    broadcast over the target dims."""
    mask = traj_masks.expand_as(targets).to(preds.dtype)
    err = (preds - targets) ** 2 * mask
    return err.sum() / mask.sum().clamp_min(1.0)


def loss_fn(model: DecisionTransformer, batch: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """Forward and masked MSE of concat [pred_actions, pred_rtg] against
    [actions, rtg], in float32."""
    out = model(batch["rtg"], batch["states"], batch["timesteps"],
                batch["task"], batch["actions"])
    preds = torch.cat([out.pred_actions, out.pred_rtg], dim=-1).float()
    targets = torch.cat([batch["actions"], batch["rtg"]], dim=-1)
    return masked_mse_loss(preds, targets, batch["traj_masks"])


def make_watch_grad_fn(model: DecisionTransformer) -> Callable:
    """``batch -> {name: grad}``: the gradients of the training loss at the
    current weights, without an update and without touching ``.grad``
    (the parameter and gradient histograms of ``wandb.watch``). The
    dropout generator's state is put back afterwards, so the step that
    follows draws the same masks as without the watch."""
    def watch(batch):
        model.train()
        gen = model.dropout_generator
        rng_state = None if gen is None else gen.get_state()
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        grads = torch.autograd.grad(loss_fn(model, batch),
                                    [p for _, p in named], allow_unused=True)
        if gen is not None:
            gen.set_state(rng_state)
        return {n: (torch.zeros_like(p) if g is None else g)
                for (n, p), g in zip(named, grads)}
    return watch


def check_trainable(model: DecisionTransformer) -> None:
    """Refuse a model whose forward would run the hand-written kernels,
    which have no backward, or the bfloat16 inference casts."""
    if model.cfg.use_pallas:
        raise ValueError(
            "training needs ModelConfig(use_pallas=False): kernels K4 and K5 "
            "of the per-op forward have no backward")
    if model.cfg.dtype != "float32":
        raise ValueError(
            f"training needs ModelConfig(dtype='float32'), got "
            f"{model.cfg.dtype!r}: bfloat16 training runs the float32 "
            "model under autocast (make_train_step('bfloat16'))")


@dataclasses.dataclass
class TrainState:
    """What one update changes: the model (with the generator of its
    dropout masks), its optimizer and LR scheduler, and the count of
    updates.

    For a model sharded over a model axis, :meth:`state_dict` gathers the
    weights and the Adam moments into the unsharded layout (a collective:
    every model rank calls it) and :meth:`load_state_dict` cuts them again,
    so a saved state does not depend on the model axis's size."""
    model: DecisionTransformer
    optimizer: ClippedAdamW
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0

    def state_dict(self, data_rng: Optional[np.random.Generator] = None
                   ) -> Dict[str, Any]:
        """The full state of a resumable run, with the RNG states: the
        dropout generator, PyTorch's CPU generator and ``data_rng``."""
        gen = self.model.dropout_generator
        tp = self.model.tp
        model_sd = self.model.state_dict()
        return {
            "model": model_sd if tp is None
            else gather_state_dict(model_sd, tp),
            "optimizer": self._moments(self.optimizer.state_dict(),
                                       gather_whole=True),
            "scheduler": self.scheduler.state_dict(),
            "step": self.step,
            "rng": {
                "dropout": None if gen is None else gen.get_state(),
                "torch": torch.get_rng_state(),
                "data": None if data_rng is None
                else data_rng.bit_generator.state,
            },
        }

    def load_state_dict(self, sd: Dict[str, Any],
                        data_rng: Optional[np.random.Generator] = None
                        ) -> None:
        tp = self.model.tp
        model_sd = sd["model"]
        if tp is not None:
            model_sd = {k: shard_of(k, v, tp) for k, v in model_sd.items()}
        self.model.load_state_dict(model_sd)
        self.optimizer.load_state_dict(self._moments(sd["optimizer"],
                                                     gather_whole=False))
        self.scheduler.load_state_dict(sd["scheduler"])
        self.step = int(sd["step"])
        rng = sd["rng"]
        gen = self.model.dropout_generator
        if gen is not None and rng["dropout"] is not None:
            gen.set_state(rng["dropout"])
        torch.set_rng_state(rng["torch"])
        if data_rng is not None and rng["data"] is not None:
            data_rng.bit_generator.state = rng["data"]

    def _moments(self, opt_sd: Dict[str, Any], gather_whole: bool
                 ) -> Dict[str, Any]:
        """``opt_sd`` with the Adam moments of the sharded parameters
        gathered whole (``gather_whole``) or cut to this rank's shards; as
        it is for an unsharded model."""
        tp = self.model.tp
        if tp is None:
            return opt_sd
        names = {id(p): n for n, p in self.model.named_parameters()}
        order = [names[id(p)] for g in self.optimizer.param_groups
                 for p in g["params"]]
        state = {}
        for i, st in opt_sd["state"].items():
            name = order[int(i)]
            state[i] = {k: (gather(name, v, tp) if gather_whole
                            else shard_of(name, v, tp))
                        if k in ("exp_avg", "exp_avg_sq") else v
                        for k, v in st.items()}
        return {**opt_sd, "state": state}


def init_train_state(model: DecisionTransformer, cfg: TrainerConfig,
                     max_steps: int) -> TrainState:
    """A fresh TrainState for ``model`` (on its device): the optimizer and
    scheduler of :func:`make_optimizer` and a dropout generator on the
    model's device seeded from ``cfg.seed``."""
    check_trainable(model)
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    model.set_dropout_generator(gen)
    opt, sched = make_optimizer(cfg, max_steps, model)
    return TrainState(model=model, optimizer=opt, scheduler=sched)


@dataclasses.dataclass
class Trainer:
    """Epoch loop: one ``train_step`` per batch, checkpoints from rank 0,
    optional wandb logging gated on the WANDB_API_KEY env var."""
    train_step: Callable          # (state, device batch) -> loss tensor
    state: TrainState
    config: TrainerConfig
    batches: Callable[[int], Iterable[Dict[str, np.ndarray]]]
    # ^ epoch -> iterator of host batches (numpy dicts), moved to the
    # model's device by sharding.shard_batch one batch ahead
    checkpoint_dir: Optional[str] = None
    resume_from: Optional[str] = None  # path of a state_latest.pt
    watch_grad_fn: Optional[Callable] = None
    # ^ batch -> grads (make_watch_grad_fn): parameter and gradient
    # histograms every config.watch_every steps while wandb logs.
    async_save: bool = False
    # ^ epoch checkpoints on a background writer (AsyncCheckpointSaver).
    # The preemption save stays synchronous (the process may die right
    # after it), and the run's end waits for every queued save.
    keep_last: Optional[int] = None
    # ^ keep only the newest N model_<epoch>.pt (None keeps all);
    # state_latest.pt is never removed.
    data_rng: Optional[np.random.Generator] = None
    # ^ the dataset's window-crop RNG, saved and restored with the state

    def __post_init__(self):
        if self.keep_last is not None and self.keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {self.keep_last}")
        check_trainable(self.state.model)
        self._saver = None
        if self.async_save:
            from ..utils.checkpoint import AsyncCheckpointSaver
            self._saver = AsyncCheckpointSaver()
        self._wandb = None
        if self.config.log_wandb and os.environ.get("WANDB_API_KEY"):
            try:
                import wandb
                wandb.init(project=os.environ.get("WANDB_PROJECT",
                                                  "dt4ir_torch"))
                self._wandb = wandb
            except ImportError:
                logger.warning("wandb unavailable; continuing without it")
        self._stop_requested = False
        self.last_losses = []

    def request_stop(self, *_args) -> None:
        """Stop at the next step boundary, after saving the resume state
        (the SIGTERM/SIGINT handler)."""
        self._stop_requested = True

    def train(self) -> TrainState:
        if self.resume_from:
            from ..utils.checkpoint import restore_checkpoint
            self.state.load_state_dict(restore_checkpoint(self.resume_from),
                                       self.data_rng)
            logger.info("resumed from %s at step %d", self.resume_from,
                        self.state.step)
        # Preemption: SIGTERM/SIGINT request a stop; the loop saves the
        # full resume state at the next step boundary and returns. Signal
        # handlers can be set only on the main thread; elsewhere the loop
        # runs unguarded.
        prev_handlers = {}
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[sig] = signal.signal(sig, self.request_stop)
        except ValueError:
            for sig, h in prev_handlers.items():
                signal.signal(sig, h)
            prev_handlers = {}
        try:
            return self._train_loop()
        finally:
            for sig, h in prev_handlers.items():
                signal.signal(sig, h)

    def _train_loop(self) -> TrainState:
        from ..utils.profiling import StepTimer
        from .sharding import (background_batches, prefetch_shard,
                               shard_batch)
        device = next(self.state.model.parameters()).device
        losses = collections.deque(maxlen=10)
        self.step_timer = StepTimer(device)
        watch_active = self._watch_active()
        for epoch in range(self.config.max_epochs):
            t0 = time.time()
            # Host assembly on a background thread; the device copy of the
            # next batch is issued before the current step runs.
            for batch in prefetch_shard(
                    background_batches(self.batches(epoch)),
                    lambda b: shard_batch(b, device)):
                watching = (watch_active and self.config.watch_every
                            and self.state.step % self.config.watch_every
                            == 0)
                if watching:
                    watch_grads = self.watch_grad_fn(batch)
                    watch_params = {n: p.detach().clone() for n, p in
                                    self.state.model.named_parameters()}
                with self.step_timer:
                    loss = self.train_step(self.state, batch)
                losses.append(loss)
                if self._wandb:
                    self._wandb.log({"loss": float(loss)})
                    if watching:
                        self._log_watch(watch_params, watch_grads)
                if self._stop_requested:
                    self._save_resume_state()
                    logger.warning(
                        "stop requested; resume state saved at step %d",
                        self.state.step)
                    return self._finalize(losses)
            dur = time.time() - t0
            logger.debug("Epoch %d done in %.1fs", epoch, dur)
            if self._wandb:
                self._wandb.log({"training_duration": dur})
            if epoch % self.config.save_every == 0 and self.checkpoint_dir:
                self._save_epoch(epoch)
        return self._finalize(losses)

    def _watch_active(self) -> bool:
        """Whether the watch pass runs. The same on every rank: wandb on
        any rank turns it on everywhere, since the pass is a forward and
        backward that every rank must run alike."""
        import torch.distributed as dist

        from .sharding import process_count
        active = bool(self._wandb and self.watch_grad_fn)
        if self.watch_grad_fn is not None and process_count() > 1:
            device = next(self.state.model.parameters()).device
            flag = torch.tensor([int(bool(self._wandb))], device=device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            active = bool(flag.item())
        return active

    def _host_state(self) -> Optional[Dict[str, Any]]:
        """Host copies of the full resume state on rank 0, None elsewhere.
        Every rank of a model sharded over a model axis takes part: the
        state is gathered over the axis."""
        from ..utils.checkpoint import to_host
        from .sharding import process_index
        if process_index() != 0 and self.state.model.tp is None:
            return None
        full = self.state.state_dict(self.data_rng)
        return to_host(full) if process_index() == 0 else None

    def _save_epoch(self, epoch: int) -> None:
        """Rank 0 writes ``model_<epoch>.pt`` (the reference layout) and
        ``state_latest.pt``, both unsharded."""
        from ..utils.checkpoint import save_checkpoint, save_dt_reference
        # Host copies now: the next step must not change a queued save.
        full = self._host_state()
        if full is None:
            return
        cfg = self.state.model.cfg
        model_path = os.path.join(self.checkpoint_dir,
                                  MODEL_FILE.format(epoch=epoch))
        state_path = os.path.join(self.checkpoint_dir, STATE_FILE)
        weights = full["model"]
        if self._saver:
            self._saver.defer(save_dt_reference, model_path, weights, cfg)
            self._saver.submit(state_path, full)
            if self.keep_last is not None:
                # Behind this epoch's saves on the same worker, so it only
                # sees written checkpoints.
                self._saver.defer(self._gc_checkpoints)
        else:
            save_dt_reference(model_path, weights, cfg)
            save_checkpoint(state_path, full)
            if self.keep_last is not None:
                self._gc_checkpoints()

    def _gc_checkpoints(self) -> None:
        """Delete the model_<epoch>.pt files beyond the newest
        ``keep_last`` (numeric order; state_latest.pt untouched)."""
        pat = re.compile(r"model_(\d+)\.pt")
        found = sorted((int(m.group(1)), name)
                       for name in os.listdir(self.checkpoint_dir)
                       if (m := pat.fullmatch(name)))
        for _, name in found[:-self.keep_last]:
            os.remove(os.path.join(self.checkpoint_dir, name))

    def _log_watch(self, params, grads) -> None:
        """Parameter and gradient histograms under wandb.watch's names
        (``parameters/...``, ``gradients/...``)."""
        payload = {}
        for prefix, tree in (("parameters", params), ("gradients", grads)):
            for name, t in tree.items():
                payload[f"{prefix}/{name}"] = self._wandb.Histogram(
                    t.detach().float().cpu().numpy().ravel())
        self._wandb.log(payload)

    def _finalize(self, losses) -> TrainState:
        """The common exit (completion and stop): wait for queued saves
        (re-raising a failed one), finish wandb, keep the last losses, log
        the step timing."""
        if self._saver:
            self._saver.close()
        if self._wandb:
            self._wandb.finish()
        self.last_losses = [float(l) for l in losses]
        logger.info("step timing: %s", self.step_timer.summary())
        return self.state

    def _save_resume_state(self) -> None:
        if not self.checkpoint_dir:
            return
        full = self._host_state()
        if full is not None:
            from ..utils.checkpoint import save_checkpoint
            if self._saver:
                # Queued epoch saves first: a stale queued state_latest
                # must not land after this fresher one.
                self._saver.wait()
            save_checkpoint(os.path.join(self.checkpoint_dir, STATE_FILE),
                            full)
