"""Configuration for the PyTorch/CUDA port.

The port's own copy of the JAX package's ``config.py`` tables and the
dataclasses its inference and training paths need (the port imports
nothing of the JAX package). Values are identical to the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

# Task vocabularies + RTG min-max normalisation ranges for the two published
# experiments.
FLEX_TASKS: Tuple[str, ...] = (
    "rtg_1.5", "rtg_3", "rtg_3.5", "rtg_4", "rtg_4.5", "rtg_5")
FLEX_RTG_RANGE: Tuple[float, float] = (-1.8, 5.0)

OPTIMAL_TASKS: Tuple[str, ...] = (
    "2x_5", "2x_10", "2x_15", "4x_5", "4x_10", "4x_15", "8x_5", "8x_10",
    "8x_15")
OPTIMAL_RTG_RANGE: Tuple[float, float] = (-1.08, 16.6)

# The nine default eval-set directory names ({acceleration}_{noise}), in the
# reference CLI's order.
EVAL_DIR_TOKENS: Tuple[str, ...] = (
    "4_15", "4_10", "4_5", "8_15", "8_10", "8_5", "2_15", "2_10", "2_5")

IMAGE_SIZE = 128  # CSMRI slice resolution


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Decision Transformer hyperparameters. ``block_size`` counts tokens
    (3 per timestep), so ``block_size=18`` is a 6-timestep context."""
    block_size: int = 18
    n_embeds: int = 9            # task vocabulary size (6 flex / 9 optimal)
    embed_dim: int = 128
    n_heads: int = 4
    n_blocks: int = 5
    action_dim: int = 3
    max_timestep: int = 30
    dropout: float = 0.1         # attention, attention-output and MLP sites
    embd_dropout: float = 0.1    # on the summed input embeddings
    mode: str = "norm"           # 'norm' (optimal) or 'flex'
    image_size: int = IMAGE_SIZE
    # Compute dtype of the projections and the state encoder ('float32' or
    # 'bfloat16'); parameters, LayerNorms, attention and the heads stay
    # float32. Inference only: the trainer refuses 'bfloat16' (its own
    # --dtype runs autocast).
    dtype: str = "float32"
    # The per-op forward's attention and LayerNorms run the hand-written
    # kernels K4 and K5 (ops/kernels/attention.py, layernorm.py).
    use_pallas: bool = False

    @property
    def context_length(self) -> int:
        return self.block_size // 3


def __getattr__(name: str):
    """``DENOISER_ARCHS``, the names of the plug-in priors, read from their
    registry (``utils/loaders.py:PRIORS``) at first use: the registry
    imports the models, which import this module."""
    if name == "DENOISER_ARCHS":
        from .utils.loaders import PRIORS
        return tuple(PRIORS)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@dataclasses.dataclass(frozen=True)
class DenoiserConfig:
    """U-Net plug-in prior."""
    in_channels: int = 2          # image + sigma noise map
    out_channels: int = 1
    base_channels: int = 32       # 32/64/128/256/512 pyramid
    depth: int = 4
    dtype: str = "float32"
    use_pallas: bool = False


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """PnP-ADMM environment."""
    max_episode_step: int = 30
    image_size: int = IMAGE_SIZE
    done_threshold: float = 0.5   # episode stops when action T > 0.5


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Greedy evaluator."""
    max_timesteps: int = 30
    rtg_target: float = 10.0
    eval_type: str = "norm"       # 'norm' or 'flex'
    report_every: int = 7         # images evaluated per directory


@dataclasses.dataclass(frozen=True)
class MCTSConfig:
    """PUCB tree search."""
    iterations: int = 30
    n_children: int = 5
    sigma_d_std: float = 0.2
    mu_std: float = 0.001
    max_timesteps: int = 30
    context_length: int = 6
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """Training hyperparameters (the reference's AdamW, clip, warmup and
    cosine schedule)."""
    learning_rate: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    weight_decay: float = 0.1
    grad_norm_clipping: float = 1.0
    batch_size: int = 48
    max_epochs: int = 5
    warmup_steps: int = 1250
    lr_floor_mult: float = 0.1    # cosine decay floored at 0.1x base LR
    save_every: int = 1           # checkpoint cadence (epochs)
    seed: int = 0
    checkpoint_dir: str = "checkpoints"
    log_wandb: bool = False       # gated on the WANDB_API_KEY env var
    watch_every: int = 1000       # param + grad histograms every N steps
                                  # when wandb logs; 0 disables


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout (``training/sharding.py:make_mesh``). Inference
    shards the data axis; a model axis (tensor parallelism) is not ported
    yet, so ``model_parallel`` must stay 1."""
    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class Config:
    """The whole configuration tree."""
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    denoiser: DenoiserConfig = dataclasses.field(
        default_factory=DenoiserConfig)
    env: EnvConfig = dataclasses.field(default_factory=EnvConfig)
    trainer: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    mcts: MCTSConfig = dataclasses.field(default_factory=MCTSConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


def tasks_for_experiment(training_type: str
                         ) -> Tuple[Tuple[str, ...], Tuple[float, float]]:
    """Task vocabulary and RTG range per experiment."""
    if training_type in ("flexible", "flex"):
        return FLEX_TASKS, FLEX_RTG_RANGE
    return OPTIMAL_TASKS, OPTIMAL_RTG_RANGE
