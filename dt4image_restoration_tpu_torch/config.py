"""Configuration for the PyTorch/CUDA port.

The port's own copy of the JAX package's ``config.py`` tables and the
dataclasses its evaluation slice needs (the port imports nothing of the JAX
package). Values are identical to the JAX package's.
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
    mode: str = "norm"           # 'norm' (optimal) or 'flex'
    image_size: int = IMAGE_SIZE

    @property
    def context_length(self) -> int:
        return self.block_size // 3


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


def tasks_for_experiment(training_type: str
                         ) -> Tuple[Tuple[str, ...], Tuple[float, float]]:
    """Task vocabulary and RTG range per experiment."""
    if training_type in ("flexible", "flex"):
        return FLEX_TASKS, FLEX_RTG_RANGE
    return OPTIMAL_TASKS, OPTIMAL_RTG_RANGE
