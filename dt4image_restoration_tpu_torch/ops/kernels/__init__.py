"""Hand-written CUDA kernels of the port, one module each, with their plain
PyTorch versions. Importing this package builds nothing: a kernel is
compiled on its first CUDA call (see :mod:`._build`).

    K1 conv_block  <- ops/pallas/conv_block.py:fused_conv_block
       conv_block_bf16 (the same TPU kernel on bfloat16 operands)
    K2 kspace      <- ops/pallas/kspace.py:kspace_consistency_pallas
    K3 transformer <- ops/pallas/transformer.py:fused_dt_decode
    K4 attention   <- ops/pallas/attention.py:fused_causal_attention
    K5 layernorm   <- ops/pallas/layernorm.py:layernorm_pallas
    K6 upsample_concat (no TPU kernel: the U-Net decoder's upsampling, pad
       and skip concat, which the JAX package leaves to XLA)
    K7 mdta_gram (no TPU kernel: the JAX package has no Restormer; the
       attention map of Restormer's transposed attention)
    K8 biasfree_layernorm (no TPU kernel: Restormer's BiasFree LayerNorm)
"""
from __future__ import annotations

from typing import Dict

from . import (attention, biasfree_layernorm, conv_block, conv_block_bf16,
               kspace, layernorm, mdta_gram, transformer, upsample_concat)
from ._build import add_launches, tally_launches  # noqa: F401 (graphs)

KERNEL_MODULES = {"conv_block": conv_block,
                  "conv_block_bf16": conv_block_bf16, "kspace": kspace,
                  "dt_decode": transformer, "attention": attention,
                  "layernorm": layernorm, "upsample_concat": upsample_concat,
                  "mdta_gram": mdta_gram,
                  "biasfree_layernorm": biasfree_layernorm}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`, by
    kernel source name."""
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.launches = 0
