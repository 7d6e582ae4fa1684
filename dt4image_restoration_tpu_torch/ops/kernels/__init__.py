"""Hand-written CUDA kernels of the port, one module each, with their plain
PyTorch versions. Importing this package builds nothing: a kernel is
compiled on its first CUDA call (see :mod:`._build`).

    K1 conv_block  <- ops/pallas/conv_block.py:fused_conv_block
    K2 kspace      <- ops/pallas/kspace.py:kspace_consistency_pallas
    K3 transformer <- ops/pallas/transformer.py:fused_dt_decode
"""
from __future__ import annotations

from typing import Dict

from . import conv_block, kspace, transformer

KERNEL_MODULES = {"conv_block": conv_block, "kspace": kspace,
                  "dt_decode": transformer}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`, by
    kernel source name."""
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.launches = 0
