"""The plain reference the benchmark holds the port to.

A frozen, batched copy of the restatements of the published DT4IR
pipeline (the Decision Transformer, the U-Net prior and the CSMRI
PnP-ADMM environment, run as ``eval.py`` runs a greedy episode), written
against the reference's documented behaviour in plain PyTorch on state
dicts in the reference checkpoints' key layout. It imports neither JAX
nor anything of the port, and takes nothing the port computed: the
benchmark hands it the weights and records it made itself.

``precision`` selects how every convolution and dense product rounds its
operands (:mod:`.model`): ``float32`` with TF32 off is the reference;
``tf32`` and ``fp8`` are the controls that ``correct`` must refuse.
"""
from .episode import greedy_episodes, psnr_db
from .model import PRECISIONS

__all__ = ["PRECISIONS", "greedy_episodes", "psnr_db"]
