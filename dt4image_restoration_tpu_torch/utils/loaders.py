"""Checkpoint -> model loaders for the port's CLI.

The DT and prior loaders read a reference PyTorch ``.pt`` checkpoint (the
prior's: ``unet-nm.pt`` or DPIR's DRUNet) and fall back to random weights
from a fixed seed, with a loud stderr warning, when the path is missing
(the smoke-test mode of the JAX package's loaders). The ARNIQA loader
reads the hub checkpoint and has no fallback: the CLI scores with the
proxy instead.
"""
from __future__ import annotations

import os
import sys

import torch

from ..config import DENOISER_ARCHS, ModelConfig
from ..models.arniqa import ARNIQA
from ..models.decision_transformer import DecisionTransformer, init_dt_params
from ..models.drunet import DRUNetDenoiser, random_drunet_state_dict
from ..models.unet import UNetDenoiser, random_unet_state_dict
from .convert import (arniqa_from_hub, drunet_from_reference,
                      dt_from_reference, load_strict, unet_from_reference)
from .device import resolve_device


def _prepare(model: torch.nn.Module, device) -> torch.nn.Module:
    return model.to(device).eval().requires_grad_(False)


def load_denoiser(path: str, device="cuda", dtype: str = "float32",
                  packed: str = "pallas", seed: int = 0,
                  arch: str = "unet_nm") -> torch.nn.Module:
    """The plug-in prior ``arch`` (``DENOISER_ARCHS``) from its reference
    checkpoint (``unet-nm.pt``; DPIR's ``UNetRes`` layout for ``drunet``),
    or random weights from ``seed`` when ``path`` does not exist, computing
    in ``dtype``. The U-Net runs in mode ``packed`` (``--unet_packed``;
    every mode runs the same weights; DRUNet has no modes). On the card a
    kernel that does not build or launch raises at the first call: no mode
    stands in for another."""
    if arch not in DENOISER_ARCHS:
        raise ValueError(f"denoiser arch must be one of {DENOISER_ARCHS}, "
                         f"got {arch!r}")
    dev = resolve_device(device)
    if arch == "drunet":
        model = DRUNetDenoiser(dtype=dtype)
        convert, random_sd = drunet_from_reference, random_drunet_state_dict
        what = "DRUNet checkpoint"
    else:
        model = UNetDenoiser(dtype=dtype, packed=packed)
        convert, random_sd = unet_from_reference, random_unet_state_dict
        what = "U-Net checkpoint"
    if os.path.exists(path):
        sd = convert(torch.load(path, map_location="cpu"))
    else:
        print(f"WARNING: denoiser checkpoint {path!r} not found; using "
              "random weights (smoke-test mode)", file=sys.stderr)
        sd = random_sd(seed)
    return _prepare(load_strict(model, sd, what), dev)


def load_dt(cfg: ModelConfig, path: str, device="cuda", seed: int = 0
            ) -> DecisionTransformer:
    """A Decision Transformer from a reference ``.pt`` checkpoint, or random
    weights from ``seed`` when ``path`` does not exist; it computes in
    ``cfg.dtype``."""
    dev = resolve_device(device)
    model = DecisionTransformer(cfg)
    if os.path.exists(path):
        sd = dt_from_reference(torch.load(path, map_location="cpu"))
    else:
        print(f"WARNING: DT checkpoint {path!r} not found; using random "
              "weights (smoke-test mode)", file=sys.stderr)
        sd = init_dt_params(cfg, seed)
    return _prepare(load_strict(model, sd, "DT checkpoint"), dev)


def load_arniqa(path: str, device="cuda") -> ARNIQA:
    """ARNIQA from a hub checkpoint (torchvision ResNet-50 names under
    ``encoder.model.``), loaded strictly; the ``fc.*`` head is dropped."""
    dev = resolve_device(device)
    sd = arniqa_from_hub(torch.load(path, map_location="cpu"))
    return _prepare(load_strict(ARNIQA(), sd, "ARNIQA checkpoint"), dev)
