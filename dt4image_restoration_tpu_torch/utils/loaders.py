"""Checkpoint -> model loaders for the port's CLI, and the registry of the
plug-in priors.

The DT and prior loaders read a reference PyTorch ``.pt`` checkpoint (the
prior's in its project's layout: ``unet-nm.pt``, DPIR's DRUNet or
Restormer) and fall back to random weights from a fixed seed, with a loud
stderr warning, when the path is missing (the smoke-test mode of the JAX
package's loaders). The ARNIQA loader reads the hub checkpoint and has no
fallback: the CLI scores with the proxy instead.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from typing import Callable, Dict, Mapping

import torch

from ..config import ModelConfig
from ..models.arniqa import ARNIQA
from ..models.decision_transformer import DecisionTransformer, init_dt_params
from ..models.drunet import DRUNetDenoiser, random_drunet_state_dict
from ..models.restormer import RestormerDenoiser, random_restormer_state_dict
from ..models.unet import UNetDenoiser, random_unet_state_dict
from .convert import (arniqa_from_hub, drunet_from_reference,
                      dt_from_reference, load_strict,
                      restormer_from_reference, unet_from_reference)
from .device import resolve_device


@dataclasses.dataclass(frozen=True)
class Prior:
    """One plug-in prior: ``build(dtype, packed)``, its class at its
    published widths computing in ``dtype`` (``packed``, the U-Net's mode,
    where ``modes``); ``convert``, its project's checkpoint layout -> the
    port's state dict; ``random_state_dict(seed)``; ``checkpoint``, where
    its project keeps the file; ``what``, its name in messages."""
    build: Callable[[str, str], torch.nn.Module]
    convert: Callable[[Mapping], Dict[str, torch.Tensor]]
    random_state_dict: Callable[[int], Dict[str, torch.Tensor]]
    checkpoint: str
    what: str
    modes: bool = False


# ``--denoiser_arch``: the DT4IR U-Net, DPIR's DRUNet, Restormer (its
# gray denoiser's file name in swz30/Restormer's Denoising/).
PRIORS: Dict[str, Prior] = {
    "unet_nm": Prior(
        lambda dtype, packed: UNetDenoiser(dtype=dtype, packed=packed),
        unet_from_reference, random_unet_state_dict,
        "evaluation/pretrained/unet-nm.pt", "U-Net checkpoint", modes=True),
    "drunet": Prior(
        lambda dtype, packed: DRUNetDenoiser(dtype=dtype),
        drunet_from_reference, random_drunet_state_dict,
        "model_zoo/drunet_gray.pth", "DRUNet checkpoint"),
    "restormer": Prior(
        lambda dtype, packed: RestormerDenoiser(dtype=dtype),
        restormer_from_reference, random_restormer_state_dict,
        "Denoising/pretrained_models/gaussian_gray_denoising_blind.pth",
        "Restormer checkpoint"),
}


def _prepare(model: torch.nn.Module, device) -> torch.nn.Module:
    return model.to(device).eval().requires_grad_(False)


def load_denoiser(path: str, device="cuda", dtype: str = "float32",
                  packed: str = "pallas", seed: int = 0,
                  arch: str = "unet_nm") -> torch.nn.Module:
    """The plug-in prior ``arch`` (a key of :data:`PRIORS`) from its
    project's checkpoint, or random weights from ``seed`` when ``path``
    does not exist, computing in ``dtype``. The U-Net runs in mode
    ``packed`` (``--unet_packed``; every mode runs the same weights; the
    other priors have no modes). On the card a kernel that does not build
    or launch raises at the first call: no mode stands in for another."""
    prior = PRIORS.get(arch)
    if prior is None:
        raise ValueError(f"denoiser arch must be one of {tuple(PRIORS)}, "
                         f"got {arch!r}")
    dev = resolve_device(device)
    model = prior.build(dtype, packed)
    if os.path.exists(path):
        sd = prior.convert(torch.load(path, map_location="cpu"))
    else:
        print(f"WARNING: denoiser checkpoint {path!r} not found; using "
              "random weights (smoke-test mode)", file=sys.stderr)
        sd = prior.random_state_dict(seed)
    return _prepare(load_strict(model, sd, prior.what), dev)


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
