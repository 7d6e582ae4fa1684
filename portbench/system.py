"""The system under test: the port's models, evaluator and service, built
on the benchmark's weights through the port's own converters.

This module and the ``system`` function of each prior
(``priors/<prior>.py``) are all of the harness that imports the port. It
hands the port weights in the reference checkpoints' layouts (the
converters of ``utils/convert.py`` map them, as for the published ``.pt``
files) and records as the evaluation dataset and the service take them;
it reads back answers, ``stats()``, and nothing of the port's internals.
"""
from __future__ import annotations

from types import ModuleType
from typing import Callable, Dict

import torch

from .trace import unet_span


def model_config(cfg: Dict):
    """The port's ``ModelConfig`` of ``cfg`` (kernels on, as the CLI
    builds it)."""
    from dt4image_restoration_tpu_torch.config import ModelConfig
    return ModelConfig(
        block_size=cfg["block_size"], n_embeds=cfg["n_embeds"],
        embed_dim=cfg["embed_dim"], n_heads=cfg["n_heads"],
        n_blocks=cfg["n_blocks"], action_dim=cfg["action_dim"],
        max_timestep=cfg["max_timestep"], mode=cfg["mode"],
        image_size=cfg["image_size"], dtype=cfg["dtype"], use_pallas=True)


class Models:
    """The policy of ``cfg`` and its prior (``prior.system``) on
    ``device``."""

    def __init__(self, cfg: Dict, dt_sd: Dict, prior: ModuleType,
                 prior_sd: Dict, device):
        from dt4image_restoration_tpu_torch.models.decision_transformer \
            import DecisionTransformer
        from dt4image_restoration_tpu_torch.utils.convert import (
            dt_from_reference, load_strict)
        from dt4image_restoration_tpu_torch.utils.device import \
            resolve_device
        if cfg["mlp_ratio"] != 4:
            raise ValueError("the port's DT has an MLP of 4x the width")
        self.device = resolve_device(device)
        self.cfg = model_config(cfg)
        with torch.device(self.device):
            dt = DecisionTransformer(self.cfg)
        load_strict(dt, dt_from_reference(dt_sd), "DT weights")
        self.dt = dt.eval().requires_grad_(False)
        self.denoiser = prior.system(cfg, prior_sd, self.device)

    def denoise(self, spanned: bool) -> Callable:
        """The denoiser, its calls each in a ``portbench.unet`` span when
        ``spanned``."""
        if not spanned:
            return self.denoiser
        den = self.denoiser

        def denoise(x, sigma):
            with unet_span():
                return den(x, sigma)
        return denoise


def evaluator(cfg: Dict, models: Models, spanned: bool):
    from dt4image_restoration_tpu_torch.inference import Evaluator
    return Evaluator(dt=models.dt, denoise=models.denoise(spanned),
                     cfg=models.cfg, max_timesteps=cfg["max_timesteps"],
                     rtg_target=cfg["rtg_target"], device=models.device)


def service(cfg: Dict, models: Models, params: Dict, spanned: bool):
    """A ``RestorationService`` with the traffic's ``service`` params."""
    from dt4image_restoration_tpu_torch.serving import RestorationService
    return RestorationService(denoise=models.denoise(spanned),
                              dt=models.dt, max_timesteps=cfg["max_timesteps"],
                              device=models.device, **params)


def request(record: Dict, rtg: float, task: int):
    from dt4image_restoration_tpu_torch.serving import RestorationRequest
    return RestorationRequest(mat=record, rtg=rtg, task=task)
