"""The DT4IR residual U-Net prior, ``unet-nm.pt`` (``noise.py:101-164``):
base 32, depth 4, bilinear upsampling, the sigma noise-map channel.

Its weights, reference and counts are the harness's own
(:func:`portbench.weights.unet_state_dict`,
:func:`portbench.reference.model.denoise`, :mod:`portbench.counts`); the
system is the port's ``UNetDenoiser`` in the configuration's
``unet_mode``, loaded through the port's converter.
"""
import torch

from portbench.counts import unet_bytes as bytes  # noqa: A001
from portbench.counts import unet_flops as flops
from portbench.reference.model import denoise as reference
from portbench.weights import unet_state_dict as state_dict

__all__ = ["bytes", "flops", "reference", "state_dict", "system"]


def system(cfg, sd, device):
    """The port's U-Net on ``sd`` (``noise.py``'s layout), frozen."""
    from dt4image_restoration_tpu_torch.models.unet import UNetDenoiser
    from dt4image_restoration_tpu_torch.utils.convert import (
        load_strict, unet_from_reference)
    if cfg["depth"] != 4 or cfg["in_channels"] != 2 \
            or cfg["out_channels"] != 1:
        raise ValueError("the port's U-Net has depth 4 and 2 in / 1 out")
    with torch.device(device):
        den = UNetDenoiser(base_channels=cfg["base_channels"],
                           dtype=cfg["dtype"], packed=cfg["unet_mode"])
    load_strict(den, unet_from_reference(sd), "U-Net weights")
    return den.eval().requires_grad_(False)
