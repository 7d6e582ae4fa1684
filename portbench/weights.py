"""Random weights of a configuration, in the reference checkpoints' key
layouts, made on the device from the run's seed.

Each state dict comes from one ``randn`` call of a generator on the device
(a few large calls, not one per leaf), in the distributions of the
reference restatements: the Decision Transformer's leaves N(0, 0.05) with
LayerNorm scales 1 + N(0, 0.05). The stop output's bias is set to
``stop_bias`` so that every episode runs its full length. The prior's
weights come from its module's ``state_dict`` (``priors/<prior>.py``),
drawn after the policy's; the DT4IR U-Net's (:func:`unet_state_dict`) are
He-scaled convs, the 1x1 head damped tenfold, biases N(0, 0.01), so that
the random prior is near-contractive like a trained one.
"""
from __future__ import annotations

from types import ModuleType
from typing import Dict, List, Tuple

import torch

from .reference.episode import MODE_COLS

UNET_CHANNELS = (1, 2, 4, 8, 16)   # times the base width, per level


def _draw(leaves: List[Tuple[str, tuple]], gen: torch.Generator, device
          ) -> Dict[str, torch.Tensor]:
    """Standard normal leaves of the given shapes, from one draw."""
    sizes = [int(torch.Size(shape).numel()) for _, shape in leaves]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    return {name: part.reshape(shape) for (name, shape), part in
            zip(leaves, flat.split(sizes))}


def state_conv_hw(image_size: int) -> int:
    h = (image_size - 8) // 4 + 1
    h = (h - 4) // 2 + 1
    return h - 2


def dt_state_dict(cfg: Dict, gen: torch.Generator, device
                  ) -> Dict[str, torch.Tensor]:
    """The policy in ``decision_transformer.py``'s layout."""
    e, a = cfg["embed_dim"], cfg["action_dim"]
    hw = state_conv_hw(cfg["image_size"])
    leaves = [("time_embed.weight", (cfg["max_timestep"], e)),
              ("task_embed.weight", (cfg["n_embeds"], e))]

    def lin(name, n_in, n_out):
        leaves.extend([(name + ".weight", (n_out, n_in)),
                       (name + ".bias", (n_out,))])

    lin("embed_action.0", a, e)
    lin("embed_return.0", 1, e)
    for i, shape in ((0, (8, 1, 8, 8)), (2, (16, 8, 4, 4)),
                     (4, (16, 16, 3, 3))):
        leaves.extend([(f"state_encoder.{i}.weight", shape),
                       (f"state_encoder.{i}.bias", (shape[0],))])
    lin("state_encoder.7", 16 * hw * hw, e)
    for i in range(cfg["n_blocks"]):
        p = f"transformer.{i}."
        for ln in ("ln1", "ln2"):
            leaves.extend([(p + ln + ".weight", (e,)),
                           (p + ln + ".bias", (e,))])
        lin(p + "c_att.qkv_proj", e, 3 * e)
        lin(p + "c_att.o_proj", e, e)
        lin(p + "mlp.fc", e, cfg["mlp_ratio"] * e)
        lin(p + "mlp.fc_proj", cfg["mlp_ratio"] * e, e)
    leaves.extend([("layer_n.weight", (e,)), ("layer_n.bias", (e,))])
    lin("predict_action.0", e, a)
    lin("predict_rtg", e, 1)

    sd = _draw(leaves, gen, device)
    for name in sd:
        sd[name].mul_(0.05)
        if name.endswith(("ln1.weight", "ln2.weight")) \
                or name == "layer_n.weight":
            sd[name].add_(1.0)
    stop = MODE_COLS[cfg["mode"]].index("T")
    sd["predict_action.0.bias"][stop] = float(cfg["stop_bias"])
    return sd


def unet_state_dict(cfg: Dict, gen: torch.Generator, device
                    ) -> Dict[str, torch.Tensor]:
    """The prior in ``noise.py``'s layout (``unet-nm.pt``)."""
    c = [cfg["base_channels"] * m for m in UNET_CHANNELS]
    convs: List[Tuple[str, int, int, int]] = []

    def block(prefix, c_in, c_out):
        chans = (c_in, c_out, c_out, c_out)
        convs.extend((f"{prefix}.conv-{i}.conv2d", chans[i + 1], chans[i], 3)
                     for i in range(3))

    block("inc.conv", cfg["in_channels"], c[0])
    for k in range(1, 5):
        block(f"down{k}.mpconv.1", c[k - 1], c[k])
    for k in range(1, 5):
        block(f"up{k}.conv", c[4 - k] + c[5 - k], c[4 - k])
    convs.append(("outc.conv", cfg["out_channels"], c[0], 1))

    leaves = []
    for name, c_out, c_in, k in convs:
        leaves.extend([(name + ".weight", (c_out, c_in, k, k)),
                       (name + ".bias", (c_out,))])
    sd = _draw(leaves, gen, device)
    for name, c_out, c_in, k in convs:
        gain = 0.1 if name == "outc.conv" else 1.0
        sd[name + ".weight"].mul_(gain * (2.0 / (c_in * k * k)) ** 0.5)
        sd[name + ".bias"].mul_(0.01)
    return sd


def make_weights(cfg: Dict, seed: int, device, prior: ModuleType
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(policy, prior) state dicts of ``cfg`` from ``seed``; the prior's
    from its module's ``state_dict``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dt_sd = dt_state_dict(cfg, gen, device)
    return dt_sd, prior.state_dict(cfg, gen, device)
