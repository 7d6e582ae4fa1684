"""The DT4IR policy and prior as plain ``torch.nn.functional`` calls.

Restated from the reference's ``decision_transformer.py:106-275`` (pre-LN
blocks, no residual around the MLP, two-token inference mode, the sigma_d
rescale) and ``noise.py:101-164`` (the residual U-Net with bilinear
upsampling and the sigma noise-map channel, clamped to [0, 1]). Every
tensor is made on the device of the inputs; the sizes come from the
state dicts.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

# float32 with TF32 off; TF32 products; operands rounded to float8 e4m3
# with one scale a tensor (the per-tensor scaling an fp8 path would use).
PRECISIONS = ("float32", "tf32", "fp8")
FP8_MAX = 448.0
SIGMA_D_SCALE = 70.0 / 255.0
LN_EPS = 1e-5
UNET_BLOCKS_DOWN = ("down1", "down2", "down3", "down4")
UNET_BLOCKS_UP = ("up1", "up2", "up3", "up4")


@contextlib.contextmanager
def precision_scope(precision: str) -> Iterator[None]:
    """Set the TF32 flags that ``precision`` implies for the block, and
    restore them after it."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _round(t: torch.Tensor, precision: str) -> torch.Tensor:
    """``t`` as a product's operand under ``precision``: itself, or
    rounded to float8 e4m3 on a scale that maps its largest magnitude to
    the format's largest value."""
    if precision != "fp8":
        return t
    amax = t.detach().abs().amax()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def linear(x, sd, name, precision):
    return F.linear(_round(x, precision),
                    _round(sd[name + ".weight"], precision),
                    sd[name + ".bias"])


def conv2d(x, sd, name, precision, **kw):
    return F.conv2d(_round(x, precision),
                    _round(sd[name + ".weight"], precision),
                    sd[name + ".bias"], **kw)


def dt_forward(sd: Dict[str, torch.Tensor], rtg, states, timesteps, task,
               actions: Optional[torch.Tensor], n_heads: int,
               precision: str = "float32"
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One policy forward (decision_transformer.py:212-275).

    rtg (B, T, 1); states (B, T, S) flattened square images; timesteps
    (B, T); task (B, T); actions (B, T, A) or None for the two-token
    (RTG, state) mode. Returns (pred_actions (B, T, A) with sigma_d,
    column 1, rescaled; pred_rtg (B, T, 1) or None)."""
    b, t, s = states.shape
    side = math.isqrt(s)
    e = sd["time_embed.weight"].shape[1]
    n_blocks = len({k.split(".")[1] for k in sd
                    if k.startswith("transformer.")})
    dev = states.device

    rtg_emb = torch.tanh(linear(rtg, sd, "embed_return.0", precision))
    x = states.reshape(b * t, 1, side, side)
    x = F.relu(conv2d(x, sd, "state_encoder.0", precision, stride=4))
    x = F.relu(conv2d(x, sd, "state_encoder.2", precision, stride=2))
    x = F.relu(conv2d(x, sd, "state_encoder.4", precision, stride=1))
    state_emb = torch.tanh(linear(x.flatten(1), sd, "state_encoder.7",
                                  precision)).reshape(b, t, e)
    time_emb = sd["time_embed.weight"][timesteps.long().reshape(b, t)]
    state_emb = state_emb + sd["task_embed.weight"][task.long()]

    n = 3 if actions is not None else 2
    tok = torch.zeros(b, n * t, e, device=dev)
    tok[:, 0::n] = rtg_emb
    tok[:, 1::n] = state_emb
    if actions is not None:
        tok[:, 2::n] = torch.tanh(linear(actions, sd, "embed_action.0",
                                         precision))
    x = tok + torch.repeat_interleave(time_emb, n, dim=1)

    steps = x.shape[1]
    d = e // n_heads
    causal = torch.tril(torch.ones(steps, steps, device=dev)).bool()
    for i in range(n_blocks):
        p = f"transformer.{i}."
        h = F.layer_norm(x, (e,), sd[p + "ln1.weight"], sd[p + "ln1.bias"],
                         LN_EPS)
        q, k, v = linear(h, sd, p + "c_att.qkv_proj", precision).split(
            e, dim=2)
        q, k, v = (a.reshape(b, steps, n_heads, d).transpose(1, 2)
                   for a in (q, k, v))
        att = (_round(q, precision) @ _round(k, precision).transpose(-1, -2)
               ) / math.sqrt(d)
        att = F.softmax(att.masked_fill(~causal, float("-inf")), dim=-1)
        y = (_round(att, precision) @ _round(v, precision)).transpose(
            1, 2).reshape(b, steps, e)
        x = x + linear(y, sd, p + "c_att.o_proj", precision)
        # No residual around the MLP (decision_transformer.py:99-102).
        h = F.layer_norm(x, (e,), sd[p + "ln2.weight"], sd[p + "ln2.bias"],
                         LN_EPS)
        x = linear(F.gelu(linear(h, sd, p + "mlp.fc", precision)), sd,
                   p + "mlp.fc_proj", precision)

    x = F.layer_norm(x, (e,), sd["layer_n.weight"], sd["layer_n.bias"],
                     LN_EPS)
    pred_actions = torch.sigmoid(linear(x[:, 1::n], sd, "predict_action.0",
                                        precision))
    pred_actions = torch.cat([pred_actions[..., :1],
                              pred_actions[..., 1:2] * SIGMA_D_SCALE,
                              pred_actions[..., 2:]], dim=-1)
    pred_rtg = linear(x[:, 2::3], sd, "predict_rtg", precision) \
        if actions is not None else None
    return pred_actions, pred_rtg


def _unet_block(sd, prefix, t, precision):
    for i in range(3):
        t = F.leaky_relu(conv2d(t, sd, f"{prefix}.conv-{i}.conv2d",
                                precision, padding=1), 0.2)
    return t


def unet_forward(sd: Dict[str, torch.Tensor], x: torch.Tensor,
                 precision: str = "float32") -> torch.Tensor:
    """The residual U-Net (noise.py:119-133) on (B, 2, H, W) inputs."""
    skips = [_unet_block(sd, "inc.conv", x, precision)]
    for name in UNET_BLOCKS_DOWN:
        skips.append(_unet_block(sd, f"{name}.mpconv.1",
                                 F.max_pool2d(skips[-1], 2), precision))
    y = skips.pop()
    for name in UNET_BLOCKS_UP:
        skip = skips.pop()
        y = F.interpolate(y, scale_factor=2, mode="bilinear",
                          align_corners=True)
        y = _unet_block(sd, f"{name}.conv", torch.cat([skip, y], dim=1),
                        precision)
    residual = conv2d(y, sd, "outc.conv", precision)
    return x[:, :1] + residual


def denoise(sd: Dict[str, torch.Tensor], img: torch.Tensor,
            sigma: torch.Tensor, precision: str = "float32"
            ) -> torch.Tensor:
    """UNetDenoiser2D (noise.py:155-164): (B, 1, H, W) images and (B,)
    strengths -> the clamped U-Net output."""
    b, _, h, w = img.shape
    noise_map = sigma.reshape(b, 1, 1, 1).expand(b, 1, h, w)
    return torch.clamp(unet_forward(sd, torch.cat([img, noise_map], dim=1),
                                    precision), 0, 1)
