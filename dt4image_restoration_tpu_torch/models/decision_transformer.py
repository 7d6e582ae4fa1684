"""Decision Transformer over interleaved (RTG, state, action) tokens.

Counterpart of the JAX package's ``models/decision_transformer.py``, with
the same semantics:

  * conv state encoder (8x8/4 -> 4x4/2 -> 3x3/1, ReLU, dense, tanh);
  * learned time embedding repeat-interleaved across the 3 (or 2) token
    streams, learned task embedding added to the state embeddings;
  * pre-LN blocks, causal attention with a residual, but no residual around
    the MLP (a reference quirk the published checkpoints were trained
    with); LayerNorm eps 1e-5; exact-erf GELU;
  * action head (sigmoid) read at state positions, RTG head at action
    positions; two-token (RTG, state) mode when ``actions`` is None;
  * per-key action rescale whose key order differs by mode.

Inference only. The embeddings and heads are plain torch; the whole block
stack and the final LayerNorm run as one launch of kernel K3
(:mod:`..ops.kernels.transformer`, its plain version on the CPU), as the
JAX package's ``make_fused_dt_apply`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..config import ModelConfig
from ..ops.kernels.transformer import fused_dt_decode, pack_dt_weights

SIGMA_D_SCALE = 70.0 / 255.0

# Column order of the raw 3-dim action head output, per mode.
ACTION_KEYS = {
    "flex": ("mu", "sigma_d", "T"),
    "norm": ("T", "sigma_d", "mu"),
}

LN_EPS = 1e-5


def state_conv_hw(image_size: int) -> int:
    """Spatial side of the state encoder's last conv output."""
    h = (image_size - 8) // 4 + 1
    h = (h - 4) // 2 + 1
    return h - 2


@dataclasses.dataclass
class DTOutput:
    """Head outputs of one forward pass."""
    pred_actions: torch.Tensor            # (B, T, 3) rescaled actions
    pred_rtg: Optional[torch.Tensor]      # (B, T, 1); None in two-token mode
    action_dict: Dict[str, torch.Tensor]  # key -> (B, T, 1)


class StateEncoder(nn.Module):
    """Conv stack for square observations -> embed_dim (NCHW flatten)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.image_size = cfg.image_size
        hw = state_conv_hw(cfg.image_size)
        if hw < 1:
            raise ValueError(f"image_size {cfg.image_size} is too small for "
                             "the state encoder (needs >= 36)")
        self.conv0 = nn.Conv2d(1, 8, 8, stride=4)
        self.conv1 = nn.Conv2d(8, 16, 4, stride=2)
        self.conv2 = nn.Conv2d(16, 16, 3, stride=1)
        self.dense = nn.Linear(16 * hw * hw, cfg.embed_dim)

    def forward(self, states: torch.Tensor) -> torch.Tensor:
        b, t, _ = states.shape
        s = self.image_size
        x = states.reshape(b * t, 1, s, s)
        x = torch.relu(self.conv0(x))
        x = torch.relu(self.conv1(x))
        x = torch.relu(self.conv2(x))
        x = torch.tanh(self.dense(x.reshape(b * t, -1)))
        return x.reshape(b, t, -1)


class Attention(nn.Module):
    """Fused-QKV causal attention weights of one block (run by K3)."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.qkv_proj = nn.Linear(embed_dim, 3 * embed_dim)
        self.o_proj = nn.Linear(embed_dim, embed_dim)


class Block(nn.Module):
    """Weights of one pre-LN block (run by K3): ln1, attn, ln2, fc,
    fc_proj."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.attn = Attention(embed_dim)
        self.ln2 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.fc = nn.Linear(embed_dim, 4 * embed_dim)
        self.fc_proj = nn.Linear(4 * embed_dim, embed_dim)


class DecisionTransformer(nn.Module):
    """GPT over interleaved (RTG, state, action) token streams."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        e = cfg.embed_dim
        self.embed_return = nn.Linear(1, e)
        self.embed_action = nn.Linear(cfg.action_dim, e)
        self.state_encoder = StateEncoder(cfg)
        self.time_embed = nn.Embedding(cfg.max_timestep, e)
        self.task_embed = nn.Embedding(cfg.n_embeds, e)
        self.blocks = nn.ModuleList(Block(e) for _ in range(cfg.n_blocks))
        self.layer_n = nn.LayerNorm(e, eps=LN_EPS)
        self.predict_action = nn.Linear(e, cfg.action_dim)
        self.predict_rtg = nn.Linear(e, 1)
        self._packed = None
        self._packed_key = None

    def packed_weights(self) -> Dict[str, torch.Tensor]:
        """The block stack's weights in K3's layout, repacked only when a
        parameter changed."""
        params = list(self.blocks.parameters()) \
            + list(self.layer_n.parameters())
        key = tuple((p.data_ptr(), p._version) for p in params)
        if key != self._packed_key:
            with torch.no_grad():
                sd = {k: v for k, v in self.state_dict().items()
                      if k.startswith(("blocks.", "layer_n."))}
                self._packed = pack_dt_weights(sd, self.cfg.n_blocks)
            self._packed_key = key
        return self._packed

    def forward(self, rtg, states, timesteps, task, actions=None,
                state_embeddings=None) -> DTOutput:
        """Args: rtg (B, T, 1); states (B, T, image_size**2), ignored when
        ``state_embeddings`` (B, T, E) is given; timesteps (B, T) or
        (B, T, 1); task (B, T); actions (B, T, action_dim) or None for the
        two-token (RTG, state) mode."""
        cfg = self.cfg
        b, t = rtg.shape[:2]
        rtg_emb = torch.tanh(self.embed_return(rtg))
        state_emb = self.state_encoder(states) if state_embeddings is None \
            else state_embeddings
        time_emb = self.time_embed(timesteps.reshape(b, -1).long())
        state_emb = state_emb + self.task_embed(task.long())
        if actions is not None:
            streams = (rtg_emb, state_emb,
                       torch.tanh(self.embed_action(actions)))
        else:
            streams = (rtg_emb, state_emb)
        n = len(streams)
        tokens = torch.stack(streams, dim=2).reshape(b, n * t, cfg.embed_dim)
        tokens = tokens + time_emb.repeat_interleave(n, dim=1)

        x = fused_dt_decode(tokens.contiguous(), self.packed_weights(),
                            cfg.n_blocks, cfg.n_heads)

        x = x.reshape(b, t, n, cfg.embed_dim)
        raw_actions = torch.sigmoid(self.predict_action(x[:, :, 1]))
        pred_rtg = self.predict_rtg(x[:, :, 2]) if actions is not None \
            else None
        pred_actions, action_dict = transform_actions(raw_actions, cfg.mode)
        return DTOutput(pred_actions=pred_actions, pred_rtg=pred_rtg,
                        action_dict=action_dict)


def transform_actions(raw: torch.Tensor, mode: str
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-key scale of the sigmoid action output: only sigma_d is scaled
    (70/255); the concatenated output keeps the head's column order."""
    keys = ACTION_KEYS[mode]
    action_dict = {}
    for i, key in enumerate(keys):
        scale = SIGMA_D_SCALE if key == "sigma_d" else 1.0
        action_dict[key] = raw[..., i:i + 1] * scale
    out = torch.cat([action_dict[k] for k in keys], dim=-1)
    return out, action_dict


def make_dt_apply(model: DecisionTransformer) -> Callable:
    """``(rtg, states, timesteps, task, actions) -> DTOutput``."""
    def apply(rtg, states, timesteps, task, actions=None):
        return model(rtg, states, timesteps, task, actions)
    return apply


def make_dt_embed_apply(model: DecisionTransformer) -> Callable:
    """Apply over precomputed state embeddings:
    ``(rtg, state_embs (B, T, E), timesteps, task, actions)``."""
    def apply_embed(rtg, state_embs, timesteps, task, actions=None):
        return model(rtg, None, timesteps, task, actions,
                     state_embeddings=state_embs)
    return apply_embed


def make_state_encode(model: DecisionTransformer) -> Callable:
    """``states (B, S) -> (B, E)`` through the DT's state encoder."""
    def encode(states):
        return model.state_encoder(states[:, None, :])[:, 0]
    return encode


def init_dt_params(cfg: ModelConfig, seed: int = 0
                   ) -> Dict[str, torch.Tensor]:
    """Random DT weights from ``seed``: N(0, 0.02) weights and embeddings,
    zero biases, unit LayerNorm (the reference's initialisation)."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for name, t in DecisionTransformer(cfg).state_dict().items():
        if ".ln" in name or name.startswith("layer_n."):
            sd[name] = torch.ones_like(t) if name.endswith("weight") \
                else torch.zeros_like(t)
        elif name.endswith(".bias"):
            sd[name] = torch.zeros_like(t)
        else:
            sd[name] = 0.02 * torch.randn(t.shape, generator=gen)
    return sd
