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

Dropout at the JAX model's four sites (the summed input embeddings, the
attention probabilities, the attention output, the MLP output) runs only in
``model.train()``; every inference path runs the model in ``eval()``. Two
forwards over the same weights, as in the JAX package:

  * the per-op forward, :meth:`DecisionTransformer.forward`
    (:func:`make_dt_apply`, :func:`make_dt_embed_apply`): module by module;
    with ``cfg.use_pallas`` its LayerNorms run kernel K5
    (:mod:`..ops.kernels.layernorm`) and its attention kernel K4
    (:mod:`..ops.kernels.attention`);
  * the fused forward, :func:`make_fused_dt_apply`: the whole block stack
    and the final LayerNorm as one launch of kernel K3
    (:mod:`..ops.kernels.transformer`).

Every kernel runs its plain PyTorch version on the CPU. Training runs the
per-op forward without the kernels: K3, K4 and K5 have no backward.

Training over a mesh's model axis runs each block on one shard of its
projections (``Block.tp``/``Attention.tp``, a
``training.tensor_parallel.ModelShard`` that ``training.shard_params``
sets): this rank's heads of ``qkv_proj`` and rows of ``fc``, the matching
inputs of ``o_proj`` and ``fc_proj``. Its dropout masks are the unsharded
forward's, mask for mask: each is drawn at the full shape from the same
generator and the shard takes its slice (the attention probabilities'
heads) or all of it (after ``o_proj`` and ``fc_proj``, whose outputs are
whole on every model rank), so the generator advances alike on every
rank. Inference runs the unsharded module.

``cfg.dtype='bfloat16'`` computes at the JAX model's sites in bfloat16: the
four projections of every block (``qkv_proj``, ``o_proj``, ``fc``,
``fc_proj``) and the state encoder's convs and dense layer. Parameters,
LayerNorms (K5), attention (K4, on float32 q, k, v), the embeddings and the
heads stay float32; a block's output is its ``fc_proj`` output, so from the
second block on the residual stream is bfloat16, as in the JAX model. The
fused forward runs the state encoder in bfloat16 and the token stack in
float32 (K3), as the JAX ``make_fused_dt_apply`` does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops.kernels.attention import fused_causal_attention
from ..ops.kernels.layernorm import layernorm, layernorm_plain
from ..ops.kernels.transformer import CLUSTER as DT_KERNEL_HEADS
from ..ops.kernels.transformer import MAX_TOKENS as DT_KERNEL_MAX_TOKENS
from ..ops.kernels.transformer import WIDTHS as DT_KERNEL_WIDTHS
from ..ops.kernels.transformer import (fused_dt_decode, pack_dt_fragments,
                                       pack_dt_weights)
from .precision import compute_dtype, conv2d, linear

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


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None,
            heads: Optional[Tuple[int, slice]] = None) -> torch.Tensor:
    """Inverted dropout at rate ``p`` when ``training``, with masks drawn
    from ``generator`` (None: PyTorch's default generator). Rate 1 gives
    zeros, as Flax's ``nn.Dropout`` does. A function, not a module: outside
    training it costs the inference forwards one Python call a site.

    ``heads=(n_heads, shard)``: ``x`` (B, h, ...) holds the heads ``shard``
    of ``n_heads``; the mask is drawn for all of them and sliced, so that
    it is the unsharded mask's slice."""
    if not training or p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    if heads is None:
        keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
    else:
        n_heads, shard = heads
        full = (x.shape[0], n_heads) + tuple(x.shape[2:])
        keep = x.new_empty(full).bernoulli_(1.0 - p,
                                            generator=generator)[:, shard]
    return x * keep / (1.0 - p)


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
        self.dtype = compute_dtype(cfg.dtype)

    def forward(self, states: torch.Tensor) -> torch.Tensor:
        """(B, T, S) -> (B, T, E) in the compute dtype."""
        b, t, _ = states.shape
        s, dt = self.image_size, self.dtype
        x = states.reshape(b * t, 1, s, s)
        x = torch.relu(conv2d(self.conv0, x, dt))
        x = torch.relu(conv2d(self.conv1, x, dt))
        x = torch.relu(conv2d(self.conv2, x, dt))
        x = torch.tanh(linear(self.dense, x.reshape(b * t, -1), dt))
        return x.reshape(b, t, -1)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with torch's parameter names, in
    float32 whatever the input's dtype; kernel K5 when ``use_pallas``, else
    the plain two-pass version."""

    def __init__(self, embed_dim: int, use_pallas: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(embed_dim))
        self.bias = nn.Parameter(torch.zeros(embed_dim))
        self.use_pallas = use_pallas

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = layernorm if self.use_pallas else layernorm_plain
        return norm(x.float(), self.weight, self.bias, LN_EPS)


class Attention(nn.Module):
    """Causal multi-head attention with a fused QKV projection; kernel K4
    when ``cfg.use_pallas`` and the module is not training. Dropout on the
    attention probabilities and on the output projection. With ``tp`` set
    it computes this model rank's heads."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        e = cfg.embed_dim
        self.n_heads = cfg.n_heads
        self.use_pallas = cfg.use_pallas
        self.qkv_proj = nn.Linear(e, 3 * e)
        self.o_proj = nn.Linear(e, e)
        self.dropout = cfg.dropout
        self.dropout_generator: Optional[torch.Generator] = None
        self.dtype = compute_dtype(cfg.dtype)
        self.tp = None      # a ModelShard: this rank's heads only

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, e = x.shape
        tp = self.tp
        d = e // self.n_heads
        # Views of the (B, T, 3hD) projection, in float32; K4 reads them as
        # they are and returns the (B, h, T, D) view of a (B, T, h, D)
        # buffer, so the merge of the heads below is a view too.
        if tp is None:
            h, heads = self.n_heads, None
            qkv = linear(self.qkv_proj, x, self.dtype).float()
        else:
            shard = tp.heads(self.n_heads)
            h, heads = shard.stop - shard.start, (self.n_heads, shard)
            qkv = tp.column(x, self.qkv_proj, sections=3).float()
        q, k, v = (a.reshape(b, t, h, d).transpose(1, 2)
                   for a in qkv.split(h * d, dim=-1))
        if self.use_pallas and not self.training:
            y = fused_causal_attention(q, k, v)
        else:
            att = (q @ k.transpose(-1, -2)) / math.sqrt(d)
            causal = torch.ones(t, t, dtype=torch.bool,
                                device=x.device).tril()
            att = torch.softmax(att.masked_fill(~causal, float("-inf")),
                                dim=-1)
            y = dropout(att, self.dropout, self.training,
                        self.dropout_generator, heads) @ v
        y = y.transpose(1, 2).reshape(b, t, h * d)
        out = linear(self.o_proj, y, self.dtype) if tp is None \
            else tp.row(y, self.o_proj)
        return dropout(out, self.dropout, self.training,
                       self.dropout_generator)


class Block(nn.Module):
    """Pre-LN block: attention with a residual; the MLP output, after its
    dropout, replaces the stream (no residual), as in the reference
    model. With ``tp`` set it computes this model rank's MLP features."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        e = cfg.embed_dim
        self.ln1 = LayerNorm(e, cfg.use_pallas)
        self.attn = Attention(cfg)
        self.ln2 = LayerNorm(e, cfg.use_pallas)
        self.fc = nn.Linear(e, 4 * e)
        self.fc_proj = nn.Linear(4 * e, e)
        self.dropout = cfg.dropout
        self.dropout_generator: Optional[torch.Generator] = None
        self.dtype = compute_dtype(cfg.dtype)
        self.tp = None      # a ModelShard: this rank's MLP features only

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        if self.tp is None:
            h = F.gelu(linear(self.fc, self.ln2(x), self.dtype))
            out = linear(self.fc_proj, h, self.dtype)
        else:
            h = F.gelu(self.tp.column(self.ln2(x), self.fc))
            out = self.tp.row(h, self.fc_proj)
        return dropout(out, self.dropout, self.training,
                       self.dropout_generator)


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
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.n_blocks))
        self.layer_n = LayerNorm(e, cfg.use_pallas)
        self.predict_action = nn.Linear(e, cfg.action_dim)
        self.predict_rtg = nn.Linear(e, 1)
        self.dropout_generator: Optional[torch.Generator] = None
        self.tp = None      # the blocks' ModelShard, when they hold one
        self._packed = None
        self._packed_key = None

    def set_dropout_generator(self, generator: Optional[torch.Generator]
                              ) -> None:
        """Draw every dropout mask from ``generator`` (None: PyTorch's
        default generator), so that a trainer can save and restore the
        masks' random state."""
        for m in (self, *self.blocks, *(blk.attn for blk in self.blocks)):
            m.dropout_generator = generator

    def packed_weights(self) -> Dict[str, torch.Tensor]:
        """The block stack's weights in K3's layout (``PACK_KEYS``, and at
        the kernel's widths its fragment order ``tc_w``), repacked only
        when a parameter changed."""
        params = list(self.blocks.parameters()) \
            + list(self.layer_n.parameters())
        key = tuple((p.data_ptr(), p._version) for p in params)
        if key != self._packed_key:
            with torch.no_grad():
                sd = {k: v for k, v in self.state_dict().items()
                      if k.startswith(("blocks.", "layer_n."))}
                self._packed = pack_dt_weights(sd, self.cfg.n_blocks)
                if self.cfg.embed_dim in DT_KERNEL_WIDTHS:
                    self._packed["tc_w"] = pack_dt_fragments(self._packed)
            self._packed_key = key
        return self._packed

    def embed(self, rtg, states, timesteps, task, actions=None,
              state_embeddings=None) -> torch.Tensor:
        """The interleaved input tokens (B, n_streams * T, E)."""
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
        e = self.cfg.embed_dim
        tokens = torch.stack(streams, dim=2).reshape(b, n * t, e)
        # Each timestep's embedding on its n tokens. An expand, whose
        # backward is a plain sum, where repeat_interleave's backward adds
        # with atomics on CUDA: training steps stay bitwise repeatable.
        return tokens + time_emb.unsqueeze(2).expand(b, t, n, e).reshape(
            b, n * t, e)

    def heads(self, x: torch.Tensor, three_token: bool) -> DTOutput:
        """Action and RTG heads on the final (B, n_streams * T, E) stream."""
        n = 3 if three_token else 2
        b = x.shape[0]
        x = x.reshape(b, -1, n, self.cfg.embed_dim)
        raw_actions = torch.sigmoid(self.predict_action(x[:, :, 1]))
        pred_rtg = self.predict_rtg(x[:, :, 2]) if three_token else None
        pred_actions, action_dict = transform_actions(raw_actions,
                                                      self.cfg.mode)
        return DTOutput(pred_actions=pred_actions, pred_rtg=pred_rtg,
                        action_dict=action_dict)

    def forward(self, rtg, states, timesteps, task, actions=None,
                state_embeddings=None) -> DTOutput:
        """The per-op forward. Args: rtg (B, T, 1); states
        (B, T, image_size**2), ignored when ``state_embeddings`` (B, T, E)
        is given; timesteps (B, T) or (B, T, 1); task (B, T); actions
        (B, T, action_dim) or None for the two-token (RTG, state) mode."""
        x = dropout(self.embed(rtg, states, timesteps, task, actions,
                               state_embeddings),
                    self.cfg.embd_dropout, self.training,
                    self.dropout_generator)
        for block in self.blocks:
            x = block(x)
        return self.heads(self.layer_n(x), actions is not None)


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
    """The per-op forward: ``(rtg, states, timesteps, task, actions=None,
    state_embeddings=None) -> DTOutput``."""
    def apply(rtg, states, timesteps, task, actions=None,
              state_embeddings=None):
        return model(rtg, states, timesteps, task, actions,
                     state_embeddings=state_embeddings)
    return apply


def make_dt_embed_apply(dt_apply: Callable) -> Callable:
    """``dt_apply`` (:func:`make_dt_apply` or :func:`make_fused_dt_apply`)
    over precomputed state embeddings: ``(rtg, state_embs (B, T, E),
    timesteps, task, actions)``."""
    def apply_embed(rtg, state_embs, timesteps, task, actions=None):
        return dt_apply(rtg, None, timesteps, task, actions,
                        state_embeddings=state_embs)
    return apply_embed


def fused_forward_takes(cfg: ModelConfig) -> bool:
    """Whether kernel K3, and so :func:`make_fused_dt_apply`, takes ``cfg``
    on the card: its three-token windows (``3 * context_length`` tokens)
    within K3's ``MAX_TOKENS``, a width in its ``WIDTHS`` and 4 heads. The
    evaluator runs the per-op forward where it does not."""
    return (3 * cfg.context_length <= DT_KERNEL_MAX_TOKENS
            and cfg.embed_dim in DT_KERNEL_WIDTHS
            and cfg.n_heads == DT_KERNEL_HEADS)


def make_fused_dt_apply(model: DecisionTransformer) -> Callable:
    """The fused forward, with the signature of :func:`make_dt_apply`:
    embeddings and heads as in the per-op forward, the whole block stack
    and the final LayerNorm as one launch of kernel K3 on the weights
    :meth:`DecisionTransformer.packed_weights` keeps."""
    cfg = model.cfg

    def apply_fn(rtg, states, timesteps, task, actions=None,
                 state_embeddings=None):
        tokens = model.embed(rtg, states, timesteps, task, actions,
                             state_embeddings)
        x = fused_dt_decode(tokens.contiguous(), model.packed_weights(),
                            cfg.n_blocks, cfg.n_heads)
        return model.heads(x, actions is not None)
    return apply_fn


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
