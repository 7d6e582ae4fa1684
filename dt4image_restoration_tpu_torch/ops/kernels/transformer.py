"""K3: the Decision Transformer's block stack and final LayerNorm in one
launch (``csrc/dt_decode.cu``).

Replaces the TPU kernel ``fused_dt_decode``
(``dt4image_restoration_tpu/ops/pallas/transformer.py``). One thread block
runs one sequence through every pre-LN block (causal attention with a
residual; LN -> fc -> exact GELU -> proj, which replaces the stream, as the
reference does) and the final LayerNorm, with all activations in shared
memory and the ~3.9 MB of float32 weights read through L2. On the H100 the
policy's batch (63 sequences of 12 or 18 tokens) is too small to fill the
card, so the launch is latency bound; see the source for the details.

:func:`fused_dt_decode_plain` is the plain PyTorch version of the same
stack on the same packed weights.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Mapping

import torch
import torch.nn.functional as F

from . import _build
from .layernorm import layernorm_plain

__all__ = ["PACK_KEYS", "fused_dt_decode", "fused_dt_decode_plain",
           "pack_dt_weights"]

launches = 0  # kernel launches since the last reset

MAX_TOKENS = 32
PACK_KEYS = ("ln1_s", "ln1_b", "qkv_w", "qkv_b", "o_w", "o_b", "ln2_s",
             "ln2_b", "fc_w", "fc_b", "proj_w", "proj_b", "lnf_s", "lnf_b")


def pack_dt_weights(state: Mapping[str, torch.Tensor], n_blocks: int
                    ) -> Dict[str, torch.Tensor]:
    """Stack the port DT's per-block weights along a leading block axis, in
    the kernel's layout: Linear weights as (in, out), row-major.

    ``state`` is the port ``DecisionTransformer``'s ``state_dict`` (keys
    ``blocks.{i}.ln1.weight``, ``blocks.{i}.attn.qkv_proj.weight``, ...).
    """
    def stack(name, transpose=False):
        ts = [state[f"blocks.{i}.{name}"] for i in range(n_blocks)]
        if transpose:
            ts = [t.t() for t in ts]
        return torch.stack(ts).contiguous()

    return {
        "ln1_s": stack("ln1.weight"), "ln1_b": stack("ln1.bias"),
        "qkv_w": stack("attn.qkv_proj.weight", True),
        "qkv_b": stack("attn.qkv_proj.bias"),
        "o_w": stack("attn.o_proj.weight", True),
        "o_b": stack("attn.o_proj.bias"),
        "ln2_s": stack("ln2.weight"), "ln2_b": stack("ln2.bias"),
        "fc_w": stack("fc.weight", True), "fc_b": stack("fc.bias"),
        "proj_w": stack("fc_proj.weight", True),
        "proj_b": stack("fc_proj.bias"),
        "lnf_s": state["layer_n.weight"].contiguous(),
        "lnf_b": state["layer_n.bias"].contiguous(),
    }


def fused_dt_decode_plain(tokens: torch.Tensor,
                          packed: Mapping[str, torch.Tensor],
                          n_blocks: int = 5, n_heads: int = 4
                          ) -> torch.Tensor:
    """Plain PyTorch version of the stack: (B, T, E) -> (B, T, E)."""
    x = tokens
    b, t, e = x.shape
    d = e // n_heads
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    for i in range(n_blocks):
        h = layernorm_plain(x, packed["ln1_s"][i], packed["ln1_b"][i])
        qkv = h @ packed["qkv_w"][i] + packed["qkv_b"][i]
        q, k, v = (a.reshape(b, t, n_heads, d).transpose(1, 2)
                   for a in qkv.split(e, dim=-1))
        s = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(d))
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        att = (p @ v).transpose(1, 2).reshape(b, t, e)
        x = x + att @ packed["o_w"][i] + packed["o_b"][i]
        # The MLP output replaces the stream (no residual), as in the
        # reference model.
        h = layernorm_plain(x, packed["ln2_s"][i], packed["ln2_b"][i])
        h = F.gelu(h @ packed["fc_w"][i] + packed["fc_b"][i])
        x = h @ packed["proj_w"][i] + packed["proj_b"][i]
    return layernorm_plain(x, packed["lnf_s"], packed["lnf_b"])


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("dt_decode")
    fn = lib.dt_decode_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p] * (len(PACK_KEYS) + 1)
    fn.restype = ctypes.c_int
    return fn


def fused_dt_decode(tokens: torch.Tensor, packed: Mapping[str, torch.Tensor],
                    n_blocks: int = 5, n_heads: int = 4) -> torch.Tensor:
    """Run the full block stack + final LN on (B, T, E) float32 tokens."""
    global launches
    if tokens.device.type == "cpu":
        return fused_dt_decode_plain(tokens, packed, n_blocks, n_heads)
    if tokens.device.type != "cuda":
        raise ValueError(f"unsupported device {tokens.device}")
    if tokens.dtype != torch.float32 or tokens.ndim != 3:
        raise TypeError("tokens must be (B, T, E) float32")
    b, t, e = tokens.shape
    if not 1 <= t <= MAX_TOKENS or e % 4 or e % n_heads:
        raise ValueError(f"dt_decode kernel takes 1 <= T <= {MAX_TOKENS} and "
                         f"E divisible by 4 and by n_heads; got T={t}, E={e}, "
                         f"n_heads={n_heads}")
    if not tokens.is_contiguous():
        raise ValueError("tokens must be contiguous")
    shapes = {"ln1_s": (n_blocks, e), "ln1_b": (n_blocks, e),
              "qkv_w": (n_blocks, e, 3 * e), "qkv_b": (n_blocks, 3 * e),
              "o_w": (n_blocks, e, e), "o_b": (n_blocks, e),
              "ln2_s": (n_blocks, e), "ln2_b": (n_blocks, e),
              "fc_w": (n_blocks, e, 4 * e), "fc_b": (n_blocks, 4 * e),
              "proj_w": (n_blocks, 4 * e, e), "proj_b": (n_blocks, e),
              "lnf_s": (e,), "lnf_b": (e,)}
    for k in PACK_KEYS:
        w = packed[k]
        if tuple(w.shape) != shapes[k] or w.dtype != torch.float32 \
                or w.device != tokens.device or not w.is_contiguous():
            raise ValueError(
                f"packed[{k!r}] must be a contiguous float32 {shapes[k]} on "
                f"{tokens.device}; got {w.dtype} {tuple(w.shape)} on "
                f"{w.device}")
    out = torch.empty_like(tokens)
    if b == 0:
        return out
    fn = _lib()
    with torch.cuda.device(tokens.device):
        rc = fn(tokens.data_ptr(), out.data_ptr(), b, t, e, n_heads, n_blocks,
                *(packed[k].data_ptr() for k in PACK_KEYS),
                _build.stream_handle(tokens.device))
    _build.check(rc, "dt_decode")
    launches += 1
    return out
