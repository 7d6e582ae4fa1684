"""K3: the Decision Transformer's block stack and final LayerNorm in one
launch (``csrc/dt_decode.cu``).

Replaces the TPU kernel ``fused_dt_decode``
(``dt4image_restoration_tpu/ops/pallas/transformer.py``). A cluster of four
thread blocks runs a group of sequences through every pre-LN block (causal
attention with a residual; LN -> fc -> exact GELU -> proj, which replaces
the stream, as the reference does) and the final LayerNorm. Block r of a
cluster computes attention head r and a quarter of the output features of
every projection, on the tensor cores as 3xTF32 ``mma.sync`` products, and
shares its slice with the other three through distributed shared memory.
:func:`pack_dt_fragments` lays each block's quarter of the weights out in
the order the kernel streams them. Each cluster takes
:func:`sequences_per_cluster` sequences, enough that the batch fits one
wave of the clusters the card runs at once (:func:`clusters_at_once`); see
the source for the details.

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

__all__ = ["PACK_KEYS", "clusters_at_once", "fused_dt_decode",
           "fused_dt_decode_plain", "pack_dt_fragments", "pack_dt_weights",
           "sequences_per_cluster"]

launches = 0  # kernel launches since the last reset

MAX_TOKENS = 32
CLUSTER = 4              # thread blocks per cluster, one per head
WIDTHS = (64, 128)       # embedding widths the kernel is built for
MAX_CLUSTER_TOKENS = 56  # S T per cluster: shared memory
CLUSTER_DOES_NOT_FIT = -1  # dt_decode_launch's code for that refusal
PACK_KEYS = ("ln1_s", "ln1_b", "qkv_w", "qkv_b", "o_w", "o_b", "ln2_s",
             "ln2_b", "fc_w", "fc_b", "proj_w", "proj_b", "lnf_s", "lnf_b")
# The vectors the kernel reads as they are, in its argument order.
_VECTOR_KEYS = ("ln1_s", "ln1_b", "qkv_b", "o_b", "ln2_s", "ln2_b", "fc_b",
                "proj_b", "lnf_s", "lnf_b")


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


def _a_fragments(w: torch.Tensor) -> torch.Tensor:
    """(n_blocks, K, N) (in, out) weights -> (n_blocks, K N) in mma.sync A
    fragment order: per k8 step and m16 tile of output features, lane
    ``4g + t`` holds ``A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]`` of
    ``A = w^T``."""
    nb, k, n = w.shape
    # (block, k step, k half, t, m tile, m half, g) -> (.., ks, mt, g, t,
    # k half, m half)
    x = w.reshape(nb, k // 8, 2, 4, n // 16, 2, 8).permute(0, 1, 4, 6, 3, 2, 5)
    return x.reshape(nb, k * n)


def _rank_columns(e: int, r: int) -> torch.Tensor:
    """Block r's q, k and v columns of Wqkv: head r of each."""
    q = e // CLUSTER
    return torch.cat([torch.arange(i * e + r * q, i * e + (r + 1) * q)
                      for i in range(3)])


def pack_dt_fragments(packed: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The kernel's weights: (CLUSTER, n_blocks, 3 E^2) float32, unsplit.

    For block r of a cluster and each DT block, in the order the kernel
    streams them, the A fragments (:func:`_a_fragments`) of its quarter of
    the four products: head r's q, k and v columns of ``qkv_w``, and the
    r-th quarter of the output columns of ``o_w``, ``fc_w`` and ``proj_w``.
    """
    e = packed["qkv_w"].shape[1]
    q = e // CLUSTER
    with torch.no_grad():
        ranks = []
        for r in range(CLUSTER):
            cols = _rank_columns(e, r).to(packed["qkv_w"].device)
            ranks.append(torch.cat([
                _a_fragments(packed["qkv_w"][:, :, cols]),
                _a_fragments(packed["o_w"][:, :, r * q:(r + 1) * q]),
                _a_fragments(packed["fc_w"][:, :, r * e:(r + 1) * e]),
                _a_fragments(packed["proj_w"][:, :, r * q:(r + 1) * q]),
            ], dim=1))
        return torch.stack(ranks).contiguous()


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
    lib.dt_decode_launch.argtypes = [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p] * (len(_VECTOR_KEYS) + 1)
    lib.dt_decode_launch.restype = ctypes.c_int
    lib.dt_decode_clusters_at_once.argtypes = [ctypes.c_int]
    lib.dt_decode_clusters_at_once.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def clusters_at_once(e: int) -> int:
    """How many of the kernel's clusters the card runs at once at width E
    (``cudaOccupancyMaxActiveClusters``); raises if not even one fits."""
    n = _lib().dt_decode_clusters_at_once(e)
    if n < 0:
        _build.check(-n, "dt_decode occupancy")
    if n == 0:
        raise RuntimeError(f"dt_decode: a cluster of {CLUSTER} blocks with "
                           "their shared memory does not fit on this card")
    return n


def sequences_per_cluster(b: int, t: int, clusters: int) -> int:
    """S: enough sequences per cluster that B of them fit one wave of
    ``clusters`` clusters, as long as S T tokens fit a cluster's shared
    memory."""
    return max(1, min(-(-b // clusters), MAX_CLUSTER_TOKENS // t))


def fused_dt_decode(tokens: torch.Tensor, packed: Mapping[str, torch.Tensor],
                    n_blocks: int = 5, n_heads: int = 4) -> torch.Tensor:
    """Run the full block stack + final LN on (B, T, E) float32 tokens.

    On the card the kernel reads ``packed["tc_w"]``
    (:func:`pack_dt_fragments`, which ``DecisionTransformer.packed_weights``
    keeps); where that key is missing it is packed for this call."""
    if tokens.device.type == "cpu":
        return fused_dt_decode_plain(tokens, packed, n_blocks, n_heads)
    if tokens.device.type != "cuda":
        raise ValueError(f"unsupported device {tokens.device}")
    if tokens.dtype != torch.float32 or tokens.ndim != 3:
        raise TypeError("tokens must be (B, T, E) float32")
    b, t, e = tokens.shape
    if not 1 <= t <= MAX_TOKENS or e not in WIDTHS or n_heads != CLUSTER:
        raise ValueError(f"dt_decode kernel takes 1 <= T <= {MAX_TOKENS}, "
                         f"E in {WIDTHS} and n_heads={CLUSTER}; got T={t}, "
                         f"E={e}, n_heads={n_heads}")
    if not tokens.is_contiguous():
        raise ValueError("tokens must be contiguous")
    shapes = {"ln1_s": (n_blocks, e), "ln1_b": (n_blocks, e),
              "qkv_w": (n_blocks, e, 3 * e), "qkv_b": (n_blocks, 3 * e),
              "o_w": (n_blocks, e, e), "o_b": (n_blocks, e),
              "ln2_s": (n_blocks, e), "ln2_b": (n_blocks, e),
              "fc_w": (n_blocks, e, 4 * e), "fc_b": (n_blocks, 4 * e),
              "proj_w": (n_blocks, 4 * e, e), "proj_b": (n_blocks, e),
              "lnf_s": (e,), "lnf_b": (e,),
              "tc_w": (CLUSTER, n_blocks, 3 * e * e)}
    arrays = dict(packed)
    if "tc_w" not in arrays:
        arrays["tc_w"] = pack_dt_fragments(packed)
    for k in PACK_KEYS + ("tc_w",):
        w = arrays[k]
        if tuple(w.shape) != shapes[k] or w.dtype != torch.float32 \
                or w.device != tokens.device or not w.is_contiguous():
            raise ValueError(
                f"packed[{k!r}] must be a contiguous float32 {shapes[k]} on "
                f"{tokens.device}; got {w.dtype} {tuple(w.shape)} on "
                f"{w.device}")
    out = torch.empty_like(tokens)
    if b == 0:
        return out
    with torch.cuda.device(tokens.device):
        s = sequences_per_cluster(b, t, clusters_at_once(e))
        rc = _lib().dt_decode_launch(
            tokens.data_ptr(), out.data_ptr(), arrays["tc_w"].data_ptr(), b,
            t, e, n_heads, s, n_blocks,
            *(arrays[k].data_ptr() for k in _VECTOR_KEYS),
            _build.stream_handle(tokens.device))
    if rc == CLUSTER_DOES_NOT_FIT:
        raise RuntimeError(f"dt_decode: a cluster of {CLUSTER} blocks with "
                           "their shared memory does not fit on this card")
    _build.check(rc, "dt_decode")
    _build.count_launch(__name__)
    return out
