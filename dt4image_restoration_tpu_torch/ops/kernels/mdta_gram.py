"""K7: Restormer's transposed-attention map (``csrc/mdta_gram.cu``).

Replaces no TPU kernel (the JAX package has no Restormer). Per (sample,
head), the softmax over j of ``tau_h * q_i . k_j / (|q_i| |k_j|)``, the
channel rows of q and k taken over all pixels: the attention map of
Restormer's MDTA block. The kernel reads q and k once, in place in the
channels-last output of the block's depthwise conv, splits the pixels over
enough CTAs to fill the card, and sums the split's partial Grams and norms
in a second, deterministic pass; see the source for the details.

:func:`mdta_gram_plain` is the plain PyTorch version (``F.normalize``,
matmul, softmax, as ``restormer_arch.py:Attention`` writes them), which the
wrapper runs for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["WIDTHS", "mdta_gram", "mdta_gram_plain", "split"]

launches = 0  # kernel launches since the last reset

WIDTHS = (48, 96)   # head widths c the kernel is built for: Restormer's
CHUNK = 64                      # pixels a CTA takes at a time
TARGET_CTAS = 8 * 132           # first pass: about 8 CTAs on each H100 SM
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def mdta_gram_plain(qkv: torch.Tensor, temperature: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """``softmax(normalize(q) @ normalize(k)^T * tau)`` per (sample, head)
    in float32, for ``qkv`` (B, H, W, 3C) channels-last (q, k, v the three
    thirds of C, each ``heads`` groups of C / heads channels) and
    ``temperature`` (heads,): (B, heads, c, c)."""
    b, h, w, c3 = qkv.shape
    t = qkv.reshape(b, h * w, 3, heads, c3 // (3 * heads)).float()
    q = F.normalize(t[:, :, 0].permute(0, 2, 3, 1), dim=-1)
    k = F.normalize(t[:, :, 1].permute(0, 2, 3, 1), dim=-1)
    attn = (q @ k.transpose(-2, -1)) * temperature.float().reshape(-1, 1, 1)
    return attn.softmax(dim=-1)


def split(batch: int, heads: int, pixels: int):
    """``(S, ppc)``: the first pass's CTAs a (sample, head) and the pixels
    each takes (a multiple of :data:`CHUNK`), so that ``batch * heads * S``
    comes near :data:`TARGET_CTAS` with at least one chunk a CTA."""
    want = -(-TARGET_CTAS // (batch * heads))
    s = max(1, min(want, -(-pixels // CHUNK)))
    ppc = -(-pixels // s)
    ppc = -(-ppc // CHUNK) * CHUNK
    return -(-pixels // ppc), ppc


@functools.lru_cache(maxsize=None)
def _lib():
    fn = _build.load("mdta_gram").mdta_gram_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mdta_gram(qkv: torch.Tensor, temperature: torch.Tensor, heads: int
              ) -> torch.Tensor:
    """The attention map of :func:`mdta_gram_plain`, (B, heads, c, c)
    float32. On CUDA, ``qkv`` is a contiguous (B, H, W, 3C) bfloat16 or
    float32 tensor whose head width c = C / heads is one of
    :data:`WIDTHS`, and ``temperature`` (heads,) float32 on its device."""
    if not qkv.is_cuda:
        if qkv.device.type == "cpu":
            return mdta_gram_plain(qkv, temperature, heads)
        raise ValueError(f"unsupported device {qkv.device}")
    dtype = _DTYPES.get(qkv.dtype)
    if dtype is None:
        raise TypeError(f"mdta_gram takes bfloat16 or float32 qkv, got "
                        f"{qkv.dtype}")
    if qkv.ndim != 4 or qkv.shape[-1] % (3 * heads) or qkv.numel() == 0:
        raise ValueError(f"qkv must be a nonempty (B, H, W, 3C) with C a "
                         f"multiple of heads={heads}; got "
                         f"{tuple(qkv.shape)}")
    b, h, w, c3 = qkv.shape
    c = c3 // (3 * heads)
    if c not in WIDTHS:
        raise ValueError(f"mdta_gram takes head widths {WIDTHS}; got {c}")
    tau = temperature.reshape(-1)
    if tau.dtype is not torch.float32 or tau.numel() != heads \
            or not tau.is_contiguous():
        raise ValueError(f"temperature must be {heads} contiguous float32 "
                         f"values; got {tuple(temperature.shape)} "
                         f"{temperature.dtype}")
    index = qkv.get_device()
    if tau.get_device() != index:
        raise ValueError(f"temperature is on {tau.device}, qkv on "
                         f"{qkv.device}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    attn = torch.empty((b, heads, c, c), dtype=torch.float32,
                       device=qkv.device)
    s, ppc = split(b, heads, h * w)
    ws = torch.empty((b, heads, s, c * c + 2 * c), dtype=torch.float32,
                     device=qkv.device)
    with _build.on_device(index):
        rc = _lib()(qkv.data_ptr(), tau.data_ptr(), ws.data_ptr(),
                    attn.data_ptr(), dtype, b, h * w, c, heads, s, ppc,
                    _build.stream_handle(index))
    _build.check(rc, "mdta_gram")
    _build.count_launch(__name__)   # one a call, for its two passes
    return attn
