"""Compute dtypes of the inference models.

The models keep float32 parameters and compute the layers the JAX package
runs in ``dtype`` (``--dtype bfloat16``, the reference's autocast policy)
on copies of their weights in that dtype. :func:`cast_params` makes each
copy once and keeps it beside the layer until a parameter changes, so a
bfloat16 forward adds no cast of a weight per call.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """``'float32'``/``'bfloat16'`` (or the torch dtype) -> the torch
    dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype not in COMPUTE_DTYPES.values():
            raise ValueError(f"compute dtype must be float32 or bfloat16, "
                             f"got {dtype}")
        return dtype
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype must be one of "
                         f"{sorted(COMPUTE_DTYPES)}, got {dtype!r}")
    return COMPUTE_DTYPES[dtype]


def cast_params(layer: nn.Module, dtype: torch.dtype
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(weight, bias)`` of a Linear, Conv2d or ConvTranspose2d in
    ``dtype`` (in the weight's memory format): the
    parameters themselves in their own dtype, else copies (without grad)
    remade only when a parameter changed (in place, by reassignment or by a
    move to another device)."""
    w, b = layer.weight, layer.bias
    if w.dtype == dtype:
        return w, b
    key = (dtype, w.data_ptr(), w._version,
           None if b is None else (b.data_ptr(), b._version))
    cache = getattr(layer, "_cast_cache", None)
    if cache is None or cache[0] != key:
        with torch.no_grad():
            cache = (key, w.to(dtype), None if b is None else b.to(dtype))
        layer._cast_cache = cache
    return cache[1], cache[2]


def linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype
           ) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype``."""
    if dtype == torch.float32 and x.dtype == torch.float32:
        return layer(x)
    w, b = cast_params(layer, dtype)
    return F.linear(x.to(dtype), w, b)


def conv2d(layer: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype
           ) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype``."""
    if dtype == torch.float32 and x.dtype == torch.float32:
        return layer(x)
    w, b = cast_params(layer, dtype)
    return F.conv2d(x.to(dtype), w, b, layer.stride, layer.padding,
                    layer.dilation, layer.groups)


def conv_transpose2d(layer: nn.ConvTranspose2d, x: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype``."""
    if dtype == torch.float32 and x.dtype == torch.float32:
        return layer(x)
    w, b = cast_params(layer, dtype)
    return F.conv_transpose2d(x.to(dtype), w, b, layer.stride, layer.padding,
                              layer.output_padding, layer.groups,
                              layer.dilation)
