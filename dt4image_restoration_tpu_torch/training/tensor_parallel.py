"""Tensor parallelism over a mesh's model axis (Megatron-style), the port's
counterpart of the JAX package's ``P(None, "model")``/``P("model", None)``
parameter shardings in ``training/sharding.py``.

JAX states the split as parameter shardings and lets GSPMD place the
collectives; the port runs one model shard per process and places them
itself, as Megatron does, with two autograd operators over the mesh's
``model_group``:

  * :func:`copy_to_model` at a tensor-parallel region's input: identity
    forward, all-reduce of the gradient backward;
  * :func:`reduce_from_model` at its output: all-reduce forward, identity
    backward.

A region is a column-split linear (this rank's output features) followed
by a row-split one (this rank's input features): ``qkv_proj`` then
``o_proj`` in attention, ``fc`` then ``fc_proj`` in the MLP
(:class:`ModelShard`'s :meth:`~ModelShard.column` and
:meth:`~ModelShard.row`). ``qkv_proj``'s output is split by heads, not in
one contiguous run: each of q, k and v gives the shard its heads' features,
so attention stays local to the shard (a contiguous cut of the fused
projection would hand shard 0 all of q and half of k). Biases are
replicated, as in JAX: a row-split linear adds its bias once, after the
all-reduce; a column-split one takes its slice of the bias through
:func:`copy_to_model`, so every rank ends with the whole bias's gradient.

:func:`shard_of` cuts a full parameter (or its Adam moments) into this
rank's shard and :func:`gather` puts the shards back on every model rank
(``sharding.shard_params``/``gather_params``, the trainer's checkpoints).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

# Parameter name suffix -> (split dim in torch's (out, in) layout, the
# number of sections the dim holds, each cut into the same n shards).
COLUMN, ROW = 0, 1
SPLITS: Dict[str, Tuple[int, int]] = {
    "attn.qkv_proj.weight": (COLUMN, 3),      # q, k, v: split by heads
    "attn.o_proj.weight": (ROW, 1),
    "fc.weight": (COLUMN, 1),
    "fc_proj.weight": (ROW, 1),
}


def split_of(name: str) -> Optional[Tuple[int, int]]:
    """``(dim, sections)`` of a parameter split over the model axis, by its
    name (a block's ``qkv_proj``/``fc`` weight by rows, its
    ``o_proj``/``fc_proj`` weight by columns), or None: replicated. The
    same holds for a tensor of the parameter's shape (its Adam moments)."""
    if not name.startswith("blocks."):
        return None
    for suffix, how in SPLITS.items():
        if name.endswith("." + suffix):
            return how
    return None


def split(t: torch.Tensor, how: Tuple[int, int], n: int, index: int
          ) -> torch.Tensor:
    """Shard ``index`` of ``n`` of ``t``: each of the ``sections`` equal
    parts of dim ``dim`` cut into ``n`` equal chunks, chunk ``index`` of
    every part, concatenated."""
    dim, sections = how
    parts = t.chunk(sections, dim)
    if any(p.shape[dim] % n for p in parts):
        raise ValueError(f"a dim of {t.shape[dim]} in {sections} sections "
                         f"does not split over {n} model shards")
    return torch.cat([p.chunk(n, dim)[index] for p in parts], dim)


def join(shards: Sequence[torch.Tensor], how: Tuple[int, int]
         ) -> torch.Tensor:
    """The inverse of :func:`split` over every shard, in shard order."""
    dim, sections = how
    cut = [s.chunk(sections, dim) for s in shards]
    return torch.cat([c[p] for p in range(sections) for c in cut], dim)


def gather(name: str, t: torch.Tensor, shard: "ModelShard") -> torch.Tensor:
    """The full parameter ``name`` (or a tensor of its shape, such as its
    Adam moments) from every model rank's shard ``t``, on every one of
    them; ``t`` itself when the parameter is replicated."""
    how = split_of(name)
    if how is None:
        return t
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(shard.size)]
    dist.all_gather(parts, t, group=shard.group)
    return join(parts, how)


def gather_state_dict(sd: Dict[str, torch.Tensor], shard: "ModelShard"
                      ) -> Dict[str, torch.Tensor]:
    """:func:`gather` of every entry of a state dict of shards."""
    return {k: gather(k, v, shard) for k, v in sd.items()}


def shard_of(name: str, t: torch.Tensor, shard: "ModelShard"
             ) -> torch.Tensor:
    """This rank's shard of the full tensor ``t`` of parameter ``name``
    (a copy), or ``t`` when the parameter is replicated."""
    how = split_of(name)
    if how is None:
        return t
    return split(t.detach(), how, shard.size, shard.index).clone()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``f``: ``x`` as it is; its gradient summed over
    ``group``."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``g``: ``x`` summed over ``group``; its gradient as it
    is."""
    return _ReduceFromModel.apply(x, group)


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """This rank's place on the model axis: the ``group`` of the model
    ranks of its data group, its ``index`` there and the group's
    ``size``. A Decision Transformer block holding one (``Block.tp``,
    ``Attention.tp``) runs its projections on this rank's shards."""
    group: Any
    index: int
    size: int

    def column(self, x: torch.Tensor, linear: torch.nn.Linear,
               sections: int = 1) -> torch.Tensor:
        """``x`` (the same on every model rank) through this rank's output
        features of a column-split ``linear`` (``sections`` as in
        :func:`split`): the region's input."""
        bias = linear.bias
        if bias is not None:
            bias = split(copy_to_model(bias, self.group), (COLUMN, sections),
                         self.size, self.index)
        return F.linear(copy_to_model(x, self.group), linear.weight, bias)

    def row(self, x: torch.Tensor, linear: torch.nn.Linear) -> torch.Tensor:
        """This rank's input features ``x`` through a row-split ``linear``:
        the partial products summed over the model ranks, then the bias,
        once: the region's output, the same on every model rank."""
        out = reduce_from_model(F.linear(x, linear.weight), self.group)
        return out if linear.bias is None else out + linear.bias

    def heads(self, n_heads: int) -> slice:
        """This rank's heads of ``n_heads``."""
        if n_heads % self.size:
            raise ValueError(f"{n_heads} heads do not split over "
                             f"{self.size} model shards")
        per = n_heads // self.size
        return slice(self.index * per, (self.index + 1) * per)
