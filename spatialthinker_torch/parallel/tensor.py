"""Megatron tensor parallelism on the mesh's ``model`` axis (the port's copy
of the rule table of ``spatialthinker_tpu/parallel/sharding.py``).

The JAX package gives every leaf a ``PartitionSpec`` and lets XLA insert the
collectives. Here each rank of a ``model`` group (a TP group) holds modules
built at local widths (``models/qwen2_5_vl``: heads, kv heads, I, the vocab
shard, vision heads and I) and the model code calls the two conjugate
collectives itself:

- ``copy_to_tp``: identity forward, all-reduce backward -- at the input of
  every column-parallel product (qkv, gate_up, vision qkv / gate / up,
  merger fc1), whose input gradient is a partial sum on each rank;
- ``reduce_from_tp``: all-reduce forward, identity backward -- after every
  row-parallel product (o, down, vision proj / down, merger fc2) and the
  vocab-parallel embedding lookup. The partial sums meet in fp32.

``SPLITS`` says, for every parameter of the port's state dict (the HF
layout, ``(out, in)`` weights), which dim is split over ``model`` and in how
many fused sections that dim is laid out: gate_up is ``[gate | up]`` (2),
the vision qkv ``[q | k | v]`` (3), each section cut alike. Parameters the
JAX table gives ``P()`` on ``model`` (norms, row-parallel biases, the patch
embed, a critic's value head) are not in it: they are replicated, and their
gradients are equal on every rank of the group.

All-reduces run on the tensor's own device (gloo reduces CUDA tensors);
gathers of CUDA tensors over gloo go through host memory
(``ops.ulysses.all_gather_seq``), as the sequence exchanges do.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from ..ops.ulysses import all_gather_seq

# port parameter name (layer / block index removed) -> (split dim, fused sections)
SPLITS: Dict[str, Tuple[int, int]] = {
    "text.embed_tokens.weight": (0, 1),  # vocab x embed
    "text.lm_head.weight": (0, 1),
    # whole GQA groups: the fused rows are group-major [q heads | k | v]
    "text.layers.self_attn.qkv_proj.weight": (0, 1),
    "text.layers.self_attn.qkv_proj.bias": (0, 1),
    "text.layers.self_attn.o_proj.weight": (1, 1),
    "text.layers.mlp.gate_up_proj.weight": (0, 2),
    "text.layers.mlp.down_proj.weight": (1, 1),
    "vision.blocks.qkv.weight": (0, 3),
    "vision.blocks.qkv.bias": (0, 3),
    "vision.blocks.proj.weight": (1, 1),
    "vision.blocks.mlp.gate_proj.weight": (0, 1),
    "vision.blocks.mlp.gate_proj.bias": (0, 1),
    "vision.blocks.mlp.up_proj.weight": (0, 1),
    "vision.blocks.mlp.up_proj.bias": (0, 1),
    "vision.blocks.mlp.down_proj.weight": (1, 1),
    "vision.merger.fc1.weight": (0, 1),
    "vision.merger.fc1.bias": (0, 1),
    "vision.merger.fc2.weight": (1, 1),
}


class TPSpec:
    """One rank's TP group: the ``model`` group, its size and this rank's
    index in it. The TP-local modules hold it."""

    def __init__(self, group: dist.ProcessGroup):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)


def tp_size(tp: Optional[TPSpec]) -> int:
    return 1 if tp is None else tp.size


def split_of(name: str) -> Optional[Tuple[int, int]]:
    """(dim, sections) of a parameter split over ``model``, None if replicated."""
    return SPLITS.get(re.sub(r"\.\d+\.", ".", name))


def _piece(t: torch.Tensor, dim: int, sections: int, size: int, rank: int) -> torch.Tensor:
    n = t.shape[dim]
    if n % (sections * size):
        raise ValueError(f"a dim of {n} ({sections} sections) does not split over {size} ranks")
    v = t.unflatten(dim, (sections, n // sections))
    part = v.shape[dim + 1] // size
    return v.narrow(dim + 1, rank * part, part).flatten(dim, dim + 1)


def shard_for_rank(state: Mapping[str, torch.Tensor], size: int, rank: int) -> Dict[str, torch.Tensor]:
    """A whole state dict -> rank ``rank``'s TP shard of it (new tensors:
    the whole one can be dropped)."""
    out = {}
    for name, t in state.items():
        split = split_of(name)
        out[name] = t.clone() if split is None else _piece(t, *split, size, rank).clone()
    return out


def gather_leaf(name: str, t: torch.Tensor, tp: Optional[TPSpec]) -> torch.Tensor:
    """The whole leaf of which ``t`` is this rank's TP shard (a collective
    over the group for split leaves); ``t`` itself when replicated."""
    split = split_of(name)
    if split is None or tp_size(tp) == 1:
        return t
    dim, sections = split
    v = t.unflatten(dim, (sections, t.shape[dim] // sections))
    return all_gather_seq(v, tp.group, dim=dim + 1).flatten(dim, dim + 1)


def gather_full(state: Mapping[str, torch.Tensor], tp: Optional[TPSpec]) -> Dict[str, torch.Tensor]:
    """Every TP shard of ``state`` whole (the inverse of ``shard_for_rank``);
    every rank of the group calls it with its own shards."""
    return {name: gather_leaf(name, t, tp) for name, t in state.items()}


def _sum_fp32(x: torch.Tensor, tp: TPSpec, out_dtype=None) -> torch.Tensor:
    y = x.to(torch.float32, copy=True)
    dist.all_reduce(y, group=tp.group)
    return y.to(x.dtype if out_dtype is None else out_dtype)


def all_reduce_max(x: torch.Tensor, tp: Optional[TPSpec]) -> torch.Tensor:
    """``x`` (fp32) maxed over the group, in place; returned."""
    if tp_size(tp) > 1:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=tp.group)
    return x


def all_reduce_sum(x: torch.Tensor, tp: Optional[TPSpec]) -> torch.Tensor:
    """``x`` summed over the group, in place (no gradient); returned."""
    if tp_size(tp) > 1:
        dist.all_reduce(x, group=tp.group)
    return x


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_fp32(g, ctx.tp), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, out_dtype):
        ctx.dtype = x.dtype
        return _sum_fp32(x, tp, out_dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None


def copy_to_tp(x: torch.Tensor, tp: Optional[TPSpec]) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over the group."""
    return x if tp_size(tp) == 1 else _CopyToTP.apply(x, tp)


def reduce_from_tp(x: torch.Tensor, tp: Optional[TPSpec], out_dtype=None) -> torch.Tensor:
    """The group's partial sums of ``x`` added in fp32 (in ``out_dtype``,
    default ``x``'s); the gradient passes as it is."""
    if tp_size(tp) == 1:
        return x if out_dtype is None else x.to(out_dtype)
    return _ReduceFromTP.apply(x, tp, out_dtype)


def vocab_range(vocab: int, tp: Optional[TPSpec]) -> Tuple[int, int]:
    """[start, end) of this rank's rows of a vocab-split table."""
    n = tp_size(tp)
    if vocab % n:
        raise ValueError(f"vocab {vocab} does not split over {n} ranks")
    part = vocab // n
    r = 0 if tp is None else tp.rank
    return r * part, (r + 1) * part
