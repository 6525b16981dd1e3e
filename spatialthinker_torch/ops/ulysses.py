"""Ulysses sequence parallelism: all-to-all head <-> sequence exchange around
attention (counterpart of ``spatialthinker_tpu/ops/ulysses.py``).

Each rank of the sp group (the mesh's ``model`` axis) holds a contiguous
chunk of the sequence (rank i: positions ``[i * S / sp, (i + 1) * S / sp)``)
of q / k / v. ``gather_seq_scatter_heads`` trades it for the whole sequence
of ``H / sp`` heads (rank i: heads ``[i * H / sp, (i + 1) * H / sp)``, which
under GQA are whole kv groups); attention runs there through
``ops.attention.attention`` -- the flash kernels #1-#3 on the card -- and
``gather_heads_scatter_seq`` trades the output back. Each exchange is an
``autograd.Function`` whose backward is the inverse exchange.

The transport follows the group's backend, never a failure: NCCL moves CUDA
tensors from the card; gloo carries no CUDA tensor in its all-to-all,
point-to-point or all-gather calls, so on a gloo group a CUDA tensor is
copied through page-locked host memory (as raw bytes: gloo has no bf16
send), each such exchange an ``sp/host_copy`` span of the current recorder
(``utils/spans.py``) with its bytes counted. CPU tensors go as they are.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..utils.spans import count, span
from .attention import attention


class UlyssesSpec(NamedTuple):
    """Sequence-parallel wiring handed down into the model forward: the sp
    group (the ``model`` axis), the group of ranks holding other rows, and
    the backend ("ulysses": head exchange; "ring": KV rotation)."""

    group: dist.ProcessGroup
    batch_group: Optional[dist.ProcessGroup] = None
    backend: str = "ulysses"

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)


def staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` crosses ``group`` through host memory: a CUDA tensor on
    a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def to_host_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t`` as flat page-locked host bytes (the caller synchronizes)."""
    out = torch.empty(t.numel() * t.element_size(), dtype=torch.uint8, pin_memory=True)
    out.copy_(t.contiguous().reshape(-1).view(torch.uint8), non_blocking=True)
    return out


def from_host_bytes(buf: torch.Tensor, like: torch.Tensor, shape=None) -> torch.Tensor:
    """Host bytes back to a tensor of ``like``'s dtype and device."""
    shape = like.shape if shape is None else shape
    return buf.to(like.device, non_blocking=True).view(like.dtype).reshape(shape)


@contextmanager
def host_copy():
    """The ``sp/host_copy`` span of a staged exchange (card -> host -> card),
    which ends once the stream has copied its result back to the card."""
    with span("sp/host_copy"):
        yield
        torch.cuda.current_stream().synchronize()


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` over dim 0 (sp equal pieces)."""
    if not staged(x, group):
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out
    with host_copy():
        host = to_host_bytes(x)
        torch.cuda.current_stream().synchronize()
        recv = torch.empty_like(host)
        dist.all_to_all_single(recv, host, group=group)
        out = from_host_bytes(recv, x)
        count("bytes", 2 * host.numel())
    return out


def all_gather_seq(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """The sp group's chunks of ``x`` concatenated along ``dim`` in rank
    order (no gradient)."""
    sp = dist.get_world_size(group)
    if not staged(x, group):
        parts = [torch.empty_like(x) for _ in range(sp)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)
    with host_copy():
        host = to_host_bytes(x)
        torch.cuda.current_stream().synchronize()
        parts = [torch.empty_like(host) for _ in range(sp)]
        dist.all_gather(parts, host, group=group)
        out = torch.cat([from_host_bytes(p, x) for p in parts], dim=dim)
        count("bytes", (sp + 1) * host.numel())
    return out


def _seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    b, s, h, d = x.shape
    sp = dist.get_world_size(group)
    x = x.reshape(b, s, sp, h // sp, d).permute(2, 0, 1, 3, 4).contiguous()  # (sp, B, s, H/sp, D)
    x = _all_to_all(x, group)                                                # piece j: rank j's chunk
    return x.permute(1, 0, 2, 3, 4).reshape(b, sp * s, h // sp, d)


def _heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    b, s_full, hl, d = x.shape
    sp = dist.get_world_size(group)
    x = x.reshape(b, sp, s_full // sp, hl, d).permute(1, 0, 2, 3, 4).contiguous()  # (sp, B, s, H/sp, D)
    x = _all_to_all(x, group)                                                       # piece j: head group j
    return x.permute(1, 2, 0, 3, 4).reshape(b, s_full // sp, sp * hl, d)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_to_heads(x, group)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, ctx.group), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _heads_to_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g, ctx.group), None


def gather_seq_scatter_heads(x: torch.Tensor, group) -> torch.Tensor:
    """(B, S/sp, H, D) -> (B, S, H/sp, D)."""
    return _SeqToHeads.apply(x, group)


def gather_heads_scatter_seq(x: torch.Tensor, group) -> torch.Tensor:
    """(B, S, H/sp, D) -> (B, S/sp, H, D)."""
    return _HeadsToSeq.apply(x, group)


def ulysses_attention(
    q: torch.Tensor,  # (B, S/sp, Hq, D): this rank's chunk
    k: torch.Tensor,
    v: torch.Tensor,
    spec: UlyssesSpec,
    *,
    segment_ids: Optional[torch.Tensor] = None,  # (B, S/sp)
    causal: bool = True,
) -> torch.Tensor:
    """Sequence-parallel attention on this rank's chunk: heads are exchanged
    for sequence, full-sequence attention runs on this rank's head slice,
    the output returns to its chunk. q and kv heads must divide sp."""
    sp = spec.size
    if q.shape[2] % sp or k.shape[2] % sp:
        raise ValueError(f"q/kv heads ({q.shape[2]}, {k.shape[2]}) must divide sp={sp}")
    if segment_ids is None:
        segment_ids = torch.ones(q.shape[:2], dtype=torch.int32, device=q.device)
    seg_full = all_gather_seq(segment_ids.to(torch.int32), spec.group)
    q_full, k_full, v_full = (gather_seq_scatter_heads(t, spec.group) for t in (q, k, v))
    out = attention(q_full, k_full, v_full, segment_ids=seg_full, causal=causal)
    return gather_heads_scatter_seq(out, spec.group)


def seq_chunk(x: torch.Tensor, spec: UlyssesSpec, dim: int = 1) -> torch.Tensor:
    """This rank's chunk of the whole sequence ``x`` along ``dim``."""
    s, sp = x.shape[dim], spec.size
    if s % sp:
        raise ValueError(f"sequence {s} must divide sp={sp}")
    return x.narrow(dim, spec.rank * (s // sp), s // sp)


def pad_seq_to_multiple(x: torch.Tensor, multiple: int, dim: int = 1):
    """Pad the sequence dim with zeros to a multiple of the sp degree (the
    reference's ulysses_pad_and_slice_inputs). Returns (padded, pad_size)."""
    pad = (-x.shape[dim]) % multiple
    if pad == 0:
        return x, 0
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim), pad
