"""Ring attention: sequence parallelism by rotating KV chunks around the sp
group (counterpart of ``spatialthinker_tpu/ops/ring.py``).

Each rank keeps its own sequence chunk of q / k / v (rank i: positions
``[i * S / sp, (i + 1) * S / sp)``); KV chunks (with their segment ids) pass
to rank + 1 after each rotation, and each rotation's partial attention merges
into a running (out, logsumexp) pair in fp32 -- the online-softmax identity
that lets flash attention tile over KV lets it shard over ranks. The parallel
degree is not capped by the head count, as Ulysses' is.

Built on the flash kernels (``ops/flash_attention.py``):

- forward: per rotation the (query chunk, kv chunk) relation picks skip,
  causal or full (``_chunk_mode``): the diagonal chunk runs the causal kernel
  in local coordinates, earlier chunks the non-causal one, later chunks
  contribute nothing; ``flash_fwd`` (#1) gives each live rotation's (o, lse)
  and ``_merge`` folds it in. The merge is plain fp32 torch, as the JAX
  package computes it in XLA outside any Pallas kernel.
- backward: a second cycle of rotations calls ``flash_bwd`` (the pre-pass,
  #2 and #3) per live rotation against the MERGED (out, lse) -- the flash
  backward decomposes over KV blocks against the global logsumexp, so each
  rotation's (dk, dv) contribution is exact. The (dk, dv) accumulators
  rotate on every step, so after sp rotations they are back on the owner of
  their chunk.

Causal work is skewed towards the last rank (the classic ring load skew;
zig-zag layouts would fix it and are not implemented, as in JAX). The JAX
module's ``(S / sp) % 128`` rule is a Mosaic tiling constraint; the port's
flash kernels take any non-empty chunk, so the only rule is ``S % sp``
(``ulysses.seq_chunk``). The transport follows the group's backend as in
``ulysses.py``.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import List, Optional

import torch
import torch.distributed as dist

from ..utils.spans import count
from .flash_attention import NEG_INF, flash_bwd, flash_fwd
from .ulysses import UlyssesSpec, from_host_bytes, host_copy, staged, to_host_bytes

SKIP, CAUSAL, FULL = 0, 1, 2


def _merge(o1, l1, o2, l2):
    """Online-softmax merge of two normalized partial attentions.
    o (B, S, H, D) fp32; l (B, H, S) logsumexp (NEG_INF where empty)."""
    m = torch.maximum(l1, l2)
    w1 = torch.where(l1 <= NEG_INF / 2, 0.0, torch.exp(l1 - m))
    w2 = torch.where(l2 <= NEG_INF / 2, 0.0, torch.exp(l2 - m))
    denom = w1 + w2
    safe = torch.where(denom == 0.0, 1.0, denom)
    wt1 = (w1 / safe).transpose(1, 2)[..., None]  # (B, S, H, 1)
    wt2 = (w2 / safe).transpose(1, 2)[..., None]
    o = o1.float() * wt1 + o2.float() * wt2
    l_new = torch.where(denom == 0.0, NEG_INF, m + torch.log(safe))
    return o, l_new


def _chunk_mode(idx: int, r: int, sp: int, causal: bool) -> int:
    """SKIP, CAUSAL (diagonal) or FULL for the kv chunk ``(idx - r) % sp``
    that rank ``idx`` holds at rotation ``r``."""
    if not causal:
        return FULL
    ki = (idx - r) % sp
    return CAUSAL if ki == idx else (FULL if ki < idx else SKIP)


def _rotate(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Send each tensor to rank + 1 of ``group`` and receive rank - 1's."""
    sp = dist.get_world_size(group)
    idx = dist.get_rank(group)
    dst = dist.get_global_rank(group, (idx + 1) % sp)
    src = dist.get_global_rank(group, (idx - 1) % sp)
    host = staged(tensors[0], group)
    with host_copy() if host else nullcontext():
        send = [to_host_bytes(t) if host else t.contiguous() for t in tensors]
        if host:
            torch.cuda.current_stream().synchronize()
        recv = [torch.empty_like(t) for t in send]
        ops = [dist.P2POp(dist.isend, t, dst, group) for t in send]
        ops += [dist.P2POp(dist.irecv, t, src, group) for t in recv]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if not host:
            return recv
        out = [from_host_bytes(buf, t) for buf, t in zip(recv, tensors)]
        count("bytes", 2 * sum(b.numel() for b in send))
    return out


def _ring_forward(q, k, v, seg, group, causal: bool, scale: float):
    sp, idx = dist.get_world_size(group), dist.get_rank(group)
    b, s_l, hq, d = q.shape
    out = torch.zeros((b, s_l, hq, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, hq, s_l), NEG_INF, dtype=torch.float32, device=q.device)
    k_r, v_r, seg_r = k, v, seg
    for r in range(sp):
        mode = _chunk_mode(idx, r, sp, causal)
        if mode != SKIP:  # merging a skipped rotation (o 0, lse NEG_INF) changes nothing
            o_r, l_r = flash_fwd(q, k_r, v_r, seg, seg_r, causal=mode == CAUSAL, scale=scale)
            out, lse = _merge(out, lse, o_r, l_r)
        if r < sp - 1:
            k_r, v_r, seg_r = _rotate([k_r, v_r, seg_r], group)
    return out.to(q.dtype), lse


def _ring_backward(q, k, v, seg, out, lse, do, group, causal: bool, scale: float):
    sp, idx = dist.get_world_size(group), dist.get_rank(group)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk_acc = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv_acc = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    k_r, v_r, seg_r = k, v, seg
    for r in range(sp):
        mode = _chunk_mode(idx, r, sp, causal)
        if mode != SKIP:
            dq_r, dk_r, dv_r = flash_bwd(q, k_r, v_r, seg, seg_r, out, lse, do,
                                         causal=mode == CAUSAL, scale=scale)
            dq += dq_r.float()
            dk_acc += dk_r.float()
            dv_acc += dv_r.float()
        # the kv operands are not needed after the last compute; the
        # accumulators complete the cycle back to their chunk's owner
        if r < sp - 1:
            k_r, v_r, seg_r, dk_acc, dv_acc = _rotate([k_r, v_r, seg_r, dk_acc, dv_acc], group)
        else:
            dk_acc, dv_acc = _rotate([dk_acc, dv_acc], group)
    return dq.to(q.dtype), dk_acc.to(k.dtype), dv_acc.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg, group, causal, scale):
        out, lse = _ring_forward(q, k, v, seg, group, causal, scale)
        ctx.save_for_backward(q, k, v, seg, out, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, seg, out, lse, do.contiguous(), ctx.group,
                                    ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None


def ring_attention(
    q: torch.Tensor,  # (B, S/sp, Hq, D): this rank's chunk
    k: torch.Tensor,  # (B, S/sp, Hkv, D)
    v: torch.Tensor,
    spec: UlyssesSpec,
    *,
    segment_ids: Optional[torch.Tensor] = None,  # (B, S/sp)
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Differentiable sequence-parallel attention on this rank's chunk, the
    calling convention of ``ulysses.ulysses_attention``."""
    if q.shape[1] < 1:
        raise ValueError("ring attention needs a non-empty sequence chunk")
    if segment_ids is None:
        segment_ids = torch.ones(q.shape[:2], dtype=torch.int32, device=q.device)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _RingAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                segment_ids.to(torch.int32).contiguous(), spec.group,
                                bool(causal), float(scale))
