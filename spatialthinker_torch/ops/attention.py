"""Attention entry point of the model code (counterpart of
``spatialthinker_tpu/ops/attention.py``).

Layout is B S H D. Masking is by segment ids (B, S) int32, 0 = padding,
plus the causal constraint. Every call goes to ``flash_attention``, the
autograd function over ``flash_fwd`` / ``flash_bwd``: on a CUDA tensor those
are the hand-written kernels for any shape they take (head dims 80/128, any
lengths — the kernels mask their own ragged edge), on a CPU tensor their
plain versions. One call serves inference and training; there is no length
threshold and no fallback.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import flash_attention as fa


def attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,
    *,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    causal: bool = True,
    causal_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Grouped-query attention output with segment and causal masking.

    Segment ids default to all-ones and kv segment ids to the query's.
    ``causal_offset`` places q row 0 at that kv position (cross-length causal
    attention). The model's q/k/v are views into fused projections; the
    kernel reads dense rows, so they are made contiguous here (gradients
    flow back through that copy)."""
    b, sq, _, d = q.shape
    if sq != k.shape[1] and causal and not causal_offset:
        raise ValueError("cross-length causal attention requires causal_offset")
    if segment_ids is None:
        segment_ids = torch.ones((b, sq), dtype=torch.int32, device=q.device)
    if kv_segment_ids is None:
        kv_segment_ids = segment_ids
    return fa.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(),
        segment_ids.to(torch.int32).contiguous(), kv_segment_ids.to(torch.int32).contiguous(),
        causal=causal, scale=scale if scale is not None else d**-0.5,
        causal_offset=int(causal_offset),
    )
