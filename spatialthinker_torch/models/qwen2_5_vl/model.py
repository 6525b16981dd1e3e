"""Qwen2.5-VL combined model: vision tower + multimodal merge + text decoder
(counterpart of ``spatialthinker_tpu/models/qwen2_5_vl/model.py``).

The merge scatters vision embeddings into image-token slots with a
cumulative-index gather, as the JAX package does."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from .config import Qwen25VLConfig
from .host import VisionInputs
from .text import KVCache, TextModel, forward_hidden
from .vision import VisionTower, vision_forward


class Qwen25VL(nn.Module):
    def __init__(self, cfg: Qwen25VLConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.text = TextModel(cfg.text, device, dtype)
        self.vision = VisionTower(cfg.vision, device, dtype)


def vision_to_device(vision: Optional[VisionInputs], device) -> Optional[VisionInputs]:
    """Host (numpy) vision pack -> tensors on ``device``."""
    if vision is None:
        return None
    return VisionInputs(*(torch.as_tensor(np.asarray(a), device=device) for a in vision))


def merge_multimodal_embeds(
    text_embeds: torch.Tensor,      # (B, S, E)
    vision_embeds: torch.Tensor,    # (Nv, E) packed across the batch, natural order
    image_token_mask: torch.Tensor,  # (B, S) bool
) -> torch.Tensor:
    b, s, e = text_embeds.shape
    flat_mask = image_token_mask.reshape(-1)
    idx = torch.cumsum(flat_mask.to(torch.int64), dim=0) - 1
    idx = idx.clamp(0, vision_embeds.shape[0] - 1)
    gathered = vision_embeds.index_select(0, idx).reshape(b, s, e)
    return torch.where(flat_mask.reshape(b, s, 1), gathered.to(text_embeds.dtype), text_embeds)


def embed_inputs(
    model: Qwen25VL, input_ids: torch.Tensor, vision: Optional[VisionInputs] = None
) -> torch.Tensor:
    """Token embeddings with vision embeddings merged into image-token slots."""
    embeds = model.text.embed_tokens(input_ids)
    if vision is not None:
        vision_embeds = vision_forward(model.vision, *vision)
        embeds = merge_multimodal_embeds(
            embeds, vision_embeds, input_ids == model.cfg.image_token_id
        )
    return embeds


def forward(
    model: Qwen25VL,
    input_ids: torch.Tensor,      # (B, S)
    position_ids: torch.Tensor,   # (3, B, S)
    *,
    segment_ids: Optional[torch.Tensor] = None,  # (B, S); 0 = pad
    vision: Optional[VisionInputs] = None,
    cache: Optional[KVCache] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Returns (hidden_states (B, S, E), updated cache)."""
    return forward_hidden(
        model.text,
        inputs_embeds=embed_inputs(model, input_ids, vision),
        position_ids=position_ids,
        segment_ids=segment_ids,
        cache=cache,
        kv_segment_ids=kv_segment_ids,
    )


def prefill_forward(
    model: Qwen25VL,
    input_ids: torch.Tensor,       # (B, P)
    position_ids: torch.Tensor,    # (3, B, P)
    segment_ids: torch.Tensor,     # (B, P) int32
    cache: KVCache,
    kv_segment_ids: torch.Tensor,
    vision: Optional[VisionInputs] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """Prompt prefill into ``cache``: one unchunked forward (the JAX
    package's sequence- and row-chunked modes are not ported yet)."""
    return forward(
        model, input_ids, position_ids, segment_ids=segment_ids, vision=vision,
        cache=cache, kv_segment_ids=kv_segment_ids,
    )


def fanout_rows(x: torch.Tensor, n: int, dim: int = 0) -> torch.Tensor:
    """Repeat each index along ``dim`` n times (grouped-sampling fanout: row
    i maps to rows i*n .. i*n+n-1)."""
    return x.repeat_interleave(n, dim=dim)
