"""Qwen2.5-VL combined model: vision tower + multimodal merge + text decoder
(counterpart of ``spatialthinker_tpu/models/qwen2_5_vl/model.py``).

The merge scatters vision embeddings into image-token slots with a
cumulative-index gather, as the JAX package does.

``tp`` (a ``parallel.tensor.TPSpec``) builds one rank's Megatron shard: every
module at its local widths (heads, kv heads, I, the vocab rows, vision heads
and I), ``cfg`` the whole model's (RoPE, m-RoPE and every check read it).
``whole_vocab`` keeps ``embed_tokens`` / ``lm_head`` whole (the rollout
copy)."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from .config import Qwen25VLConfig
from .host import VisionInputs
from ...ops.ulysses import seq_chunk
from .text import KVCache, TextModel, embed_ids, forward_hidden
from .vision import VisionTower, vision_forward


class Qwen25VL(nn.Module):
    def __init__(self, cfg: Qwen25VLConfig, device=None, dtype=None, tp=None, whole_vocab: bool = False):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        self.text = TextModel(cfg.text, device, dtype, tp, whole_vocab)
        self.vision = VisionTower(cfg.vision, device, dtype, tp)

    def forward(self, fn, *args, **kwargs):
        """``fn(self, *args, **kwargs)``: the model code is functions of the
        module (``forward`` below, the log-prob and loss functions of
        ``trainer/train_step.py``); calling one through the module
        (``model(fn, ...)``) runs it inside the module's own forward, where a
        sharded model's root parameters are gathered (FSDP's hooks,
        ``parallel/sharding.py``). On a plain module it is the same call."""
        return fn(self, *args, **kwargs)


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
    model: Qwen25VL, input_ids: torch.Tensor, vision: Optional[VisionInputs] = None,
    *, remat: Union[bool, str] = False,
) -> torch.Tensor:
    """Token embeddings with vision embeddings merged into image-token slots
    (B, S, E). Chunked prefill embeds the whole prompt once: the vision tower
    is not chunkable, images merge before the sequence is split."""
    embeds = embed_ids(model.text, input_ids)
    if vision is not None:
        vision_embeds = vision_forward(model.vision, *vision, remat=remat)
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
    remat: Union[bool, str] = False,
    int4_i8dot: bool = False,
    sp=None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Returns (hidden_states (B, S, E), updated cache). Differentiable when
    gradients are enabled and no cache is given (the training forward);
    ``remat`` checkpoints each decoder layer and vision block; ``int4_i8dot``
    picks the int8-dot decode kernel over an int4 cache.

    ``sp`` (an ``ops.ulysses.UlyssesSpec``, training forwards only): the
    whole sequence is embedded and the vision tower runs whole on every sp
    rank (as in JAX, whose vision tower takes no ``sp``); from the
    embeddings on, this rank holds its chunk of the sequence, with its
    positions and segment ids, and the hidden states returned are that
    chunk (B, S / sp, E)."""
    embeds = embed_inputs(model, input_ids, vision, remat=remat)
    if sp is not None:
        embeds, position_ids = seq_chunk(embeds, sp, 1), seq_chunk(position_ids, sp, 2)
        segment_ids = None if segment_ids is None else seq_chunk(segment_ids, sp, 1)
    return forward_hidden(
        model.text,
        inputs_embeds=embeds,
        position_ids=position_ids,
        segment_ids=segment_ids,
        cache=cache,
        kv_segment_ids=kv_segment_ids,
        remat=remat,
        int4_i8dot=int4_i8dot,
        sp=sp,
    )


def prefill_forward(
    model: Qwen25VL,
    input_ids: torch.Tensor,       # (B, P)
    position_ids: torch.Tensor,    # (3, B, P)
    segment_ids: torch.Tensor,     # (B, P) int32
    cache: KVCache,
    kv_segment_ids: torch.Tensor,
    vision: Optional[VisionInputs] = None,
    prefill_chunk: int = 0,
    prefill_rows: int = 0,
) -> Tuple[torch.Tensor, KVCache]:
    """Prompt prefill into ``cache`` — one forward, or sequence-chunked when
    ``prefill_chunk`` > 0 (bounds the MLP/activation footprint by B*chunk
    tokens; each chunk attends the live cache prefix with a static causal
    offset). The vision tower is not chunkable, so image prompts embed once
    up front; text-only prompts embed per chunk. Returns (last chunk's hidden
    states, filled cache — the same buffers, written in place).

    ``prefill_rows`` > 0 chunks along the batch axis instead: row groups run
    ordinary full-length forwards into a group-sized cache whose rows are
    then copied into ``cache``. Same activation bound (rows*P tokens vs
    B*chunk); the two compose (rows*chunk). In rows mode the returned hidden
    is the last-position slice (B, 1, E) only — all engines sample from
    exactly that slice."""
    b, p = input_ids.shape
    text = model.text
    if prefill_rows and prefill_rows < b:
        embeds = embed_inputs(model, input_ids, vision) if vision is not None else None
        n_layers, _, hkv, _, d = cache.k.shape
        is_int4 = cache.k.dtype == torch.uint8
        width = cache.k.shape[3] * (2 if is_int4 else 1)
        tails = []
        length = cache.length
        for r0 in range(0, b, prefill_rows):
            r1 = min(r0 + prefill_rows, b)
            sub = KVCache.init(n_layers, r1 - r0, width, hkv, d,
                               dtype=cache.k.dtype, device=cache.k.device)
            if embeds is not None and prefill_chunk and prefill_chunk < p:
                h = None
                for c in range(0, p, prefill_chunk):
                    e = min(c + prefill_chunk, p)
                    h, sub = forward_hidden(
                        text, inputs_embeds=embeds[r0:r1, c:e],
                        position_ids=position_ids[:, r0:r1, c:e],
                        segment_ids=segment_ids[r0:r1, c:e],
                        cache=sub, kv_segment_ids=kv_segment_ids[r0:r1], attend_to_cache=True,
                    )
            elif embeds is not None:
                h, sub = forward_hidden(
                    text, inputs_embeds=embeds[r0:r1], position_ids=position_ids[:, r0:r1],
                    segment_ids=segment_ids[r0:r1], cache=sub,
                    kv_segment_ids=kv_segment_ids[r0:r1],
                )
            else:
                h, sub = prefill_forward(
                    model, input_ids[r0:r1], position_ids[:, r0:r1], segment_ids[r0:r1],
                    sub, kv_segment_ids[r0:r1], vision=None, prefill_chunk=prefill_chunk,
                )
            tails.append(h[:, -1:, :])
            for dst, src in zip(cache.arrays(), sub.arrays()):
                dst[:, r0:r1] = src
            length = sub.length
        return torch.cat(tails, dim=0), KVCache(cache.k, cache.v, length, cache.k_scale, cache.v_scale)
    if prefill_chunk and prefill_chunk < p:
        embeds = embed_inputs(model, input_ids, vision) if vision is not None else None
        hidden = None
        for c in range(0, p, prefill_chunk):
            e = min(c + prefill_chunk, p)
            chunk_embeds = (
                embeds[:, c:e] if embeds is not None else embed_inputs(model, input_ids[:, c:e])
            )
            hidden, cache = forward_hidden(
                text, inputs_embeds=chunk_embeds, position_ids=position_ids[:, :, c:e],
                segment_ids=segment_ids[:, c:e], cache=cache, kv_segment_ids=kv_segment_ids,
                attend_to_cache=True,
            )
        return hidden, cache
    return forward(
        model, input_ids, position_ids, segment_ids=segment_ids, vision=vision,
        cache=cache, kv_segment_ids=kv_segment_ids,
    )


def fanout_rows(x: torch.Tensor, n: int, dim: int = 0) -> torch.Tensor:
    """Repeat each index along ``dim`` n times (grouped-sampling fanout: row
    i maps to rows i*n .. i*n+n-1)."""
    return x.repeat_interleave(n, dim=dim)
