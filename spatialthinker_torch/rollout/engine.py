"""Dense rollout engine: batched prefill + autoregressive decode over a dense
KV cache (counterpart of ``spatialthinker_tpu/rollout/engine.py``).

- prefill: one forward over the left-padded prompt block (B, P), writing KV
  for every position; prompt padding is masked by segment ids. With
  ``prefill_chunk`` the prompt runs in sequence chunks, with ``prefill_rows``
  in row groups (``prefill_forward``); both bound the activation footprint.
- grouped sampling (n > 1): each prompt is prefilled once (text stack and
  vision tower) and its KV is copied into n decode lanes, rows ordered
  [prompt0 x n, prompt1 x n, ...].
- decode: a Python loop, one token per row per step, through the decode
  kernels; it stops as soon as every row has emitted EOS.
- mRoPE: generated tokens continue at ``gen_pos_start + step`` on all three
  channels.

The cache is written in place in the format ``kv_cache_dtype`` names
(``rollout.kv_cache_dtype``): bf16, int8 with per-cell scales, or packed
int4 (the ``torch.uint8`` marker). Its width rounds up to a multiple of 128
(256 for int4, so the packed row count stays a multiple of 128) and the pad
cells stay invalid in ``kv_seg``.

Tensor parallelism: a TP-local model (``parallel/tensor.py``; the rollout
copy keeps ``embed_tokens`` and the head whole) runs here as it is, each rank
of the TP group on the same prompts: the cache holds the rank's kv heads, the
layers all-reduce their row-parallel products, and with equal inputs and the
group's sampler seed every rank draws the same tokens and stops at the same
step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.qwen2_5_vl.host import VisionInputs
from ..models.qwen2_5_vl.model import Qwen25VL, fanout_rows, forward, prefill_forward
from ..models.qwen2_5_vl.text import KVCache, kv_heads, logits_from_hidden, repack_kv4
from .sampling import SamplingParams, get_response_mask, sample_tokens, sampled_token_logp

CACHE_WIDTH_MULTIPLE = 128
KV_CACHE_DTYPE = torch.bfloat16  # rollout.kv_cache_dtype of the shipped config


def cache_width(prompt_len: int, max_new_tokens: int, kv_cache_dtype=KV_CACHE_DTYPE) -> int:
    mult = 2 * CACHE_WIDTH_MULTIPLE if kv_cache_dtype == torch.uint8 else CACHE_WIDTH_MULTIPLE
    return -(-(prompt_len + max_new_tokens) // mult) * mult


class RolloutResult(NamedTuple):
    responses: torch.Tensor          # (B, R) int64, pad after EOS
    response_mask: torch.Tensor      # (B, R) int32, 1 up to & incl. EOS
    rollout_log_probs: torch.Tensor  # (B, R) fp32 — sampled-token log-probs


@torch.no_grad()
def generate(
    model: Qwen25VL,
    input_ids: torch.Tensor,           # (B, P) left-padded prompts
    prompt_segment_ids: torch.Tensor,  # (B, P) 1 = valid
    position_ids: torch.Tensor,        # (3, B, P) mRoPE for the prompt
    gen_pos_start: torch.Tensor,       # (B,) first generated position
    *,
    max_new_tokens: int,
    sampling: SamplingParams,
    generator: torch.Generator,
    vision: Optional[VisionInputs] = None,  # tensors on the model's device
    kv_cache_dtype=KV_CACHE_DTYPE,
    prefill_chunk: int = 0,
    prefill_rows: int = 0,
    n: int = 1,
    int4_i8dot: bool = False,
) -> RolloutResult:
    """Prefill + decode. Returns B*n rows when ``n`` > 1. ``int4_i8dot``
    (int4 caches) decodes with both attention dots on int8 operands."""
    cfg = model.cfg
    tc = cfg.text
    device = input_ids.device
    b, p = input_ids.shape
    total = cache_width(p, max_new_tokens, kv_cache_dtype)

    def new_cache(rows: int, width: int) -> KVCache:
        return KVCache.init(tc.num_hidden_layers, rows, width, kv_heads(model.text),
                            tc.head_dim, dtype=kv_cache_dtype, device=device)

    # prefill writes a prompt-width cache for the b unique prompts; with n == 1
    # that IS the decode cache (allocated at full width up front)
    cache = new_cache(b, p if n > 1 else total)
    seg32 = prompt_segment_ids.to(torch.int32)
    kv_seg = torch.zeros((b, total), dtype=torch.int32, device=device)
    kv_seg[:, :p] = seg32
    # prefill attends the prompt's own k/v: its kv segment ids are the prompt's
    hidden, cache = prefill_forward(model, input_ids, position_ids, seg32, cache, seg32, vision=vision,
                                    prefill_chunk=prefill_chunk, prefill_rows=prefill_rows)
    last_logits = logits_from_hidden(model.text, hidden[:, -1, :])

    if n > 1:
        # copy the prompt KV into n decode lanes per prompt (row i*n + j)
        full = new_cache(b * n, total)

        def lanes(dst):
            return dst.view(dst.shape[0], b, n, *dst.shape[2:])

        if kv_cache_dtype == torch.uint8:
            # split-half packing is relative to the cache width (the nibble
            # half of token t is t // (S/2)): the prompt-width cache is laid
            # out anew for the total width before it fans out
            lanes(full.k).copy_(repack_kv4(cache.k, total).unsqueeze(2))
            lanes(full.v).copy_(repack_kv4(cache.v, total).unsqueeze(2))
        else:
            lanes(full.k)[..., :p, :] = cache.k.unsqueeze(2)
            lanes(full.v)[..., :p, :] = cache.v.unsqueeze(2)
        if cache.quantized:
            lanes(full.k_scale)[..., :p] = cache.k_scale.unsqueeze(2)
            lanes(full.v_scale)[..., :p] = cache.v_scale.unsqueeze(2)
        cache = KVCache(full.k, full.v, p, full.k_scale, full.v_scale)
        last_logits = fanout_rows(last_logits, n)
        kv_seg = fanout_rows(kv_seg, n)
        gen_pos_start = fanout_rows(gen_pos_start, n)
        b = b * n

    first_token = sample_tokens(last_logits, generator, sampling)
    first_logp = sampled_token_logp(last_logits, first_token, sampling)
    finished = first_token == cfg.eos_token_id

    tokens = torch.full((b, max_new_tokens), cfg.pad_token_id, dtype=torch.int64, device=device)
    logps = torch.zeros((b, max_new_tokens), dtype=torch.float32, device=device)
    tokens[:, 0] = first_token
    logps[:, 0] = first_logp
    cur = first_token
    ones = torch.ones((b, 1), dtype=torch.int32, device=device)
    gen_pos_start = gen_pos_start.to(torch.int64)
    step = 0
    # stop as soon as every row has finished (one host sync per step)
    while step < max_new_tokens - 1 and not bool(finished.all()):
        # the token fed at decode step j sits at rope position gen_pos_start + j
        pos = (gen_pos_start + step).view(1, b, 1).expand(3, b, 1)
        kv_seg[:, p + step] = 1
        cache.length = p + step
        hidden, cache = forward(
            model, cur[:, None], pos, segment_ids=ones, cache=cache, kv_segment_ids=kv_seg,
            int4_i8dot=int4_i8dot,
        )
        logits = logits_from_hidden(model.text, hidden[:, 0, :])
        sampled = sample_tokens(logits, generator, sampling)
        logp = sampled_token_logp(logits, sampled, sampling)
        cur = torch.where(finished, torch.full_like(sampled, cfg.pad_token_id), sampled)
        tokens[:, step + 1] = cur
        logps[:, step + 1] = torch.where(finished, torch.zeros_like(logp), logp)
        finished = finished | (cur == cfg.eos_token_id)
        step += 1

    mask = get_response_mask(tokens, cfg.eos_token_id)
    responses = torch.where(mask == 1, tokens, torch.full_like(tokens, cfg.pad_token_id))
    return RolloutResult(responses=responses, response_mask=mask, rollout_log_probs=logps * mask)
