"""Dense rollout engine: batched prefill + autoregressive decode over a bf16
KV cache (counterpart of ``spatialthinker_tpu/rollout/engine.py``).

- prefill: one forward over the left-padded prompt block (B, P), writing KV
  for every position; prompt padding is masked by segment ids.
- grouped sampling (n > 1): each prompt is prefilled once (text stack and
  vision tower) and its KV is copied into n decode lanes, rows ordered
  [prompt0 x n, prompt1 x n, ...].
- decode: a Python loop, one token per row per step, through the decode
  kernel; it stops as soon as every row has emitted EOS.
- mRoPE: generated tokens continue at ``gen_pos_start + step`` on all three
  channels.

The cache is bf16 whatever the weights' dtype (``rollout.kv_cache_dtype:
bfloat16``), written in place; its width rounds up to a multiple of 128 and
the pad cells stay invalid in ``kv_seg``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.qwen2_5_vl.host import VisionInputs
from ..models.qwen2_5_vl.model import Qwen25VL, fanout_rows, forward, prefill_forward
from ..models.qwen2_5_vl.text import KVCache, logits_from_hidden
from .sampling import SamplingParams, get_response_mask, sample_tokens, sampled_token_logp

CACHE_WIDTH_MULTIPLE = 128
KV_CACHE_DTYPE = torch.bfloat16  # rollout.kv_cache_dtype of the shipped config


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
    n: int = 1,
) -> RolloutResult:
    """Prefill + decode. Returns B*n rows when ``n`` > 1."""
    cfg = model.cfg
    tc = cfg.text
    device = input_ids.device
    b, p = input_ids.shape
    total = -(-(p + max_new_tokens) // CACHE_WIDTH_MULTIPLE) * CACHE_WIDTH_MULTIPLE

    def new_cache(rows: int, width: int) -> KVCache:
        return KVCache.init(tc.num_hidden_layers, rows, width, tc.num_key_value_heads,
                            tc.head_dim, dtype=KV_CACHE_DTYPE, device=device)

    # prefill writes a prompt-width cache for the b unique prompts; with n == 1
    # that IS the decode cache (allocated at full width up front)
    cache = new_cache(b, p if n > 1 else total)
    seg32 = prompt_segment_ids.to(torch.int32)
    kv_seg = torch.zeros((b, total), dtype=torch.int32, device=device)
    kv_seg[:, :p] = seg32
    # prefill attends the prompt's own k/v: its kv segment ids are the prompt's
    hidden, cache = prefill_forward(model, input_ids, position_ids, seg32, cache, seg32, vision=vision)
    last_logits = logits_from_hidden(model.text, hidden[:, -1, :])

    if n > 1:
        # copy the prompt KV into n decode lanes per prompt (row i*n + j)
        full = new_cache(b * n, total)
        for dst, src in ((full.k, cache.k), (full.v, cache.v)):
            lanes = dst.view(dst.shape[0], b, n, *dst.shape[2:])
            lanes[..., :p, :] = src.unsqueeze(2)
        cache = KVCache(full.k, full.v, p)
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
            model, cur[:, None], pos, segment_ids=ones, cache=cache, kv_segment_ids=kv_seg
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
