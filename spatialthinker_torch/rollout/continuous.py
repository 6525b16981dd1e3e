"""Continuous-batching rollout: fixed decode slots over a dense per-slot KV
cache, per-slot lengths and rope positions, and host-orchestrated refill of
finished slots (counterpart of ``spatialthinker_tpu/rollout/continuous.py``).

Two device steps — ``prefill_slots`` (a prompt batch's KV into chosen slots)
and ``decode_chunk`` (every running slot advances ``chunk`` tokens) — plus a
host loop that harvests finished slots between chunks and refills them from
the prompt queue. Unlike the dense ``engine.generate``, which runs until the
last sequence of a batch finishes, slot turnover keeps the lanes busy at
uneven response lengths.

- The slot cache is (L, lanes, Hkv, T, D), T the prompt width plus
  ``max_new_tokens`` rounded up to 128 (256 for int4, so the packed row count
  stays a multiple of 128); bf16, int8 with per-cell scales, or packed int4
  (the ``torch.uint8`` marker, split-half over the whole width).
- Each unique prompt is prefilled once and its KV fans out to ``group_n``
  lanes; an int4 prompt cache is re-laid out for the full width
  (``repack_kv4``) and installed over the WHOLE packed row, which also clears
  a previous tenant's high nibbles.
- Decode KV rows live in a ring of the cache's last ``max_new_tokens`` cells
  addressed by a global step counter: every slot writes the same cell
  ``(T - max_new) + ring % max_new`` each step (an int4 cache merges its
  nibble into the byte its split-half twin shares). The JAX package chose
  the ring because a per-slot scatter serialises on the TPU; the port keeps
  it because the int4 int8-dot decode kernel quantizes its softmax weights
  per block of cells (``ops.decode_attention.int4_block_rows``), so the cell
  a token lands in is part of the result, and only the ring gives the JAX
  package's numbers. A slot's occupant lives at most ``max_new_tokens``
  steps and refills happen between chunks, so its ring cells never collide;
  stale cells are invalid in ``kv_seg`` and never read.
- The lane count is ``slots + 1`` (the trash lane that queue-padding prefill
  rows land on) rounded up to a multiple of 8. That count is the decode m of
  every matmul, and with ``quantization=w4a8`` it decides whether the int4
  MLP runs at all (``ops.int4_mlp.w4_eligible`` wants an even m): 128 slots
  give 136 lanes, and the int4 kernels engage.

Slot state is updated in place. The host keeps mirrors of the slot flags it
sets itself, so the steady-state loop reads one (lanes,) vector per chunk.
Tensor parallelism: a TP-local model (``parallel/tensor.py``; the rollout
copy keeps ``embed_tokens`` and the head whole) runs here as it is, each rank
of the TP group on the same prompts: the slot cache and the prefill scratch
hold the rank's kv heads, and the layers all-reduce their row-parallel
products. The host loop reads only the finished flags, which come from the
sampled tokens: with the all-reduced hidden states bitwise equal on every
rank and the group's sampler seed, every rank refills and harvests the same
slots at the same chunk. Not ported: the multi-device branch (``mesh=``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..data.packing import pack_vision_batch
from ..models.qwen2_5_vl.config import Qwen25VLConfig
from ..models.qwen2_5_vl.host import layout_patch_count, window_patch_len
from ..models.qwen2_5_vl.model import Qwen25VL, fanout_rows, prefill_forward, vision_to_device
from ..models.qwen2_5_vl.rope import compute_cos_sin, make_inv_freq
from ..models.qwen2_5_vl.text import (
    KV4_BIAS,
    KVCache,
    _quantize_kv,
    _quantize_kv4,
    attention_inputs,
    kv_heads,
    finish_layer,
    logits_from_hidden,
    repack_kv4,
)
from ..ops.decode_attention import decode_attention
from ..ops.quant import embed_rows
from .sampling import SamplingParams, get_response_mask, sample_tokens, sampled_token_logp

LANE_MULTIPLE = 8


@dataclass
class SlotState:
    """Device state of the engine; every tensor is updated in place."""

    cache_k: torch.Tensor      # (L, S, Hkv, T, D) bf16 | int8; uint8 (L, S, Hkv, T/2, D) int4
    cache_v: torch.Tensor
    kv_seg: torch.Tensor       # (S, T) int32 — validity of each cache cell
    length: torch.Tensor       # (S,) int32 — cells used (prompt P + generated)
    cur_tokens: torch.Tensor   # (S,) int64 — next token to feed
    gen_pos: torch.Tensor      # (S,) int64 — rope position of the next fed token
    steps: torch.Tensor        # (S,) int64 — tokens generated so far (incl. cur)
    finished: torch.Tensor     # (S,) bool
    active: torch.Tensor       # (S,) bool — the slot holds a real sequence
    responses: torch.Tensor    # (S, R) int64
    logps: torch.Tensor        # (S, R) fp32
    k_scale: Optional[torch.Tensor] = None  # (L, S, Hkv, T) bf16 — int8 / int4 caches
    v_scale: Optional[torch.Tensor] = None
    ring: int = 0              # global decode-step counter (the ring cell, see above)

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_slot_state(cfg: Qwen25VLConfig, slots: int, prompt_len: int, max_new_tokens: int,
                    kv_dtype=torch.bfloat16, device=None, num_kv_heads: Optional[int] = None) -> SlotState:
    """Empty slots: every cell invalid, every slot finished and inactive.
    ``num_kv_heads``: the heads the cache holds (this rank's under TP;
    default the config's)."""
    if device is None:
        from ..models.qwen2_5_vl.params import default_device

        device = default_device()
    t = cfg.text
    mult = 256 if kv_dtype == torch.uint8 else 128
    total = -(-(prompt_len + max_new_tokens) // mult) * mult
    heads = t.num_key_value_heads if num_kv_heads is None else num_kv_heads
    shape = (t.num_hidden_layers, slots, heads, total, t.head_dim)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    scales = {}
    if kv_dtype in (torch.int8, torch.uint8):  # two separate buffers
        scales = dict(k_scale=zeros(shape[:-1], torch.bfloat16), v_scale=zeros(shape[:-1], torch.bfloat16))
    kv_shape = shape[:3] + ((total // 2 if kv_dtype == torch.uint8 else total),) + shape[4:]
    return SlotState(
        cache_k=zeros(kv_shape, kv_dtype), cache_v=zeros(kv_shape, kv_dtype),
        kv_seg=zeros((slots, total), torch.int32),
        length=zeros((slots,), torch.int32),
        cur_tokens=zeros((slots,), torch.int64),
        gen_pos=zeros((slots,), torch.int64),
        steps=zeros((slots,), torch.int64),
        finished=torch.ones((slots,), dtype=torch.bool, device=device),
        active=zeros((slots,), torch.bool),
        responses=torch.full((slots, max_new_tokens), cfg.pad_token_id, dtype=torch.int64, device=device),
        logps=zeros((slots, max_new_tokens), torch.float32),
        **scales,
    )


# ---------------------------------------------------------------------------
# prefill into slots
# ---------------------------------------------------------------------------


@torch.no_grad()
def prefill_slots(
    model: Qwen25VL, state: SlotState,
    slot_ids: torch.Tensor,       # (u * group_n,)
    input_ids: torch.Tensor,      # (u, P) UNIQUE prompts
    segment_ids: torch.Tensor,    # (u, P)
    position_ids: torch.Tensor,   # (3, u, P)
    gen_pos_start: torch.Tensor,  # (u,)
    valid: torch.Tensor,          # (u,) bool — False rows are queue padding
    sampling: SamplingParams,
    generator: torch.Generator,
    vision=None,
    prefill_chunk: int = 0,       # >0: sequence-chunked prefill
    prefill_rows: int = 0,        # >0: batch-chunked prefill (rows mode)
    group_n: int = 1,
) -> SlotState:
    """The prompt forward for u unique prompts, each installed into
    ``group_n`` consecutive entries of ``slot_ids``, and the first token of
    every lane sampled."""
    cfg = model.cfg
    t = cfg.text
    u, p = input_ids.shape
    total = state.kv_seg.shape[1]
    max_new = state.responses.shape[1]

    scratch = KVCache.init(t.num_hidden_layers, u, p, kv_heads(model.text), t.head_dim,
                           dtype=state.cache_k.dtype, device=state.cache_k.device)
    seg32 = segment_ids.to(torch.int32)
    hidden, scratch = prefill_forward(model, input_ids, position_ids, seg32, scratch, seg32, vision=vision,
                                      prefill_chunk=prefill_chunk, prefill_rows=prefill_rows)
    last_logits = logits_from_hidden(model.text, hidden[:, -1:, :])[:, 0, :]

    arrays = scratch.arrays()
    if group_n > 1:
        arrays = tuple(fanout_rows(a, group_n, dim=1) for a in arrays)
        last_logits = fanout_rows(last_logits, group_n)
        seg32 = fanout_rows(seg32, group_n)
        gen_pos_start = fanout_rows(gen_pos_start, group_n)
        valid = fanout_rows(valid, group_n)

    first = sample_tokens(last_logits, generator, sampling)
    first_logp = sampled_token_logp(last_logits, first, sampling)
    finished0 = (first == cfg.eos_token_id) | ~valid

    if state.cache_k.dtype == torch.uint8:
        # the split-half layout is relative to the width: re-lay the width-p
        # prompt cache for the slot width and install the WHOLE packed rows
        state.cache_k[:, slot_ids] = repack_kv4(arrays[0], total)
        state.cache_v[:, slot_ids] = repack_kv4(arrays[1], total)
    else:
        state.cache_k[:, slot_ids, :, :p] = arrays[0]
        state.cache_v[:, slot_ids, :, :p] = arrays[1]
    if state.quantized:
        state.k_scale[:, slot_ids, :, :p] = arrays[2]
        state.v_scale[:, slot_ids, :, :p] = arrays[3]
    k = u * group_n
    device = first.device
    kv_row = torch.zeros((k, total), dtype=torch.int32, device=device)
    kv_row[:, :p] = seg32
    resp_row = torch.full((k, max_new), cfg.pad_token_id, dtype=torch.int64, device=device)
    resp_row[:, 0] = first
    logp_row = torch.zeros((k, max_new), dtype=torch.float32, device=device)
    logp_row[:, 0] = first_logp

    state.kv_seg[slot_ids] = kv_row
    state.length[slot_ids] = p
    state.cur_tokens[slot_ids] = first
    state.gen_pos[slot_ids] = gen_pos_start.to(torch.int64)
    state.steps[slot_ids] = 1
    state.finished[slot_ids] = finished0
    state.active[slot_ids] = valid
    state.responses[slot_ids] = resp_row
    state.logps[slot_ids] = logp_row
    return state


# ---------------------------------------------------------------------------
# per-slot decode (slots at different lengths)
# ---------------------------------------------------------------------------


def _decode_layer(layer, cfg, x: torch.Tensor, cos, sin, state: SlotState, layer_idx: int,
                  write_row: int, int4_i8dot: bool = False) -> torch.Tensor:
    """One decoder layer for a single token per slot: the new KV goes to the
    uniform ring cell ``write_row`` of every slot, in place, and attention
    reads the stacked cache through the decode kernels."""
    x2 = x[:, None, :]
    q, knew, vnew = attention_inputs(layer, cfg, x2, cos, sin)
    int4 = state.cache_k.dtype == torch.uint8
    if state.quantized:
        kq, ks = (_quantize_kv4 if int4 else _quantize_kv)(knew)  # (S, 1, Hkv, D) / (S, 1, Hkv)
        vq, vs = (_quantize_kv4 if int4 else _quantize_kv)(vnew)
        if int4:
            half = state.cache_k.shape[3]
            row, high = write_row % half, write_row >= half  # uniform cell, uniform nibble
            for arr, q4 in ((state.cache_k, kq), (state.cache_v, vq)):
                cur = arr[layer_idx, :, :, row]  # (S, Hkv, D): the byte the twin token shares
                qb = (q4[:, 0] + KV4_BIAS).to(torch.uint8)
                arr[layer_idx, :, :, row] = (cur & 0x0F) | (qb << 4) if high else (cur & 0xF0) | (qb & 0xF)
        else:
            state.cache_k[layer_idx, :, :, write_row] = kq[:, 0]
            state.cache_v[layer_idx, :, :, write_row] = vq[:, 0]
        state.k_scale[layer_idx, :, :, write_row] = ks[:, 0]
        state.v_scale[layer_idx, :, :, write_row] = vs[:, 0]
        q1 = q[:, 0].to(x.dtype)
    else:
        state.cache_k[layer_idx, :, :, write_row] = knew[:, 0].to(state.cache_k.dtype)
        state.cache_v[layer_idx, :, :, write_row] = vnew[:, 0].to(state.cache_v.dtype)
        q1 = q[:, 0].to(state.cache_k.dtype)  # a bf16 cache meets the query in its dtype
    out = decode_attention(q1.contiguous(), state.cache_k, state.cache_v, state.kv_seg, layer_idx,
                           state.k_scale, state.v_scale, int4_i8dot=int4_i8dot)
    return finish_layer(layer, cfg, x2, out[:, None].to(x.dtype))[:, 0]


@torch.no_grad()
def decode_chunk(model: Qwen25VL, state: SlotState, sampling: SamplingParams, chunk: int,
                 generator: torch.Generator, int4_i8dot: bool = False) -> SlotState:
    """Advance every running slot ``chunk`` tokens (finished and inactive
    slots no-op: their ring writes land in cells ``kv_seg`` keeps invalid)."""
    cfg = model.cfg
    t = cfg.text
    text = model.text
    device = state.cur_tokens.device
    inv_freq = torch.as_tensor(make_inv_freq(t.head_dim, t.rope_theta), dtype=torch.float32, device=device)
    total = state.kv_seg.shape[1]
    max_new = state.responses.shape[1]
    s = state.cur_tokens.shape[0]
    cols = torch.arange(max_new, device=device)[None]
    for _ in range(chunk):
        run = state.active & ~state.finished
        write_row = (total - max_new) + state.ring % max_new
        state.kv_seg[:, write_row] = torch.where(run, torch.ones_like(state.kv_seg[:, write_row]),
                                                 state.kv_seg[:, write_row])
        pos = state.gen_pos[None, :, None].expand(3, s, 1)
        cos, sin = compute_cos_sin(pos, inv_freq, t.mrope_section, dtype=torch.bfloat16)
        x = embed_rows(text.embed_tokens.weight, state.cur_tokens, dtype=text.norm.weight.dtype)
        for i, layer in enumerate(text.layers):
            x = _decode_layer(layer, t, x, cos, sin, state, i, write_row, int4_i8dot=int4_i8dot)
        hidden = text.norm(x[:, None, :])
        logits = logits_from_hidden(text, hidden)[:, 0, :]
        sampled = sample_tokens(logits, generator, sampling)
        logp = sampled_token_logp(logits, sampled, sampling)

        write_step = state.steps.clamp(0, max_new - 1)
        here = run[:, None] & (cols == write_step[:, None])
        state.responses = torch.where(here, sampled[:, None], state.responses)
        state.logps = torch.where(here, logp[:, None], state.logps)
        newly_finished = run & ((sampled == cfg.eos_token_id) | (state.steps + 1 >= max_new))
        state.length = torch.where(run, state.length + 1, state.length)
        state.cur_tokens = torch.where(run, sampled, state.cur_tokens)
        state.gen_pos = torch.where(run, state.gen_pos + 1, state.gen_pos)
        state.steps = torch.where(run, state.steps + 1, state.steps)
        state.finished = state.finished | newly_finished
        state.ring += 1
    return state


# ---------------------------------------------------------------------------
# host orchestration
# ---------------------------------------------------------------------------


class ContinuousResult(NamedTuple):
    responses: np.ndarray          # (B * group_n, R)
    response_mask: np.ndarray      # (B * group_n, R)
    rollout_log_probs: np.ndarray  # (B * group_n, R)
    stats: dict                    # lanes, refills, chunks and the seconds spent in each


def effective_prefill_chunk(
    prompt_len: int, rows: int, prefill_chunk_size: int, max_num_batched_tokens: int
) -> int:
    """Tokens per row per prefill forward (0 = unchunked). The binding
    constraint is rows * chunk <= max_num_batched_tokens; prefill_chunk_size
    caps the chunk directly. Chunks of 128 or more round DOWN to a multiple
    of 128 — rounding a budget-derived chunk up would exceed
    max_num_batched_tokens, the knob that bounds prefill activation memory."""
    chunk = prompt_len
    if max_num_batched_tokens > 0 and rows > 0:
        chunk = min(chunk, max_num_batched_tokens // rows)
    if prefill_chunk_size > 0:
        chunk = min(chunk, prefill_chunk_size)
    if chunk >= prompt_len:
        return 0
    if chunk >= 128:
        chunk = chunk // 128 * 128
    return max(chunk, 1)


def generate_continuous(
    model: Qwen25VL,
    input_ids: np.ndarray,       # (B, P) left-padded UNIQUE prompts
    segment_ids: np.ndarray,     # (B, P)
    position_ids: np.ndarray,    # (3, B, P)
    gen_pos_start: np.ndarray,   # (B,)
    *,
    max_new_tokens: int,
    sampling: SamplingParams,
    generator: torch.Generator,
    slots: int = 32,
    decode_chunk_size: int = 32,
    kv_cache_dtype=torch.bfloat16,  # torch.int8, or torch.uint8 = packed int4
    patches_list=None,           # per-prompt (N_i, Din) arrays (multimodal)
    grids_list=None,             # per-prompt (num_images, 3) grids
    vision_bucket: int = 0,      # patches per refill batch (0 = auto)
    prefill_chunk_size: int = 0,
    max_num_batched_tokens: int = 0,
    prefill_rows: int = 0,       # >0: batch-chunked (rows mode) refill prefill
    refill_batch: int = 0,       # >0: cap unique prompts per refill prefill
    group_n: int = 1,
    int4_i8dot: bool = False,    # int4 caches: both attention dots on int8 operands
) -> ContinuousResult:
    """Generate B*group_n sequences through ``slots`` decode lanes with refill,
    on the device that holds ``model``. Each unique prompt is prefilled once
    and installed into ``group_n`` slots; output row i*group_n + j is sample j
    of prompt i."""
    cfg = model.cfg
    device = model.text.norm.weight.device
    input_ids = np.asarray(input_ids)
    segment_ids = np.asarray(segment_ids)
    position_ids = np.asarray(position_ids)
    gen_pos_start = np.asarray(gen_pos_start)

    b, p = input_ids.shape
    n_out = b * group_n
    slots = min(slots, n_out)
    slots = max(slots - slots % group_n, group_n)  # whole groups only
    u_batch = slots // group_n
    if refill_batch > 0:
        # the refill's scratch cache is u_batch x P of KV: a cap below the slot
        # count fills the lanes over several small refills
        u_batch = max(min(u_batch, refill_batch), 1)
    if prefill_rows and prefill_rows < u_batch:
        prefill_chunk = effective_prefill_chunk(p, prefill_rows, prefill_chunk_size, max_num_batched_tokens)
    else:
        prefill_rows = 0  # inert: the sequence-chunk bound applies to the whole refill
        prefill_chunk = effective_prefill_chunk(p, u_batch, prefill_chunk_size, max_num_batched_tokens)

    # lane `slots` is the trash lane of queue-padding prefill rows; the lane
    # count rounds up to a multiple of 8 (the decode m, see the module note)
    trash = slots
    n_lanes = -(-(slots + 1) // LANE_MULTIPLE) * LANE_MULTIPLE
    state = init_slot_state(cfg, n_lanes, p, max_new_tokens, kv_cache_dtype, device=device,
                            num_kv_heads=kv_heads(model.text))

    def dev(x):
        return torch.as_tensor(np.asarray(x), device=device)

    responses = np.full((n_out, max_new_tokens), cfg.pad_token_id, dtype=np.int64)
    logps_out = np.zeros((n_out, max_new_tokens), dtype=np.float32)
    slot_owner = np.full(n_lanes, -1, dtype=np.int64)  # output-row index
    h_active = np.zeros(n_lanes, dtype=bool)  # host mirror of `active`
    next_prompt = 0
    stats = {"lanes": n_lanes, "refills": 0, "chunks": 0, "refill_s": 0.0, "decode_s": 0.0}

    multimodal = patches_list is not None and any(x is not None for x in patches_list)
    if multimodal and vision_bucket <= 0:
        per_prompt = [
            0 if g is None else sum(layout_patch_count(row, cfg.vision) for row in np.asarray(g))
            for g in grids_list
        ]
        vision_bucket = max(per_prompt) * u_batch
        wlen = window_patch_len(cfg.vision)
        vision_bucket = -(-vision_bucket // wlen) * wlen

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def refill(free: List[int]) -> None:
        nonlocal next_prompt
        targets = np.full(u_batch * group_n, trash, dtype=np.int64)
        rows = np.zeros(u_batch, dtype=np.int64)
        valid = np.zeros(u_batch, dtype=bool)
        for g in range(u_batch):
            if next_prompt >= b or len(free) < group_n:
                break
            rows[g] = next_prompt
            valid[g] = True
            for j in range(group_n):
                slot = free.pop(0)
                targets[g * group_n + j] = slot
                slot_owner[slot] = next_prompt * group_n + j
                h_active[slot] = True
            next_prompt += 1
        ids_batch = input_ids[rows].copy()
        seg_batch = segment_ids[rows].copy()
        ids_batch[~valid] = 0  # padding rows carry no tokens (image-token alignment)
        seg_batch[~valid] = 0
        vision = None
        if multimodal:
            vision = vision_to_device(
                pack_vision_batch(
                    [patches_list[int(r)] if v else None for r, v in zip(rows, valid)],
                    [grids_list[int(r)] if v else None for r, v in zip(rows, valid)],
                    cfg.vision, pad_to=vision_bucket,
                ),
                device,
            )
        prefill_slots(
            model, state, dev(targets), dev(ids_batch), dev(seg_batch), dev(position_ids[:, rows]),
            dev(gen_pos_start[rows]), dev(valid), sampling, generator, vision,
            prefill_chunk=prefill_chunk, prefill_rows=prefill_rows, group_n=group_n,
        )

    def refill_all(free: List[int]) -> None:
        while next_prompt < b and len(free) >= group_n:
            t0 = time.perf_counter()
            refill(free)
            sync()
            stats["refill_s"] += time.perf_counter() - t0
            stats["refills"] += 1

    def harvest(finished_np: np.ndarray) -> List[int]:
        done = [int(i) for i in np.nonzero(finished_np & h_active)[0]]
        if done:
            idx = dev(np.asarray(done, dtype=np.int64))
            resp_rows = state.responses[idx].cpu().numpy()
            logp_rows = state.logps[idx].cpu().numpy()
            for row, slot in enumerate(done):
                owner = slot_owner[slot]
                responses[owner] = resp_rows[row]
                logps_out[owner] = logp_rows[row]
                slot_owner[slot] = -1
                h_active[slot] = False
            state.active[idx] = False
        return done

    free_pool = list(range(slots))
    refill_all(free_pool)
    while True:
        t0 = time.perf_counter()
        decode_chunk(model, state, sampling, decode_chunk_size, generator, int4_i8dot=int4_i8dot)
        finished_np = state.finished.cpu().numpy().astype(bool)  # the one read per chunk
        stats["decode_s"] += time.perf_counter() - t0
        stats["chunks"] += 1
        free_pool.extend(harvest(finished_np))
        refill_all(free_pool)
        if not h_active.any() and next_prompt >= b:
            break

    mask = get_response_mask(torch.from_numpy(responses), cfg.eos_token_id).numpy()
    responses_out = np.where(mask == 1, responses, cfg.pad_token_id)
    return ContinuousResult(responses=responses_out, response_mask=mask,
                            rollout_log_probs=logps_out * mask, stats=stats)
