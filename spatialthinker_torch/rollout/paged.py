"""Paged continuous-batching rollout: a global KV page pool, host-managed
page tables with refcounted prompt-page sharing, and preempt-and-requeue
admission (counterpart of ``spatialthinker_tpu/rollout/paged.py``).

- a slot occupies only the pages it has filled; admission is bounded by the
  page pool (the memory budget), not by slots x worst-case reservation;
- pages hold compacted tokens (no left padding): prefill gathers each
  prompt's valid tail out of a scratch cache while scattering into pages;
- grouped sampling (``group_n``) shares the prompt's full pages across the n
  lanes via refcounts; only the partial tail page is per lane;
- on pool exhaustion the youngest group is preempted: its pages free, its
  prompt requeues and recomputes later. The oldest group is never
  preempted, so forward progress is guaranteed.

Decode keeps the reference's structure: a new token's (quantized) KV goes to
a small dense staging ring at the chunk-uniform index ``ring``; the pool
kernel (``ops.paged_attention``) attends the installed cells and returns
partial-softmax stats; the chunk's staged cells attend in plain tensor ops
and merge by the flash combine; ``_install_stage`` moves the ring into the
pools once per chunk. With ``fuse_staged`` the pool kernel attends the ring
cells itself (its staged block) and nothing is merged: one call per layer.
Pools and slot state are updated in place.

Scatter plans keep fixed shapes per refill geometry: unused entries target
the reserved dummy page 0 and padded queue rows the trash lane ``slots``;
page 0 may receive writes and is always masked by the lengths.

Tensor parallelism: a TP-local model (``parallel/tensor.py``; the rollout
copy keeps ``embed_tokens`` and the head whole) runs here as it is, each rank
of the TP group driving one engine on the same prompts: its pools hold its
kv heads, its layers all-reduce their row-parallel products, and with equal
inputs and the group's sampler seed every rank makes the same host
decisions (admission, preemption, finished lanes), so the ranks stay in
lockstep. The JAX package's multi-device branch (``mesh=``: lockstep engines
over one global queue and a page pool sharded over pages) is not ported:
ranks that hold other rows run engines of their own.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

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
    kv_heads,
    _pack_nibbles,
    _quantize_kv,
    _quantize_kv4,
    _unpack_kv4,
    attention_inputs,
    finish_layer,
    logits_from_hidden,
)
from ..ops.paged_attention import paged_attention
from ..ops.quant import embed_rows
from .continuous import effective_prefill_chunk
from .sampling import SamplingParams, get_response_mask, sample_tokens, sampled_token_logp


@dataclass
class PagedState:
    """Device state of the engine; every field is updated in place."""

    k_pool: torch.Tensor      # (L, N, Hkv, page, D) bf16 | int8; uint8 (L, N, Hkv, page/2, D) int4
    v_pool: torch.Tensor
    page_table: torch.Tensor  # (S, P_max) int32 — dummy page 0 beyond length
    length: torch.Tensor      # (S,) int32 — compacted INSTALLED cells (prompt + gen)
    cur_tokens: torch.Tensor  # (S,) int64
    gen_pos: torch.Tensor     # (S,) int64 — rope position of the next fed token
    steps: torch.Tensor       # (S,) int64
    finished: torch.Tensor    # (S,) bool
    active: torch.Tensor      # (S,) bool
    responses: torch.Tensor   # (S, R) int64
    logps: torch.Tensor       # (S, R) fp32
    k_scale: Optional[torch.Tensor] = None  # (L, N, Hkv, page) bf16 — int8 / int4 pools
    v_scale: Optional[torch.Tensor] = None
    # Decode staging ring: new tokens accumulate at the chunk-uniform index
    # `ring`; attention merges the pool kernel's partial softmax with the
    # staged cells, and one batched install per chunk moves them to the pools.
    stage_k: Optional[torch.Tensor] = None   # (L, S, Hkv, C, D) int8 | pool dtype — UNPACKED cells
    stage_v: Optional[torch.Tensor] = None
    stage_ks: Optional[torch.Tensor] = None  # (L, S, Hkv, C) bf16 — quantized pools
    stage_vs: Optional[torch.Tensor] = None
    stage_seg: Optional[torch.Tensor] = None  # (S, C) int32 — staged-cell validity
    ring: int = 0                             # position within the chunk

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def page(self) -> int:
        """Token cells per page."""
        return self.k_pool.shape[3] * (2 if self.k_pool.dtype == torch.uint8 else 1)


def init_paged_state(cfg: Qwen25VLConfig, slots: int, total_pages: int, page_size: int,
                     p_max: int, max_new_tokens: int, kv_dtype=torch.bfloat16,
                     stage_width: int = 16, device=None, num_kv_heads: Optional[int] = None) -> PagedState:
    """``num_kv_heads``: the heads the pools hold (a TP rank's), default the
    config's."""
    if device is None:
        from ..models.qwen2_5_vl.params import default_device

        device = default_device()
    t = cfg.text
    hkv = t.num_key_value_heads if num_kv_heads is None else num_kv_heads
    pool_shape = (t.num_hidden_layers, total_pages, hkv, page_size, t.head_dim)
    stage_shape = (t.num_hidden_layers, slots, hkv, stage_width, t.head_dim)
    quantized = kv_dtype in (torch.int8, torch.uint8)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    scales = {}
    if quantized:
        scales = dict(
            k_scale=zeros(pool_shape[:-1], torch.bfloat16), v_scale=zeros(pool_shape[:-1], torch.bfloat16),
            stage_ks=zeros(stage_shape[:-1], torch.bfloat16), stage_vs=zeros(stage_shape[:-1], torch.bfloat16),
        )
    if kv_dtype == torch.uint8:  # int4: page-local split-half packed rows
        if page_size % 2:
            raise ValueError(f"int4 pools need an even page size, got {page_size}")
        pool_shape = pool_shape[:3] + (page_size // 2, t.head_dim)
    # staging cells stay unpacked (int8 holds the int4 values before packing);
    # nibble packing happens once per chunk at install
    stage_dtype = torch.int8 if quantized else kv_dtype
    return PagedState(
        k_pool=zeros(pool_shape, kv_dtype), v_pool=zeros(pool_shape, kv_dtype),
        page_table=zeros((slots, p_max), torch.int32),
        length=zeros((slots,), torch.int32),
        cur_tokens=zeros((slots,), torch.int64),
        gen_pos=zeros((slots,), torch.int64),
        steps=zeros((slots,), torch.int64),
        finished=torch.ones((slots,), dtype=torch.bool, device=device),
        active=zeros((slots,), torch.bool),
        responses=torch.full((slots, max_new_tokens), cfg.pad_token_id, dtype=torch.int64, device=device),
        logps=zeros((slots, max_new_tokens), torch.float32),
        stage_k=zeros(stage_shape, stage_dtype), stage_v=zeros(stage_shape, stage_dtype),
        stage_seg=zeros((slots, stage_width), torch.int32),
        **scales,
    )


# ---------------------------------------------------------------------------
# prefill: dense scratch cache -> compacted pages
# ---------------------------------------------------------------------------


def prefill_transient_bytes(cfg: Qwen25VLConfig, prompt_len: int, u_batch: int,
                            prefill_rows: int, cell_bytes: int) -> int:
    """Peak transient device memory of one refill prefill, for pool sizing:
    the u_batch x padded-width scratch prompt KV (``cell_bytes`` per token,
    the pool cell's accounting) plus the gate_up activation of the rows in
    flight (rows x P x 2I in bf16), with 25% headroom."""
    t = cfg.text
    width = -(-prompt_len // 256) * 256
    scratch = u_batch * width * cell_bytes
    rows = prefill_rows if 0 < prefill_rows < u_batch else u_batch
    act = rows * prompt_len * 2 * t.intermediate_size * 2
    return int((scratch + act) * 1.25)


class PrefillInstall(NamedTuple):
    """Host-computed scatter plan (fixed shapes per refill-batch geometry)."""

    full_src_row: torch.Tensor   # (T_full,) scratch row per full page
    full_src_pos: torch.Tensor   # (T_full, page) scratch positions
    full_dst: torch.Tensor       # (T_full,) pool page id (0 = unused/dummy)
    tail_src_row: torch.Tensor   # (T_tail,) scratch row per lane tail page
    tail_src_pos: torch.Tensor   # (T_tail, page)
    tail_dst: torch.Tensor       # (T_tail,)
    table_rows: torch.Tensor     # (u*group_n, P_max) page-table rows
    lengths: torch.Tensor        # (u,) prompt lengths (compacted)


def _scatter_pages(pool, scratch_arr, src_row, src_pos, dst, int4: bool = False) -> None:
    """Gather (T, page) tokens out of the scratch cache (L, u, Hkv, P[, D])
    and write them as whole pages ``pool[:, dst]``, in place. int4 scratch is
    already unpacked by the caller; its pages repack split-half per page."""
    g = scratch_arr[:, src_row[:, None], :, src_pos]  # (T, page, L, Hkv[, D])
    if g.dim() == 4:
        g = g.permute(2, 0, 3, 1)                     # (L, T, Hkv, page)
    else:
        g = g.permute(2, 0, 3, 1, 4)                  # (L, T, Hkv, page, D)
    if int4:
        half = g.shape[3] // 2
        g = _pack_nibbles(g[:, :, :, :half], g[:, :, :, half:])
    pool[:, dst] = g.to(pool.dtype)


@torch.no_grad()
def prefill_paged(
    model: Qwen25VL, state: PagedState,
    slot_ids: torch.Tensor,        # (u * group_n,)
    input_ids: torch.Tensor,       # (u, P) left-padded UNIQUE prompts
    segment_ids: torch.Tensor,     # (u, P)
    position_ids: torch.Tensor,    # (3, u, P)
    gen_pos_start: torch.Tensor,   # (u,)
    valid: torch.Tensor,           # (u,) bool
    install: PrefillInstall,
    sampling: SamplingParams,
    generator: torch.Generator,
    vision=None,
    prefill_chunk: int = 0,
    prefill_rows: int = 0,
    group_n: int = 1,
) -> PagedState:
    """Prompt forward for u unique prompts; the prompt KV scatters compacted
    into pool pages (full pages shared by the group's n lanes, tail pages per
    lane) and each lane's slot state initializes."""
    cfg = model.cfg
    t = cfg.text
    u, p = input_ids.shape
    int4 = state.k_pool.dtype == torch.uint8
    max_new = state.responses.shape[1]

    scratch = KVCache.init(t.num_hidden_layers, u, p, kv_heads(model.text), t.head_dim,
                           dtype=state.k_pool.dtype, device=state.k_pool.device)
    seg32 = segment_ids.to(torch.int32)
    hidden, scratch = prefill_forward(
        model, input_ids, position_ids, seg32, scratch, seg32,
        vision=vision, prefill_chunk=prefill_chunk, prefill_rows=prefill_rows,
    )
    last_logits = logits_from_hidden(model.text, hidden[:, -1:, :])[:, 0, :]

    plans = ((install.full_src_row, install.full_src_pos, install.full_dst),
             (install.tail_src_row, install.tail_src_pos, install.tail_dst))
    for pool, src in ((state.k_pool, scratch.k), (state.v_pool, scratch.v)):
        src = _unpack_kv4(src, seq_axis=3) if int4 else src  # (L, u, Hkv, P, D)
        for plan in plans:
            _scatter_pages(pool, src, *plan, int4=int4)
    if state.quantized:
        for pool, src in ((state.k_scale, scratch.k_scale), (state.v_scale, scratch.v_scale)):
            for plan in plans:
                _scatter_pages(pool, src, *plan)

    lengths = install.lengths
    if group_n > 1:
        last_logits = fanout_rows(last_logits, group_n)
        gen_pos_start = fanout_rows(gen_pos_start, group_n)
        valid = fanout_rows(valid, group_n)
        lengths = fanout_rows(lengths, group_n)

    first = sample_tokens(last_logits, generator, sampling)
    first_logp = sampled_token_logp(last_logits, first, sampling)
    finished0 = (first == cfg.eos_token_id) | ~valid

    k = u * group_n
    resp_row = torch.full((k, max_new), cfg.pad_token_id, dtype=torch.int64, device=first.device)
    resp_row[:, 0] = first
    logp_row = torch.zeros((k, max_new), dtype=torch.float32, device=first.device)
    logp_row[:, 0] = first_logp

    state.page_table[slot_ids] = install.table_rows
    state.length[slot_ids] = lengths.to(torch.int32)
    state.cur_tokens[slot_ids] = first
    state.gen_pos[slot_ids] = gen_pos_start.to(torch.int64)
    state.steps[slot_ids] = 1
    state.finished[slot_ids] = finished0
    state.active[slot_ids] = valid
    state.responses[slot_ids] = resp_row
    state.logps[slot_ids] = logp_row
    return state


# ---------------------------------------------------------------------------
# decode over pages
# ---------------------------------------------------------------------------


def _paged_decode_layer(layer, cfg, x, cos, sin, state: PagedState, layer_idx: int,
                        stage_seg: torch.Tensor, int4_i8dot: bool = False,
                        fuse_staged: bool = False) -> torch.Tensor:
    """One decoder layer, one token per slot. The new token's KV is written
    into the staging ring at the uniform index ``state.ring``; the pool kernel
    attends the installed cells and returns (o, m, l); the chunk's staged
    cells attend in one vectorized block over all slots and merge by the
    flash combine — or, with ``fuse_staged``, the pool kernel attends the
    ring cells too and its output is final. The pools are read-only during
    the chunk."""
    int4 = state.k_pool.dtype == torch.uint8
    ring = state.ring
    x2 = x[:, None, :]
    q, knew, vnew = attention_inputs(layer, cfg, x2, cos, sin)

    if state.quantized:
        qfn = _quantize_kv4 if int4 else _quantize_kv
        kq, ks = qfn(knew)  # (S, 1, Hkv, D) / (S, 1, Hkv) — signed values
        vq, vs = qfn(vnew)
        state.stage_k[layer_idx, :, :, ring] = kq[:, 0]
        state.stage_v[layer_idx, :, :, ring] = vq[:, 0]
        state.stage_ks[layer_idx, :, :, ring] = ks[:, 0]
        state.stage_vs[layer_idx, :, :, ring] = vs[:, 0]
    else:
        state.stage_k[layer_idx, :, :, ring] = knew[:, 0].to(state.stage_k.dtype)
        state.stage_v[layer_idx, :, :, ring] = vnew[:, 0].to(state.stage_v.dtype)

    s, d = x.shape[0], q.shape[-1]
    scale = d**-0.5
    qh = q[:, 0].to(x.dtype).contiguous()
    if fuse_staged:
        out = paged_attention(
            qh, state.k_pool, state.v_pool, state.page_table, state.length, layer_idx,
            state.k_scale, state.v_scale, int4_i8dot=int4_i8dot,
            staged=(state.stage_k, state.stage_v, state.stage_ks, state.stage_vs, stage_seg),
        ).to(x.dtype)
        return finish_layer(layer, cfg, x2, out[:, None])[:, 0]
    o1, m1, l1 = paged_attention(
        qh, state.k_pool, state.v_pool, state.page_table, state.length, layer_idx,
        state.k_scale, state.v_scale, return_stats=True, int4_i8dot=int4_i8dot,
    )
    hkv = state.stage_k.shape[2]
    hq = qh.shape[1]
    g = hq // hkv
    k_st = state.stage_k[layer_idx].float()  # (S, Hkv, C, D)
    v_st = state.stage_v[layer_idx].float()
    if state.quantized:
        k_st = k_st * state.stage_ks[layer_idx].float()[..., None]
        v_st = v_st * state.stage_vs[layer_idx].float()[..., None]
    qg = qh.reshape(s, hkv, g, d).float()
    s2 = torch.einsum("shgd,shcd->shgc", qg, k_st) * scale
    mask = (stage_seg > 0)[:, None, None, :]
    s2 = torch.where(mask, s2, torch.full_like(s2, -1e30))
    m2 = s2.amax(dim=3)                              # (S, Hkv, G)
    p2 = torch.where(mask, torch.exp(s2 - m2[..., None]), torch.zeros_like(s2))
    l2 = p2.sum(dim=3)
    o2 = torch.einsum("shgc,shcd->shgd", p2, v_st)   # unnormalized (sums to l2)

    m1r = m1.reshape(s, hkv, g)
    l1r = l1.reshape(s, hkv, g)
    m = torch.maximum(m1r, m2)
    a1 = l1r * torch.exp(m1r - m)
    a2 = torch.exp(m2 - m)
    den = a1 + a2 * l2
    safe = torch.where(den == 0, torch.ones_like(den), den)
    o = (a1[..., None] * o1.reshape(s, hkv, g, d).float() + a2[..., None] * o2) / safe[..., None]
    out = o.reshape(s, hq, d).to(x.dtype)
    return finish_layer(layer, cfg, x2, out[:, None])[:, 0]


@torch.no_grad()
def decode_chunk_paged(model: Qwen25VL, state: PagedState, sampling: SamplingParams,
                       chunk: int, generator: torch.Generator,
                       int4_i8dot: bool = False, fuse_staged: bool = False) -> PagedState:
    """Advance every unfinished slot ``chunk`` tokens. The host guarantees each
    running slot's page table covers length+chunk cells before calling.

    New-token KV accumulates in the staging ring and installs into the pools
    once at the end of the chunk. ``state.length`` stays the INSTALLED cell
    count during the chunk (the pool kernel masks by it); it advances at
    install."""
    cfg = model.cfg
    t = cfg.text
    text = model.text
    device = state.cur_tokens.device
    stage_width = state.stage_seg.shape[1]
    if chunk > stage_width:
        raise ValueError(
            f"decode chunk {chunk} exceeds the staging width {stage_width} "
            "(init_paged_state stage_width must cover the chunk)"
        )
    inv_freq = torch.as_tensor(make_inv_freq(t.head_dim, t.rope_theta), dtype=torch.float32, device=device)
    max_new = state.responses.shape[1]
    s = state.cur_tokens.shape[0]
    cols = torch.arange(max_new, device=device)[None]
    ring_cols = torch.arange(stage_width, device=device)[None]

    for _ in range(chunk):
        run = state.active & ~state.finished
        pos = state.gen_pos[None, :, None].expand(3, s, 1)
        cos, sin = compute_cos_sin(pos, inv_freq, t.mrope_section, dtype=torch.bfloat16)
        x = embed_rows(text.embed_tokens.weight, state.cur_tokens, dtype=text.norm.weight.dtype)
        # mark this step's staged cell valid for running slots only
        state.stage_seg = torch.where(
            run[:, None] & (ring_cols == state.ring), torch.ones_like(state.stage_seg), state.stage_seg
        )
        for i, layer in enumerate(text.layers):
            x = _paged_decode_layer(layer, t, x, cos, sin, state, i, state.stage_seg,
                                    int4_i8dot=int4_i8dot, fuse_staged=fuse_staged)
        hidden = text.norm(x[:, None, :])
        logits = logits_from_hidden(text, hidden)[:, 0, :]

        sampled = sample_tokens(logits, generator, sampling)
        logp = sampled_token_logp(logits, sampled, sampling)

        write_step = state.steps.clamp(0, max_new - 1)
        here = run[:, None] & (cols == write_step[:, None])
        state.responses = torch.where(here, sampled[:, None], state.responses)
        state.logps = torch.where(here, logp[:, None], state.logps)
        newly_finished = run & ((sampled == cfg.eos_token_id) | (state.steps + 1 >= max_new))
        state.ring += 1
        state.cur_tokens = torch.where(run, sampled, state.cur_tokens)
        state.gen_pos = torch.where(run, state.gen_pos + 1, state.gen_pos)
        state.steps = torch.where(run, state.steps + 1, state.steps)
        state.finished = state.finished | newly_finished
    return _install_stage(state)


def _install_stage(state: PagedState) -> PagedState:
    """Move the chunk's staged cells into the pools, in place: one batched
    scatter per pool array, once per chunk. Staged index c of a slot is its
    c-th step of the chunk — running slots form a prefix of the chunk
    (refills only happen between chunks), so the destination cell is
    length + c. Invalid cells are filtered out by a boolean mask."""
    page = state.page
    s, c_width = state.stage_seg.shape
    n_layers, hkv, d = state.k_pool.shape[0], state.k_pool.shape[2], state.k_pool.shape[4]
    int4 = state.k_pool.dtype == torch.uint8
    device = state.stage_seg.device

    valid = (state.stage_seg > 0).reshape(-1)  # (M,) with M = S * C
    counts = state.stage_seg.sum(dim=1).to(state.length.dtype)
    cells = state.length.to(torch.int64)[:, None] + torch.arange(c_width, device=device)[None]
    pg_col = (cells // page).clamp(0, state.page_table.shape[1] - 1)
    pgf = torch.gather(state.page_table.to(torch.int64), 1, pg_col).reshape(-1)[valid]
    offf = (cells % page).reshape(-1)[valid]

    def cell_vals(stg):  # (L, S, Hkv, C, D) -> (M_valid, L, Hkv, D)
        return stg.permute(1, 3, 0, 2, 4).reshape(s * c_width, n_layers, hkv, d)[valid]

    def scale_vals(stg):  # (L, S, Hkv, C) -> (M_valid, L, Hkv)
        return stg.permute(1, 3, 0, 2).reshape(s * c_width, n_layers, hkv)[valid]

    if int4:
        half = page // 2
        rowf = offf % half
        high = offf >= half

        def put4(pool, stg):
            qb = (cell_vals(stg) + KV4_BIAS).to(torch.uint8)  # (M_valid, L, Hkv, D)
            # TWO sequential read-modify-write passes (low nibbles, then high):
            # staged cells c and c + page/2 of one slot land in the SAME byte
            # whenever the chunk spans half a page. Within one pass no two
            # staged cells share a byte (same nibble and same row implies a
            # different page), and the high pass reads the low pass's writes.
            for sel, merge in ((~high, lambda cur, v: (cur & 0xF0) | (v & 0xF)),
                               (high, lambda cur, v: (cur & 0x0F) | (v << 4))):
                pgs, rows = pgf[sel], rowf[sel]
                cur = pool[:, pgs, :, rows]  # (M_sel, L, Hkv, D)
                pool[:, pgs, :, rows] = merge(cur, qb[sel])

        put4(state.k_pool, state.stage_k)
        put4(state.v_pool, state.stage_v)
    else:
        state.k_pool[:, pgf, :, offf] = cell_vals(state.stage_k).to(state.k_pool.dtype)
        state.v_pool[:, pgf, :, offf] = cell_vals(state.stage_v).to(state.v_pool.dtype)
    if state.quantized:
        state.k_scale[:, pgf, :, offf] = scale_vals(state.stage_ks)
        state.v_scale[:, pgf, :, offf] = scale_vals(state.stage_vs)
    state.length = state.length + counts
    state.stage_seg = torch.zeros_like(state.stage_seg)
    state.ring = 0
    return state


# ---------------------------------------------------------------------------
# host orchestration: allocator, refill, preemption
# ---------------------------------------------------------------------------


class PageAllocator:
    """Host-side page pool: free list + refcounts (page 0 reserved dummy)."""

    def __init__(self, total_pages: int):
        self.free: List[int] = list(range(total_pages - 1, 0, -1))
        self.refcount = np.zeros(total_pages, dtype=np.int32)

    def alloc(self, n: int) -> Optional[List[int]]:
        if len(self.free) < n:
            return None
        pages = [self.free.pop() for _ in range(n)]
        self.refcount[pages] = 1
        return pages

    def ref(self, pages: List[int], n: int) -> None:
        self.refcount[pages] += n

    def release(self, pages: List[int]) -> None:
        self.refcount[pages] -= 1
        for p in pages:
            if self.refcount[p] == 0:
                self.free.append(p)

    @property
    def n_free(self) -> int:
        return len(self.free)


class PagedResult(NamedTuple):
    responses: np.ndarray
    response_mask: np.ndarray
    rollout_log_probs: np.ndarray
    stats: dict


def generate_paged(
    model: Qwen25VL,
    input_ids: np.ndarray,       # (B, P) left-padded UNIQUE prompts
    segment_ids: np.ndarray,
    position_ids: np.ndarray,    # (3, B, P)
    gen_pos_start: np.ndarray,
    *,
    max_new_tokens: int,
    sampling: SamplingParams,
    generator: torch.Generator,
    slots: int = 32,
    page_size: int = 128,
    total_pages: int = 0,        # 0 = worst case (slots x pages-per-slot)
    decode_chunk_size: int = 32,
    kv_cache_dtype=torch.bfloat16,  # torch.int8, or torch.uint8 = packed int4
    patches_list=None,
    grids_list=None,
    vision_bucket: int = 0,
    prefill_chunk_size: int = 0,
    max_num_batched_tokens: int = 0,
    prefill_rows: int = 0,       # >0: batch-chunked (rows mode) refill prefill
    refill_batch: int = 0,       # >0: cap unique prompts per refill prefill
    group_n: int = 1,
    int4_i8dot: bool = False,    # int4 pools: both attention dots on int8 operands
    fuse_staged: bool = False,
) -> PagedResult:
    """Generate B*group_n sequences through ``slots`` decode lanes over a
    ``total_pages`` KV page pool, on the device that holds ``model``. Output
    row i*group_n + j is sample j of prompt i. ``stats`` reports page-pool
    telemetry (peak pages, preemptions, total pages), the refill and decode
    chunk counts and the seconds spent in each. ``fuse_staged`` attends the
    staging ring inside the pool kernel instead of merging it after.
    """
    cfg = model.cfg
    device = model.text.norm.weight.device
    input_ids = np.asarray(input_ids)
    segment_ids = np.asarray(segment_ids)
    position_ids = np.asarray(position_ids)
    gen_pos_start = np.asarray(gen_pos_start)

    b, p = input_ids.shape
    n_out = b * group_n
    slots = min(slots, n_out)
    slots = max(slots - slots % group_n, group_n)
    u_batch = slots // group_n
    if refill_batch > 0:
        # cap the prefill batch independently of the slot count: the
        # u_batch x P scratch cache is the transient that competes with the
        # page pool for memory
        u_batch = max(min(u_batch, refill_batch), 1)
    if prefill_rows and prefill_rows < u_batch:
        # rows mode bounds activations by rows*P per group: the chunk budget
        # applies within a row group
        prefill_chunk = effective_prefill_chunk(p, prefill_rows, prefill_chunk_size, max_num_batched_tokens)
    else:
        prefill_rows = 0
        prefill_chunk = effective_prefill_chunk(p, u_batch, prefill_chunk_size, max_num_batched_tokens)
    p_max = -(-(p + max_new_tokens) // page_size) + 1   # table width (pages)
    if total_pages <= 0:
        total_pages = slots * p_max + 1  # +1 dummy
    n_lanes = slots + 1  # +1 trash lane for queue-padding prefill rows
    trash = slots

    def dev(x):
        return torch.as_tensor(np.asarray(x), device=device)

    state = init_paged_state(cfg, n_lanes, total_pages, page_size, p_max, max_new_tokens,
                             kv_cache_dtype, stage_width=decode_chunk_size, device=device,
                             num_kv_heads=kv_heads(model.text))
    allocator = PageAllocator(total_pages)

    responses = np.full((n_out, max_new_tokens), cfg.pad_token_id, dtype=np.int64)
    logps_out = np.zeros((n_out, max_new_tokens), dtype=np.float32)

    # host MIRRORS of the slot status flags: the host makes every scheduling
    # transition itself (install, release, preempt), and a running slot
    # advances exactly decode_chunk_size cells per decode call, so the
    # steady-state loop needs ONE device->host read per chunk — which slots
    # finished. First-token-EOS slots (finished in the prefill itself) are
    # discovered one chunk late: they idle through one decode chunk masked off.
    h_active = np.zeros(n_lanes, dtype=bool)
    h_finished = np.ones(n_lanes, dtype=bool)
    h_length = np.zeros(n_lanes, dtype=np.int64)

    # host bookkeeping per slot
    slot_owner = np.full(n_lanes, -1, dtype=np.int64)     # output-row index
    slot_shared: List[List[int]] = [[] for _ in range(n_lanes)]  # refcounted prompt pages
    slot_own: List[List[int]] = [[] for _ in range(n_lanes)]     # per-lane pages
    slot_capacity = np.zeros(n_lanes, dtype=np.int64)     # cells covered by table
    slot_birth = np.full(n_lanes, -1, dtype=np.int64)     # install order (for LIFO preempt)
    host_table = np.zeros((n_lanes, p_max), dtype=np.int32)
    prompt_lens = segment_ids.sum(-1).astype(np.int64)
    t_full = u_batch * (-(-p // page_size))               # static scatter sizes
    t_tail = u_batch * group_n

    work: List[int] = list(range(b))                      # prompt queue (FIFO)
    stats = {"preemptions": 0, "peak_pages": 0, "total_pages": total_pages - 1,
             "refills": 0, "chunks": 0, "refill_s": 0.0, "decode_s": 0.0}
    birth_counter = 0

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

    def pages_for_prompt(length: int) -> Tuple[int, int]:
        return int(length) // page_size, int(length) % page_size

    def try_reserve(length: int) -> Optional[Tuple[List[int], List[List[int]]]]:
        """Shared full pages + per-lane tail pages for one prompt group."""
        n_full, tail = pages_for_prompt(length)
        need = n_full + (group_n if tail else 0)
        if allocator.n_free < need:
            return None
        shared = allocator.alloc(n_full) or []
        if n_full:
            allocator.ref(shared, group_n - 1)  # one ref per lane
        tails = [allocator.alloc(1) if tail else [] for _ in range(group_n)]
        return shared, tails

    def refill(free_slot_list):
        nonlocal birth_counter
        targets = np.full(u_batch * group_n, trash, dtype=np.int64)
        rows = np.zeros(u_batch, dtype=np.int64)
        valid = np.zeros(u_batch, dtype=bool)
        full_src_row = np.zeros(t_full, dtype=np.int64)
        full_src_pos = np.zeros((t_full, page_size), dtype=np.int64)
        full_dst = np.zeros(t_full, dtype=np.int64)
        tail_src_row = np.zeros(t_tail, dtype=np.int64)
        tail_src_pos = np.zeros((t_tail, page_size), dtype=np.int64)
        tail_dst = np.zeros(t_tail, dtype=np.int64)
        table_rows = np.zeros((u_batch * group_n, p_max), dtype=np.int32)
        lengths = np.zeros(u_batch, dtype=np.int64)
        free = list(free_slot_list)
        fi = 0
        for g in range(u_batch):
            if not work or len(free) < group_n:
                break
            prompt_idx = work[0]
            ell = int(prompt_lens[prompt_idx])
            reserved = try_reserve(ell)
            if reserved is None:
                break  # pool pressure: admit later
            work.pop(0)
            shared, tails = reserved
            n_full, tail = pages_for_prompt(ell)
            rows[g] = prompt_idx
            valid[g] = True
            lengths[g] = ell
            pad = p - ell
            for tpage in range(n_full):
                full_src_row[fi] = g
                full_src_pos[fi] = pad + tpage * page_size + np.arange(page_size)
                full_dst[fi] = shared[tpage]
                fi += 1
            for j in range(group_n):
                slot = free.pop(0)
                lane = g * group_n + j
                targets[lane] = slot
                slot_owner[slot] = prompt_idx * group_n + j
                slot_shared[slot] = list(shared)
                slot_own[slot] = list(tails[j])
                slot_birth[slot] = birth_counter
                row = np.zeros(p_max, dtype=np.int32)
                row[:n_full] = shared
                if tail:
                    row[n_full] = tails[j][0]
                    tail_src_row[lane] = g
                    tail_src_pos[lane] = np.clip(
                        pad + n_full * page_size + np.arange(page_size), 0, p - 1
                    )
                    tail_dst[lane] = tails[j][0]
                host_table[slot] = row
                slot_capacity[slot] = (n_full + (1 if tail else 0)) * page_size
                h_active[slot] = True
                h_finished[slot] = False
                h_length[slot] = ell
            birth_counter += 1
        if not valid.any():
            return free, False
        ids_batch = input_ids[rows].copy()
        seg_batch = segment_ids[rows].copy()
        ids_batch[~valid] = 0
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
        # table rows in lane order (trash lanes keep zeros)
        for lane in range(u_batch * group_n):
            slot = targets[lane]
            if slot != trash:
                table_rows[lane] = host_table[slot]
        install = PrefillInstall(
            full_src_row=dev(full_src_row), full_src_pos=dev(full_src_pos), full_dst=dev(full_dst),
            tail_src_row=dev(tail_src_row), tail_src_pos=dev(tail_src_pos), tail_dst=dev(tail_dst),
            table_rows=dev(table_rows), lengths=dev(lengths),
        )
        prefill_paged(
            model, state, dev(targets), dev(ids_batch), dev(seg_batch),
            dev(position_ids[:, rows]), dev(gen_pos_start[rows]), dev(valid), install,
            sampling, generator, vision,
            prefill_chunk=prefill_chunk, prefill_rows=prefill_rows, group_n=group_n,
        )
        used = int(allocator.refcount[1:].astype(bool).sum())
        stats["peak_pages"] = max(stats["peak_pages"], used)
        return free, True

    def release_slot(slot: int) -> None:
        if slot_shared[slot]:
            allocator.release(slot_shared[slot])
            slot_shared[slot] = []
        for pg in slot_own[slot]:
            allocator.release([pg])
        slot_own[slot] = []
        slot_capacity[slot] = 0
        slot_birth[slot] = -1

    def preempt_youngest(active_mask: np.ndarray) -> None:
        """Free the youngest group's pages, requeue its prompt (recompute)."""
        births = np.where(active_mask, slot_birth, -1)
        youngest = int(births.max())
        oldest_active = int(np.min(np.where(active_mask, slot_birth, np.iinfo(np.int64).max)))
        if youngest < 0 or youngest == oldest_active:
            raise RuntimeError(
                "KV page pool too small for a single sequence at max length: "
                f"raise the pool budget or lower max_new_tokens (pool={total_pages - 1} "
                f"pages x {page_size} tokens)"
            )
        victim_slots = [
            s for s in range(len(active_mask)) if active_mask[s] and slot_birth[s] == youngest
        ]
        prompt_idx = int(slot_owner[victim_slots[0]]) // group_n
        for s in victim_slots:
            release_slot(s)
            slot_owner[s] = -1
            h_finished[s] = True  # keep the mirror in lockstep with the flag
        work.insert(0, prompt_idx)
        stats["preemptions"] += 1
        # finished while still ACTIVE: the next harvest() collects the victim
        # slots into the free pool (owner == -1 skips the response copy; the
        # page release above already happened, release_slot is idempotent).
        # Clearing `active` here instead would leak the lanes out of
        # circulation — every preemption would shrink the decode batch.
        state.finished[dev(np.asarray(victim_slots, dtype=np.int64))] = True

    def ensure_capacity() -> None:
        """Grow running slots' page tables to cover the next decode chunk;
        preempt (youngest-group recompute) on pool exhaustion. Runs entirely
        on the host mirrors — no device fetch."""
        while True:
            run = h_active & ~h_finished
            table_dirty = False
            ok = True
            for s in np.nonzero(run)[0]:
                budget = min(int(h_length[s]) + decode_chunk_size,
                             int(prompt_lens[slot_owner[s] // group_n]) + max_new_tokens)
                while slot_capacity[s] < budget:
                    got = allocator.alloc(1)
                    if got is None:
                        ok = False
                        break
                    pg = got[0]
                    slot_own[s].append(pg)
                    host_table[s, int(slot_capacity[s]) // page_size] = pg
                    slot_capacity[s] += page_size
                    table_dirty = True
                if not ok:
                    break
            if table_dirty:
                state.page_table.copy_(dev(host_table))
            if ok:
                used = int(allocator.refcount[1:].astype(bool).sum())
                stats["peak_pages"] = max(stats["peak_pages"], used)
                return
            preempt_youngest(run)

    def harvest(finished_np) -> List[int]:
        done_slots = [int(i) for i in np.nonzero(finished_np & h_active)[0]]
        if done_slots:
            idx = dev(np.asarray(done_slots, dtype=np.int64))
            resp_rows = state.responses[idx].cpu().numpy()
            logp_rows = state.logps[idx].cpu().numpy()
            for row, slot in enumerate(done_slots):
                owner = slot_owner[slot]
                if owner >= 0:
                    responses[owner] = resp_rows[row]
                    logps_out[owner] = logp_rows[row]
                    slot_owner[slot] = -1
                release_slot(slot)
                h_active[slot] = False
                h_finished[slot] = True
            state.active[idx] = False
        return done_slots

    def refill_all(free_pool):
        # fill every free slot (several refills when refill_batch caps the
        # prefill); a refill that installs nothing (pool pressure) stops it
        installed = True
        while work and len(free_pool) >= group_n and installed:
            t0 = time.perf_counter()
            free_pool, installed = refill(free_pool)
            sync()
            stats["refill_s"] += time.perf_counter() - t0
            stats["refills"] += 1
        return free_pool

    free_pool = refill_all(list(range(slots)))
    while True:
        t0 = time.perf_counter()
        ensure_capacity()
        decode_chunk_paged(model, state, sampling, decode_chunk_size, generator,
                           int4_i8dot=int4_i8dot, fuse_staged=fuse_staged)
        # the one fetch per chunk: which slots finished during it
        running = h_active & ~h_finished
        finished_np = state.finished.cpu().numpy().astype(bool)
        stats["decode_s"] += time.perf_counter() - t0
        stats["chunks"] += 1
        h_finished |= finished_np
        # slots still running advanced exactly the chunk; finished slots'
        # lengths are never read again (their pages release in harvest)
        h_length[running & ~finished_np] += decode_chunk_size
        free_pool.extend(harvest(finished_np))
        free_pool = refill_all(free_pool)
        if not h_active.any() and not work:
            break

    mask = get_response_mask(torch.from_numpy(responses), cfg.eos_token_id).numpy()
    responses_out = np.where(mask == 1, responses, cfg.pad_token_id)
    return PagedResult(
        responses=responses_out, response_mask=mask,
        rollout_log_probs=logps_out * mask, stats=stats,
    )
