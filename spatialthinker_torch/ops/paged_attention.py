"""Paged decode attention: one new token per slot attends its page-table
pages of a global KV page pool — the CUDA kernels
(``csrc/paged_attention.cu``) and their plain PyTorch versions.

Counterpart of ``spatialthinker_tpu/ops/paged_attention.py``. Three pool
formats, all (L, N_pages, Hkv, page, D) head-major with pages holding
compacted tokens (validity is ``cell < length``):

- bf16 pools, and int8 pools with per-cell bf16 scales (L, N, Hkv, page):
  the TPU kernel ``_paged_kernel`` -> ``_launch_pool_kernel``;
- int4 pools (uint8, (L, N, Hkv, page/2, D): byte row r of a page holds cell
  r in its low nibble and cell r + page/2 in its high nibble, +8 biased) with
  both dots on int8 operands (``int4_i8dot=True``): the TPU kernel
  ``_paged_kernel_int4_i8`` -> ``_launch_int4_i8_kernel``; or with the dots on
  the unsigned nibbles widened to floating point (``int4_i8dot=False``): the
  TPU kernel ``_paged_kernel_int4`` -> ``_launch_int4_kernel``.

``staged=`` fuses the decode staging ring into the same call (the TPU
helper ``_staged_block_update`` that #7, #8 and #9 run on their last grid
step): ``(stage_k, stage_v, stage_ks | None, stage_vs | None, stage_seg)``
with stage_k / stage_v (L, S, Hkv, C, D) bf16 under bf16 pools and int8
(never packed) with bf16 per-cell scales (L, S, Hkv, C) under int8 and int4
pools, and stage_seg (S, C) int32 (a cell is live where it is nonzero). After
the last page one more online-softmax block attends the slot's live ring
cells: scores bf16(q) . bf16(k) in fp32 (the float q in every mode), times
(k_scale * scale) or scale, the weights times v_scale rounded to bf16 for
the p . v dot. The returned (m, l) then cover pool and ring cells.

Unused page-table entries point at page 0 (a reserved dummy) and are masked
by the length. The result is (S, Hq, D) and, with ``return_stats``, the
partial-softmax stats (m, l), each (S, Hq) fp32 in scaled-score space, for
callers that merge further cells by the flash combine. A slot of length 0
gives o = 0, m = -1e30, l = 0.

The plain versions walk the table page block by page block with the same
arithmetic as the kernels (bf16-rounded softmax weights; for int4 with int8
dots, q quantized per row and the weights per row per page against the
running max). ``paged_attention_gathered`` is the exact dense-gather reference (the
JAX package's XLA fallback): dequantize, one masked softmax in fp32.

Every mode runs one split kernel under one plan per call (``paged_plan``
with the mode: a slot's pages over a cluster of CTAs, the warps, the ring
depth, the parts a page passes in); the plain versions state their function,
which the split leaves unchanged but for where the bf16 weights are rounded
(against the running max after each part, not after each page) and exp
rounding.

The wrapper runs the plain versions for CPU tensors only. A CUDA tensor
launches the kernel or raises — nothing falls back.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .. import csrc
from .flash_attention import NEG_INF
from .int8_matmul import _stream

KV4_BIAS = 8
KERNEL_HEAD_DIM = 128
KERNEL_MAX_GROUP = 16
KERNEL_MAX_SMEM = 232448  # dynamic shared memory a block may opt in to on sm_90
MODE_BF16, MODE_INT8, MODE_INT4_I8, MODE_INT4 = 0, 1, 2, 3

# the split kernels (``csrc/paged_attention.cu``: ``paged_kernel_int4_i8`` for mode 2,
# ``paged_kernel_split`` for modes 0, 1, 3)
SPLIT_ROWS = 16               # pool rows of a block (mode 2: byte rows, 32 cells, the K of one product)
SPLIT_MAX_CLUSTER = 8         # the portable cluster size
SPLIT_MAX_WARPS = 8
SPLIT_MAX_STAGES = 4
SPLIT_BLOCKS = (1, 2, 4)      # mode 2: blocks a warp takes of a page (of each part of it): the built kernels
SMEM_BUDGET_TWO = 113 * 1024  # a ring this size leaves room for two CTAs an SM

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Staged = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor], torch.Tensor]


def _pool_mode(k_pool: torch.Tensor, k_scale, int4_i8dot: bool) -> int:
    if k_pool.dtype == torch.uint8:
        if k_scale is None:
            raise ValueError("int4 pools need k_scale and v_scale")
        return MODE_INT4_I8 if int4_i8dot else MODE_INT4
    if k_pool.dtype == torch.int8:
        if k_scale is None:
            raise ValueError("int8 pools need k_scale and v_scale")
        return MODE_INT8
    if k_scale is not None:
        raise ValueError(f"scales given for a {k_pool.dtype} pool")
    return MODE_BF16


@dataclass(frozen=True)
class PagedPlan:
    """How a split kernel cuts a call: ``cluster`` CTAs (ranks) per (slot, kv
    head), rank r taking the pages r, r + cluster, ... and the last rank the
    staging ring; ``warps`` warps a CTA, warp w taking the blocks w, w + warps,
    ... (``blocks_per_warp`` at most) of 16 pool rows of a page, or of each of
    its ``parts``; rings of ``stages`` K slots (a page's or a part's K rows and
    its scales) and as many V slots; ``smem`` bytes of shared memory a CTA;
    ``ctas`` CTAs a call. Mode 2: a page with more blocks than warps x 4
    passes in parts through one slot pair, three times. Modes 0, 1, 3: one
    block a warp, a part is ``warps`` blocks and every part is a unit of the
    ring (one streaming pass)."""

    cluster: int
    warps: int
    stages: int
    blocks_per_warp: int
    parts: int
    smem: int
    ctas: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def split_smem(g: int, page: int, ring: int, warps: int, blocks_per_warp: int, stages: int,
               mode: int = MODE_INT4_I8) -> int:
    """Bytes of shared memory of a split-kernel CTA of ``mode``
    (``split_layout`` in the ``.cu`` file). Mode 2: the K slots (K rows, both
    scale vectors) and V slots, the ring's cells (these three later hold the
    warps' partial outputs in rows padded to 33 words; a slot holds at most
    the rows the warps' blocks cover), q in int8 and (with a ring) fp32, the
    warps' int8 weight records, the per-warp row maxima, the per-head
    statistics, the ring's scales and scores, the mbarriers. Modes 0, 1, 3:
    the K slots (a part's K rows; mode 1 its cells' scales, mode 3 its two
    runs of lo and hi cells, or the page's scale vectors where a page is no
    multiple of 16 cells) and V slots, the ring's K and V rows (in whole
    blocks), the same partial outputs over them, the per-warp row maxima of
    two parts, the CTA's m and l, the ring's scales and validity, the
    mbarriers."""
    g16 = 8 if g <= 8 else 16
    d = KERNEL_HEAD_DIM
    if mode != MODE_INT4_I8:
        rb = 2 * d if mode == MODE_BF16 else d
        cap = min(_round_up(page // 2 if mode == MODE_INT4 else page, SPLIT_ROWS), warps * SPLIT_ROWS)
        sbytes = (0 if mode == MODE_BF16 else 2 * cap if mode == MODE_INT8
                  else 4 * cap if page % 16 == 0 else _round_up(2 * page, 16))
        off = stages * (2 * cap * rb + 2 * sbytes) + 2 * _round_up(ring, SPLIT_ROWS) * rb
        off = _round_up(max(off, (warps + 1) * g16 * d * 4 * 33 // 32), 16)
        off += 2 * warps * g16 * 4 + 2 * g16 * 4 + _round_up(ring * 4 * 3, 16)
        return off + (2 * stages + 1) * 8
    kbytes = min(_round_up(page // 2, SPLIT_ROWS), warps * blocks_per_warp * SPLIT_ROWS) * d
    kslot = kbytes + 2 * _round_up(page * 2, 16)
    off = stages * (kslot + kbytes) + 2 * ring * d
    off = _round_up(max(off, (warps + 1) * g16 * d * 4 * 33 // 32), 16)
    off += g16 * d + (g16 * (d + 4) * 4 if ring else 0)
    off += warps * blocks_per_warp * g16 * 32 + 2 * warps * g16 * 4 + 4 * g16 * 4
    off += _round_up(ring * 4 * (3 + g16), 16) + (2 * stages + 1) * 8
    return off


@functools.lru_cache(maxsize=None)
def device_sms(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def paged_plan(slots: int, hkv: int, g: int, page: int, p_max: int, ring: int = 0, *, sms: int,
               cluster: Optional[int] = None, warps: Optional[int] = None,
               stages: Optional[int] = None, mode: int = MODE_INT4_I8) -> PagedPlan:
    """The plan the card runs for ``mode`` (default 2: int4 pools, int8 dots):
    ``slots`` slots, ``hkv`` kv heads of ``g`` query heads, pages of ``page``
    cells, a page table ``p_max`` pages wide, ``ring`` staging-ring cells (0:
    none), on a device of ``sms`` streaming multiprocessors (``device_sms``).
    ``cluster``, ``warps`` and ``stages`` override the choice (for
    measurements and tests). The rule is the measured one of mode 2
    (``time_paged.py --sweep``, PERF.md §6): a CTA costs a few µs before its
    first page, so the cluster splits a slot's pages only where the (slot, kv
    head) pairs leave SMs idle -- up to ``sms`` CTAs a call, at most 8 ranks
    and no more than the table has pages; as many warps as a page has blocks
    of 16 pool rows, up to 8. Mode 2: a page of more blocks than 8 warps x 4
    passes in parts, through one K and one V slot; the deepest ring (up to a
    rank's pages) that keeps a CTA within SMEM_BUDGET_TWO, one slot pair where
    even that does not fit (the ring's depth measured no different). Modes 0,
    1, 3: one block a warp, a page of more blocks passes in parts of ``warps``
    blocks, each part a unit of the ring; the deepest ring (up to a rank's
    parts, at most 4) within the card's shared memory where the call's CTAs
    fit the SMs in one wave, within SMEM_BUDGET_TWO where they do not (two
    CTAs an SM). Raises ValueError for a plan the kernel cannot run; the C
    side refuses the same."""
    if not (1 <= g <= KERNEL_MAX_GROUP and page >= 2 and page % 2 == 0 and slots >= 1 and hkv >= 1
            and p_max >= 1 and ring >= 0 and mode in (MODE_BF16, MODE_INT8, MODE_INT4_I8, MODE_INT4)):
        raise ValueError(f"no split plan for G={g}, page={page}, {slots} slots, P_max={p_max}, ring {ring}, "
                         f"mode {mode}")
    rows = page if mode in (MODE_BF16, MODE_INT8) else page // 2
    blocks = -(-rows // SPLIT_ROWS)
    warps = min(SPLIT_MAX_WARPS, blocks) if warps is None else warps
    if not 1 <= warps <= SPLIT_MAX_WARPS:
        raise ValueError(f"{warps} warps: 1 to {SPLIT_MAX_WARPS} run")
    if mode == MODE_INT4_I8:
        need = -(-blocks // warps)
        bpw = next((b for b in SPLIT_BLOCKS if b >= need), SPLIT_BLOCKS[-1])
    else:
        bpw = 1
    parts = -(-blocks // (warps * bpw))
    if mode == MODE_INT4_I8 and parts > 1 and stages not in (None, 1):
        raise ValueError(f"a page of {page} cells passes in {parts} parts through one slot pair, not {stages}")
    if cluster is None:
        cluster = max(1, min(SPLIT_MAX_CLUSTER, p_max, sms // (slots * hkv)))
    if not 1 <= cluster <= SPLIT_MAX_CLUSTER:
        raise ValueError(f"a cluster of {cluster}: 1 to {SPLIT_MAX_CLUSTER} run")
    ctas = cluster * slots * hkv
    if mode == MODE_INT4_I8 and parts > 1:
        stages = 1
    elif stages is None:
        units = -(-p_max // cluster) * (parts if mode != MODE_INT4_I8 else 1)
        budget = SMEM_BUDGET_TWO if mode == MODE_INT4_I8 or ctas > sms else KERNEL_MAX_SMEM
        stages = next((n for n in range(min(SPLIT_MAX_STAGES, units), 0, -1)
                       if split_smem(g, page, ring, warps, bpw, n, mode) <= budget), 1)
    if not 1 <= stages <= SPLIT_MAX_STAGES:
        raise ValueError(f"a ring of {stages} stages: 1 to {SPLIT_MAX_STAGES} run")
    smem = split_smem(g, page, ring, warps, bpw, stages, mode)
    if smem > KERNEL_MAX_SMEM:
        raise ValueError(f"page {page} with {g} query heads, {ring} ring cells, {warps} warps and {stages} "
                         f"stages needs {smem} bytes of shared memory per block in mode {mode}; the card allows "
                         f"{KERNEL_MAX_SMEM}")
    return PagedPlan(cluster, warps, stages, bpw, parts, smem, ctas)


def _page_cells(k_pool: torch.Tensor) -> int:
    """Token cells per page (an int4 pool stores page/2 packed byte rows)."""
    return k_pool.shape[3] * (2 if k_pool.dtype == torch.uint8 else 1)


def _staged_update(q, m, l, acc, staged: Staged, layer_idx: int, scale: float):
    """The staged block (the TPU helper ``_staged_block_update``): one more
    online-softmax update of (m, l, acc), each (S, Hkv, G[, D]) fp32, over
    the slots' live staging-ring cells."""
    st_k, st_v, st_ks, st_vs, seg = staged
    s_slots, hkv, g, d = acc.shape
    qb = q.reshape(s_slots, hkv, g, d).to(torch.bfloat16).float()
    k = st_k[layer_idx].to(torch.bfloat16).float()  # (S, Hkv, C, D)
    v = st_v[layer_idx].to(torch.bfloat16).float()
    s = torch.einsum("shgd,shcd->shgc", qb, k)
    if st_ks is not None:
        s = s * (st_ks[layer_idx].float() * scale)[:, :, None, :]
    else:
        s = s * scale
    valid = (seg != 0)[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.where(valid, torch.exp(s - m_new[..., None]), torch.zeros_like(s))
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    if st_vs is not None:
        p = p * st_vs[layer_idx].float()[:, :, None, :]
    pv = torch.einsum("shgc,shcd->shgd", p.to(torch.bfloat16).float(), v)
    return m_new, l, acc * corr[..., None] + pv


def _finish(q, m, l, acc, staged, layer_idx, scale) -> Stats:
    """The flush: the staged block if any, then o = acc / l (0 where l = 0)."""
    if staged is not None:
        m, l, acc = _staged_update(q, m, l, acc, staged, layer_idx, scale)
    s_slots, hq, d = q.shape
    safe = torch.where(l == 0, torch.ones_like(l), l)
    out = (acc / safe[..., None]).reshape(s_slots, hq, d).to(q.dtype)
    return out, m.reshape(s_slots, hq), l.reshape(s_slots, hq)


def paged_attention_plain(q, k_pool, v_pool, page_table, lengths, layer_idx,
                          k_scale, v_scale, scale, staged: Optional[Staged] = None) -> Stats:
    """bf16 / int8 pools, page block by page block: fp32 scores (int8 k times
    its cell scale), online softmax against the running max, weights (times
    the v cell scale) rounded to bf16 for the p . v product."""
    s_slots, hq, d = q.shape
    hkv, page = k_pool.shape[2], k_pool.shape[3]
    g = hq // hkv
    quantized = k_scale is not None
    qg = q.reshape(s_slots, hkv, g, d).float()
    kl, vl = k_pool[layer_idx], v_pool[layer_idx]
    m = torch.full((s_slots, hkv, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((s_slots, hkv, g, d), dtype=torch.float32, device=q.device)
    cell = torch.arange(page, device=q.device)
    lengths = lengths.to(torch.int64)
    for pi in range(page_table.shape[1]):
        ids = page_table[:, pi].to(torch.int64)
        k = kl[ids].to(torch.bfloat16).float()  # (S, Hkv, page, D)
        v = vl[ids].to(torch.bfloat16).float()
        s = torch.einsum("shgd,shcd->shgc", qg, k)
        if quantized:
            s = s * (k_scale[layer_idx][ids].float() * scale)[:, :, None, :]
        else:
            s = s * scale
        valid = (pi * page + cell)[None, :] < lengths[:, None]
        valid = valid[:, None, None, :]
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]), torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        if quantized:
            p = p * v_scale[layer_idx][ids].float()[:, :, None, :]
        pv = torch.einsum("shgc,shcd->shgd", p.to(torch.bfloat16).float(), v)
        acc = acc * corr[..., None] + pv
        m = m_new
    return _finish(q, m, l, acc, staged, layer_idx, scale)


def _page_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """(S, Hkv, page/2, D) uint8 -> (S, Hkv, page, D) stored (+8 biased) nibble
    values in page-cell order, fp32."""
    return torch.cat([packed & 15, packed >> 4], dim=2).float()


def paged_attention_int4_plain(q, k_pool, v_pool, page_table, lengths, layer_idx,
                               k_scale, v_scale, scale, staged: Optional[Staged] = None) -> Stats:
    """int4 pools, dots on the unsigned nibbles u = value + 8 (exact in bf16).
    Per page: scores = (q . u - 8 * sum(q)) * (k_scale * scale); online
    softmax; the weights times v_scale are rounded to bf16 for the p . u dot,
    which is debiased by -8 * sum(p) with the UNROUNDED fp32 weights (the
    order the kernels keep)."""
    s_slots, hq, d = q.shape
    hkv, half = k_pool.shape[2], k_pool.shape[3]
    page = 2 * half
    g = hq // hkv
    qg = q.reshape(s_slots, hkv, g, d).float()
    sumq = qg.sum(dim=-1, keepdim=True)
    kl, vl = k_pool[layer_idx], v_pool[layer_idx]
    m = torch.full((s_slots, hkv, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((s_slots, hkv, g, d), dtype=torch.float32, device=q.device)
    cell = torch.arange(page, device=q.device)
    lengths = lengths.to(torch.int64)
    for pi in range(page_table.shape[1]):
        ids = page_table[:, pi].to(torch.int64)
        s = torch.einsum("shgd,shcd->shgc", qg, _page_nibbles(kl[ids])) - KV4_BIAS * sumq
        s = s * (k_scale[layer_idx][ids].float() * scale)[:, :, None, :]
        valid = (pi * page + cell)[None, :] < lengths[:, None]
        valid = valid[:, None, None, :]
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]), torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        p = p * v_scale[layer_idx][ids].float()[:, :, None, :]
        pv = torch.einsum("shgc,shcd->shgd", p.to(torch.bfloat16).float(), _page_nibbles(vl[ids]))
        pv = pv - KV4_BIAS * p.sum(dim=-1, keepdim=True)
        acc = acc * corr[..., None] + pv
        m = m_new
    return _finish(q, m, l, acc, staged, layer_idx, scale)


def paged_attention_int4_i8_plain(q, k_pool, v_pool, page_table, lengths, layer_idx,
                                  k_scale, v_scale, scale, staged: Optional[Staged] = None) -> Stats:
    """int4 pools, both dots on int8 operands. q quantizes per (head, row)
    once; per page the biased nibbles meet it in an integer dot, debiased by
    -8 * sum(q) and rescaled by qscale * (k_scale * scale); the softmax
    weights times v_scale quantize per row per page, and the integer p . v
    dot is debiased by -8 * sum(p) and restored by pscale. The integer
    products run as fp32 matmuls of integer values: every partial sum stays
    below 2**24, so they are exact on any device."""
    s_slots, hq, d = q.shape
    hkv, half = k_pool.shape[2], k_pool.shape[3]
    page = 2 * half
    g = hq // hkv
    qf = q.reshape(s_slots, hkv, g, d).float()
    qa = qf.abs().amax(dim=-1, keepdim=True)
    qscale = torch.clamp(qa, min=1e-8) * (1.0 / 127.0)
    q_i8 = torch.round(qf / qscale)  # integer-valued fp32
    sumq = q_i8.sum(dim=-1, keepdim=True)
    kl, vl = k_pool[layer_idx], v_pool[layer_idx]
    m = torch.full((s_slots, hkv, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((s_slots, hkv, g, d), dtype=torch.float32, device=q.device)
    cell = torch.arange(page, device=q.device)
    lengths = lengths.to(torch.int64)
    nibbles = _page_nibbles

    for pi in range(page_table.shape[1]):
        ids = page_table[:, pi].to(torch.int64)
        s = torch.einsum("shgd,shcd->shgc", q_i8, nibbles(kl[ids]))
        s = (s - KV4_BIAS * sumq) * qscale
        s = s * (k_scale[layer_idx][ids].float() * scale)[:, :, None, :]
        valid = (pi * page + cell)[None, :] < lengths[:, None]
        valid = valid[:, None, None, :]
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]), torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        p = p * v_scale[layer_idx][ids].float()[:, :, None, :]
        pscale = torch.clamp(p.amax(dim=-1, keepdim=True), min=1e-20) * (1.0 / 127.0)
        p_i8 = torch.round(p / pscale)
        sump = p_i8.sum(dim=-1, keepdim=True)
        pv = torch.einsum("shgc,shcd->shgd", p_i8, nibbles(vl[ids]))
        pv = (pv - KV4_BIAS * sump) * pscale
        acc = acc * corr[..., None] + pv
        m = m_new
    return _finish(q, m, l, acc, staged, layer_idx, scale)


def paged_attention_gathered(q, k_pool, v_pool, page_table, lengths, layer_idx,
                             k_scale=None, v_scale=None, scale=None,
                             staged: Optional[Staged] = None) -> Stats:
    """Exact reference for any pool format: gather the slot's pages to a dense
    (S, Hkv, P_max*page, D) view, dequantize, one masked softmax in fp32
    (with ``staged``, over the pool cells and the live ring cells together)."""
    s_slots, hq, d = q.shape
    scale = scale if scale is not None else d**-0.5
    hkv = k_pool.shape[2]
    int4 = k_pool.dtype == torch.uint8
    page = _page_cells(k_pool)
    p_max = page_table.shape[1]
    g = hq // hkv
    ids = page_table.reshape(-1).to(torch.int64)

    def gather(pool, unpack4=False):
        lay = pool[layer_idx][ids]  # (S*P_max, Hkv, rows, ...)
        if unpack4:
            lay = torch.cat([(lay & 15).to(torch.int8) - KV4_BIAS,
                             (lay >> 4).to(torch.int8) - KV4_BIAS], dim=2)
        lay = lay.reshape(s_slots, p_max, hkv, page, *lay.shape[3:])
        return lay.movedim(2, 1).reshape(s_slots, hkv, p_max * page, *lay.shape[4:])

    k_l, v_l = gather(k_pool, int4).float(), gather(v_pool, int4).float()
    if k_scale is not None:
        # dequantized values round to q's dtype, as the fallback's do
        k_l = (k_l * gather(k_scale).float()[..., None]).to(q.dtype).float()
        v_l = (v_l * gather(v_scale).float()[..., None]).to(q.dtype).float()
    mask = torch.arange(p_max * page, device=q.device)[None, :] < lengths.to(torch.int64)[:, None]
    mask = mask[:, None, None, :]
    if staged is not None:
        st_k, st_v, st_ks, st_vs, seg = staged
        k_st, v_st = st_k[layer_idx].float(), st_v[layer_idx].float()  # (S, Hkv, C, D)
        if st_ks is not None:
            k_st = k_st * st_ks[layer_idx].float()[..., None]
            v_st = v_st * st_vs[layer_idx].float()[..., None]
        k_l, v_l = torch.cat([k_l, k_st], dim=2), torch.cat([v_l, v_st], dim=2)
        mask = torch.cat([mask, (seg != 0)[:, None, None, :]], dim=3)
    qg = q.reshape(s_slots, hkv, g, d).float()
    s = torch.einsum("shgd,shtd->shgt", qg, k_l) * scale
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=3)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=3)
    safe = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("shgt,shtd->shgd", p, v_l) / safe[..., None]
    return out.reshape(s_slots, hq, d).to(q.dtype), m.reshape(s_slots, hq), l.reshape(s_slots, hq)


def _check_staged(staged: Staged, q, k_pool, mode: int):
    """Shapes and types of the staging ring; returns its tensors for the launch."""
    st_k, st_v, st_ks, st_vs, seg = staged
    s_slots = q.shape[0]
    n_layers, _, hkv, _, d = k_pool.shape
    if st_k.dim() != 5 or st_k.shape != st_v.shape:
        raise ValueError(f"stage_k / stage_v shapes {tuple(st_k.shape)}/{tuple(st_v.shape)}")
    c = st_k.shape[3]
    if tuple(st_k.shape) != (n_layers, s_slots, hkv, c, d) or c < 1:
        raise ValueError(f"the ring must be ({n_layers}, {s_slots}, {hkv}, C, {d}), got {tuple(st_k.shape)}")
    if tuple(seg.shape) != (s_slots, c):
        raise ValueError(f"stage_seg must be ({s_slots}, {c}), got {tuple(seg.shape)}")
    tensors = [("stage_k", st_k, torch.bfloat16 if mode == MODE_BF16 else torch.int8),
               ("stage_v", st_v, torch.bfloat16 if mode == MODE_BF16 else torch.int8),
               ("stage_seg", seg, torch.int32)]
    if mode != MODE_BF16:
        for name, t in (("stage_ks", st_ks), ("stage_vs", st_vs)):
            if t is None or tuple(t.shape) != tuple(st_k.shape[:4]):
                raise ValueError(f"{name} must be {tuple(st_k.shape[:4])} under quantized pools")
            tensors.append((name, t, torch.bfloat16))
    return tensors


def _check_cuda_inputs(q, k_pool, v_pool, page_table, lengths, layer_idx, k_scale, v_scale,
                       mode: int, staged: Optional[Staged] = None) -> None:
    csrc.refuse_sharded(q=q, k_pool=k_pool, v_pool=v_pool, page_table=page_table, lengths=lengths,
                        k_scale=k_scale, v_scale=v_scale)
    s_slots, hq, d = q.shape
    if k_pool.dim() != 5 or k_pool.shape != v_pool.shape or k_pool.dtype != v_pool.dtype:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    n_layers, n_pages, hkv, _, pd = k_pool.shape
    page = _page_cells(k_pool)
    if d != KERNEL_HEAD_DIM or pd != d:
        raise ValueError(f"paged kernel takes head dim {KERNEL_HEAD_DIM}, got q {d} / pool {pd}")
    if hq % hkv or hq // hkv > KERNEL_MAX_GROUP:
        raise ValueError(f"paged kernel takes query groups up to {KERNEL_MAX_GROUP}, got {hq}/{hkv}")
    if page % 2:
        raise ValueError(f"paged kernel takes even page sizes, got {page}")
    if not 0 <= layer_idx < n_layers:
        raise ValueError(f"layer {layer_idx} outside the {n_layers}-layer pool")
    if s_slots < 1 or page_table.dim() != 2 or page_table.shape[0] != s_slots:
        raise ValueError(f"page_table {tuple(page_table.shape)} does not fit {s_slots} slots")
    if tuple(lengths.shape) != (s_slots,):
        raise ValueError(f"lengths must be ({s_slots},), got {tuple(lengths.shape)}")
    pool_dtype = (torch.bfloat16, torch.int8, torch.uint8, torch.uint8)[mode]
    tensors = [("q", q, torch.bfloat16), ("k_pool", k_pool, pool_dtype),
               ("v_pool", v_pool, pool_dtype), ("page_table", page_table, torch.int32),
               ("lengths", lengths, torch.int32)]
    if mode != MODE_BF16:
        want = (n_layers, n_pages, hkv, page)
        if tuple(k_scale.shape) != want or tuple(v_scale.shape) != want:
            raise ValueError(f"scales must be {want}, got {tuple(k_scale.shape)}/{tuple(v_scale.shape)}")
        tensors += [("k_scale", k_scale, torch.bfloat16), ("v_scale", v_scale, torch.bfloat16)]
    if staged is not None:
        tensors += _check_staged(staged, q, k_pool, mode)
    for name, t, dtype in tensors:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _launch(q, k_pool, v_pool, page_table, lengths, layer_idx, k_scale, v_scale, scale,
            staged: Optional[Staged], mode: int, plan: Optional[PagedPlan] = None) -> Stats:
    """One launch of the split kernel of ``mode`` under ``plan`` (default
    ``paged_plan`` of the call's shapes)."""
    _check_cuda_inputs(q, k_pool, v_pool, page_table, lengths, layer_idx, k_scale, v_scale, mode,
                       staged)
    s_slots, hq, d = q.shape
    n_pages, hkv = k_pool.shape[1], k_pool.shape[2]
    page = _page_cells(k_pool)
    c = 0 if staged is None else staged[0].shape[3]
    plan = plan or paged_plan(s_slots, hkv, hq // hkv, page, page_table.shape[1], c,
                              sms=device_sms(q.device.index), mode=mode)
    out = torch.empty_like(q)
    m, l = torch.empty((2, s_slots, hq), dtype=torch.float32, device=q.device)  # one allocation

    def ptr(t):
        return None if t is None else t.data_ptr()

    ring = (None,) * 5 if staged is None else staged
    args = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ptr(k_scale), ptr(v_scale),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
            *(ptr(t) for t in ring),
            s_slots, hq, hkv, page, d, page_table.shape[1], n_pages, int(layer_idx), mode, c,
            plan.cluster, plan.warps, plan.stages, plan.blocks_per_warp, float(scale))
    lib = csrc.library()
    if q.device.index == torch.cuda.current_device():
        rc = lib.st_paged_attention(*args, _stream(q.device))
    else:
        with torch.cuda.device(q.device):
            rc = lib.st_paged_attention(*args, _stream(q.device))
    csrc.check_launch(rc, "paged attention")
    if staged is not None:
        _launch.staged_launches += 1
    return out, m, l


def _launch_pool_kernel(*args, mode: int, plan: Optional[PagedPlan] = None) -> Stats:
    """bf16 / int8 pools (modes 0 and 1 of the split kernel, under ``plan``)."""
    res = _launch(*args, mode=mode, plan=plan)
    _launch_pool_kernel.launches += 1
    return res


def _launch_int4_i8_kernel(*args, plan: Optional[PagedPlan] = None) -> Stats:
    """int4 pools with int8 dots (mode 2: the split kernel, under ``plan``)."""
    res = _launch(*args, mode=MODE_INT4_I8, plan=plan)
    _launch_int4_i8_kernel.launches += 1
    return res


def _launch_int4_kernel(*args, plan: Optional[PagedPlan] = None) -> Stats:
    """int4 pools with the dots on the widened nibbles (mode 3 of the split
    kernel, under ``plan``)."""
    res = _launch(*args, mode=MODE_INT4, plan=plan)
    _launch_int4_kernel.launches += 1
    return res


_launch.staged_launches = 0  # launches of any mode that ran the staged block
_launch_pool_kernel.launches = 0
_launch_int4_i8_kernel.launches = 0
_launch_int4_kernel.launches = 0


def paged_attention(
    q: torch.Tensor,           # (S, Hq, D) — one new token per slot
    k_pool: torch.Tensor,      # (L, N_pages, Hkv, page, D) bf16 | int8; uint8 (.., page/2, D) int4
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # (S, P_max) int32 — pool page ids per slot
    lengths: torch.Tensor,     # (S,) int32 — valid (compacted) cells per slot
    layer_idx: int,
    k_scale: Optional[torch.Tensor] = None,  # (L, N_pages, Hkv, page) bf16 — int8 / int4 pools
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    return_stats: bool = False,
    int4_i8dot: bool = False,
    staged: Optional[Staged] = None,
):
    """Attention of one decode token per slot over its page-table pages of
    layer ``layer_idx`` and, with ``staged``, the slot's live staging-ring
    cells. Returns (S, Hq, D); with ``return_stats`` also the partial-softmax
    stats (m, l), each (S, Hq)."""
    mode = _pool_mode(k_pool, k_scale, int4_i8dot)
    if staged is not None and (staged[2] is None) != (mode == MODE_BF16):
        raise ValueError("ring scales (stage_ks, stage_vs) come with quantized pools, and only with them")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    args = (q, k_pool, v_pool, page_table, lengths, layer_idx, k_scale, v_scale, scale, staged)
    if not q.is_cuda:
        if mode == MODE_INT4_I8:
            out = paged_attention_int4_i8_plain(*args)
        elif mode == MODE_INT4:
            out = paged_attention_int4_plain(*args)
        else:
            out = paged_attention_plain(*args)
    elif mode == MODE_INT4_I8:
        out = _launch_int4_i8_kernel(*args)
    elif mode == MODE_INT4:
        out = _launch_int4_kernel(*args)
    else:
        out = _launch_pool_kernel(*args, mode=mode)
    return out if return_stats else out[0]
