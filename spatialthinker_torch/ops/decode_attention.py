"""Decode attention over the stacked dense KV cache: the CUDA kernels
(``csrc/decode_attention.cu``) and their plain PyTorch versions.

Counterpart of ``spatialthinker_tpu/ops/decode_attention.py``. One query
token per row attends layer ``layer_idx`` of the (L, B, Hkv, S, D) cache;
``kv_seg`` (B, S) marks valid cells (left padding and the unwritten decode
tail are 0). The query is the newest token, so causality is exactly "attend
every valid cell". Rows with no valid cell give zeros. Four cache formats:

- bf16 (the TPU kernel ``_decode_kernel``) -> ``decode_attention.launches``;
- int8 values with per-cell bf16 scales (L, B, Hkv, S) (``_decode_kernel``,
  ``quantized=True``) -> ``_launch_int8_kernel``;
- int4 (uint8, (L, B, Hkv, S/2, D): byte row r holds token r in its low
  nibble and token r + S/2 in its high nibble, +8 biased, split-half over the
  whole cache width) with the dots on the unsigned nibbles widened to
  floating point (``_decode_kernel_int4``) -> ``_launch_int4_kernel``;
- int4 with both dots on int8 operands (``int4_i8dot=True``,
  ``_decode_kernel_int4_i8``) -> ``_launch_int4_i8_kernel``. Its softmax
  weights are rounded to int8 against the largest weight of their BLOCK of
  packed byte rows, so the block is part of the function: ``int4_block_rows``
  states the one rule (the TPU kernel's tiling) that kernel and plain version
  share.

All four run one kernel design under one plan per call, ``decode_plan``: the
tiles of a (row, kv head) stripe (64 tokens; int4: 64 byte rows, 128 tokens)
over a cluster of CTAs where the pairs leave CTA slots idle (int4: whole
blocks a rank), tiles without a valid cell skipped, each CTA's four consumer
warps met in warp order and then in rank order. The int8-dot mode keeps a
block's scores in registers and refuses a block of more than 256 byte rows
(a width whose packed row count is no multiple of 128 and exceeds 256).

The wrapper runs the plain versions for CPU tensors only. A CUDA tensor
launches a kernel or raises — nothing falls back.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch

from .. import csrc
from .flash_attention import NEG_INF
from .int8_matmul import _stream
from .paged_attention import SMEM_BUDGET_TWO, device_sms

KV4_BIAS = 8
KERNEL_HEAD_DIMS = (128,)  # text heads of the 3B/7B presets
D_KERNEL = KERNEL_HEAD_DIMS[0]
KERNEL_MAX_GROUP = 16
KERNEL_MAX_SMEM = 232448  # dynamic shared memory a block may opt in to on sm_90
MODE_BF16, MODE_INT8, MODE_INT4, MODE_INT4_I8 = 0, 1, 2, 3

# the split kernel (``csrc/decode_attention.cu`` ``decode_split_kernel``, ``decode_int4_kernel``)
SPLIT_TILE = 64           # tokens a ring slot holds (int4: packed byte rows)
SPLIT_CONSUMERS = 4       # consumer warps a CTA, 16 rows of a tile each (one producer warp more)
SPLIT_MAX_CLUSTER = 8     # the portable cluster size
SPLIT_MAX_STAGES = 4      # modes 0 and 1; the deepest ring the rule picks in modes 2 and 3 below 256-row blocks
INT4_MAX_STAGES = 8       # mode 3 holds a block's tiles in the ring until its p . v
BLOCK_TILES = 4           # mode 3's largest block (256 byte rows; its scores stay in registers)
SPLIT_BOX_BYTES = 8192    # a 64-row x 128-byte TMA box
SPLIT_PART_STRIDE = 132   # floats per head row of the partial outputs
SMEM_PER_SM = 233472      # shared memory of an H100 SM; each resident CTA also takes 1 KB of it


@dataclass(frozen=True)
class DecodePlan:
    """How the split kernel cuts a call: ``cluster`` CTAs (ranks) per (row, kv
    head), rank r taking the 64-token tiles r, r + cluster, ... (int4: the
    blocks of ``block_rows`` packed rows, 0 in modes 0 and 1); a ring of
    ``stages`` slots; ``smem`` bytes of shared memory a CTA; ``ctas`` CTAs a
    call."""

    cluster: int
    stages: int
    smem: int
    ctas: int
    block_rows: int = 0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def split_smem(mode: int, g: int, stages: int) -> int:
    """Bytes of shared memory of a split-kernel CTA (``split_layout`` in the
    ``.cu`` file): the ring's slots (K and V boxes, the tile's scale runs --
    two, int4 four; 1024-byte aligned), which later hold the consumer warps'
    partial outputs and the CTA's sum of them; the slots' headers; per warp
    and head m, l and a combine weight, per head the CTA's m and l and the
    ranks' weights; int4: per slot the 128-bit mask, q8, per head qscale and
    8 sum(q), the block maxima and the warps' int8 weight records
    (``int4_region``); the mbarriers; 1 KB to align the ring."""
    g16 = 8 if g <= 8 else 16
    int4 = mode in (MODE_INT4, MODE_INT4_I8)
    if int4:
        slot = _round_up(2 * SPLIT_BOX_BYTES + 4 * SPLIT_TILE * 2, 1024)
    else:
        slot = _round_up((4 if mode == MODE_BF16 else 2) * SPLIT_BOX_BYTES + 2 * SPLIT_TILE * 2, 1024)
    off = max(stages * slot, (SPLIT_CONSUMERS + 1) * g16 * SPLIT_PART_STRIDE * 4)
    off += stages * 16
    off += (3 * SPLIT_CONSUMERS + 2 + SPLIT_MAX_CLUSTER + 1) * g16 * 4
    if int4:
        off += (stages * 16 + g16 * (D_KERNEL + 16) + 2 * g16 * 4 + 2 * SPLIT_CONSUMERS * g16 * 2 * 4
                + SPLIT_CONSUMERS * g16 * 32)
    return _round_up(off, 8) + 2 * stages * 8 + 1024


def ring_fit(mode: int, g: int, block_tiles: int = 1) -> int:
    """The deepest ring (2 to 4 slots; mode 3 up to two blocks of
    ``block_tiles`` tiles, at most 8) that keeps a CTA within
    SMEM_BUDGET_TWO: 3 slots in bf16, 4 in int8 and int4 (6 for mode 3's
    256-row blocks); mode 3 never below one block."""
    cap = min(INT4_MAX_STAGES, max(SPLIT_MAX_STAGES, 2 * block_tiles)) if mode == MODE_INT4_I8 else SPLIT_MAX_STAGES
    fit = next((n for n in range(cap, 2, -1) if split_smem(mode, g, n) <= SMEM_BUDGET_TWO), 2)
    return max(fit, block_tiles) if mode == MODE_INT4_I8 else fit


def cta_slots(mode: int, g: int, sms: int, block_tiles: int = 1) -> int:
    """CTAs the device holds at once under ``ring_fit``'s ring: ``sms`` times
    the CTAs an SM's shared memory holds (2 in bf16, 3 in int8 and int4 at
    G <= 8, 2 at mode 3's 256-row blocks). At G <= 8 the int4 kernels' registers
    hold as many (launch bounds of three CTAs an SM); at G > 8 they hold
    fewer, which the rule does not count (no path runs G > 8)."""
    return sms * max(1, SMEM_PER_SM // (split_smem(mode, g, ring_fit(mode, g, block_tiles)) + 1024))


@functools.lru_cache(maxsize=None)
def decode_plan(b: int, hkv: int, g: int, s: int, mode: int, *, sms: int,
                cluster: Optional[int] = None, stages: Optional[int] = None) -> DecodePlan:
    """The plan the card runs for a bf16 (``mode`` 0), int8 (1) or int4 (2,
    3) cache: ``b`` rows, ``hkv`` kv heads of ``g`` query heads, a cache ``s``
    tokens wide (int4: twice its packed rows), on a device of ``sms``
    streaming multiprocessors (``device_sms``). ``cluster`` and ``stages``
    override the choice (for measurements and tests). The rule is the
    measured one (``time_decode.py --sweep``, PERF.md §6): a CTA walks its
    tiles one after another behind a fixed cost of several µs, and the CTAs
    an SM holds at once overlap, so the cluster splits a stripe's units -- its
    tiles; int4: its blocks of ``int4_block_rows`` packed rows, whole -- as
    far as the (row, kv head) pairs leave CTA slots idle (``cta_slots``), at
    most 8 ranks and no more than the stripe has units; the ring is
    ``ring_fit``'s, no deeper than a rank's tiles (at least 2 slots; mode 3
    at least a block). Raises ValueError for a plan the kernel cannot run
    (mode 3: a block of more than 256 rows); the C side refuses the same."""
    int4 = mode in (MODE_INT4, MODE_INT4_I8)
    if (mode not in (MODE_BF16, MODE_INT8) and not int4) or not 1 <= g <= KERNEL_MAX_GROUP or min(b, hkv, s) < 1 \
            or (int4 and s % 2):
        raise ValueError(f"no split plan for mode {mode}, G={g}, {b} rows x {hkv} kv heads, width {s}")
    block_rows, block_tiles = 0, 1
    tiles = -(-s // SPLIT_TILE)
    if int4:
        block_rows = int4_block_rows(s // 2)
        tiles, block_tiles = -(-(s // 2) // SPLIT_TILE), -(-block_rows // SPLIT_TILE)
        if mode == MODE_INT4_I8 and block_tiles > BLOCK_TILES:
            raise ValueError(
                f"an int4 cache of width {s} is one block of {block_rows} byte rows (its row count is no "
                f"multiple of 128); the int8-dot kernel keeps a block's scores in registers, at most "
                f"{BLOCK_TILES * SPLIT_TILE} rows")
    units = -(-tiles // block_tiles)
    if cluster is None:
        cluster = max(1, min(SPLIT_MAX_CLUSTER, units, cta_slots(mode, g, sms, block_tiles) // (b * hkv)))
    if not 1 <= cluster <= SPLIT_MAX_CLUSTER:
        raise ValueError(f"a cluster of {cluster}: 1 to {SPLIT_MAX_CLUSTER} run")
    if stages is None:
        stages = min(ring_fit(mode, g, block_tiles), max(2, -(-units // cluster) * block_tiles))
        if mode == MODE_INT4_I8:
            stages = max(stages, block_tiles)
    max_stages = INT4_MAX_STAGES if int4 else SPLIT_MAX_STAGES
    if not 1 <= stages <= max_stages or (mode == MODE_INT4_I8 and stages < block_tiles):
        raise ValueError(f"a ring of {stages} stages: 1 to {max_stages} run"
                         + (f", at least a block's {block_tiles} tiles" if mode == MODE_INT4_I8 else ""))
    smem = split_smem(mode, g, stages)
    if smem > KERNEL_MAX_SMEM:
        raise ValueError(f"{stages} stages at G={g} need {smem} bytes of shared memory per block; the card "
                         f"allows {KERNEL_MAX_SMEM}")
    return DecodePlan(cluster, stages, smem, cluster * b * hkv, block_rows)


def int4_block_rows(packed_rows: int) -> int:
    """Packed byte rows per block of an int4 cache with ``packed_rows`` = S/2
    rows per stripe. The JAX package's rule: the largest of 512 / 384 / 256 /
    128 that divides the row count, capped at 256 when 256 divides it and at
    128 otherwise. Widths whose row count is no multiple of 128 (which the
    JAX package sends to its exact fallback) are one block."""
    for cand in (512, 384, 256, 128):
        if packed_rows % cand == 0:
            return min(cand, 256 if packed_rows % 256 == 0 else 128)
    return packed_rows


def _cache_mode(k_cache: torch.Tensor, k_scale, int4_i8dot: bool) -> int:
    if k_cache.dtype == torch.uint8:
        if k_scale is None:
            raise ValueError("an int4 cache needs k_scale and v_scale")
        return MODE_INT4_I8 if int4_i8dot else MODE_INT4
    if k_cache.dtype == torch.int8:
        if k_scale is None:
            raise ValueError("an int8 cache needs k_scale and v_scale")
        return MODE_INT8
    if k_scale is not None:
        raise ValueError(f"scales given for a {k_cache.dtype} cache")
    return MODE_BF16


def _nibbles(packed: torch.Tensor) -> torch.Tensor:
    """(B, Hkv, S/2, D) uint8 -> (B, Hkv, S, D) stored (+8 biased) nibble values
    in token order, fp32."""
    return torch.cat([packed & 15, packed >> 4], dim=2).float()


def decode_attention_plain(
    q: torch.Tensor,        # (B, Hq, D)
    k_cache: torch.Tensor,  # (L, B, Hkv, S, D); int4: (L, B, Hkv, S/2, D) uint8
    v_cache: torch.Tensor,
    kv_seg: torch.Tensor,   # (B, S)
    layer_idx: int,
    scale: float,
    k_scale: Optional[torch.Tensor] = None,  # (L, B, Hkv, S)
    v_scale: Optional[torch.Tensor] = None,
    int4_i8dot: bool = False,
) -> torch.Tensor:
    """Reference for every cache format: fp32 masked softmax over the layer's
    cells (a view of the stack, not a copy), with the kernels' roundings:

    - bf16: normalised weights cast to the cache dtype for the p . v product;
    - int8: scores = q . k * (k_scale * scale); weights * v_scale rounded to
      bf16 for the product with the int8 values;
    - int4: scores = (q . u - 8 * sum(q)) * (k_scale * scale) on the unsigned
      nibbles u; weights * v_scale rounded to bf16 for p . u, debiased by
      -8 * sum(p) with the UNROUNDED fp32 weights (the order the kernels keep);
    - int4 with ``int4_i8dot``: q rounded to int8 per (row, head); the weights
      * v_scale rounded to int8 per head per block of ``int4_block_rows`` byte
      rows against that block's largest weight (the ratio does not depend on
      the running max, so one global softmax gives the kernel's integers);
      both dots are integer dots (exact as fp32 matmuls of integer values).
    """
    mode = _cache_mode(k_cache, k_scale, int4_i8dot)
    b, hq, d = q.shape
    k, v = k_cache[layer_idx], v_cache[layer_idx]
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    valid = (kv_seg != 0)[:, None, None, :]
    if mode in (MODE_INT4, MODE_INT4_I8):
        k, v = _nibbles(k), _nibbles(v)
    if mode == MODE_INT4_I8:
        qscale = torch.clamp(qg.abs().amax(dim=-1, keepdim=True), min=1e-8) * (1.0 / 127.0)
        qg = torch.round(qg / qscale)  # integer-valued fp32
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k.float())
    if mode == MODE_BF16:
        s = s * scale
    else:
        if mode != MODE_INT8:
            s = s - KV4_BIAS * qg.sum(dim=-1, keepdim=True)
        if mode == MODE_INT4_I8:
            s = s * qscale
        s = s * (k_scale[layer_idx].float() * scale)[:, :, None, :]
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid  # fully masked rows: all weights zero
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    if mode == MODE_BF16:
        # the normalised weights are cast to the cache dtype (the quantized
        # modes below round the max-relative weights, as their kernels do)
        out = torch.einsum("bhgs,bhsd->bhgd", (p / safe_l).to(v.dtype).float(), v.float())
        return out.reshape(b, hq, d).to(q.dtype)
    p = p * v_scale[layer_idx].float()[:, :, None, :]
    if mode == MODE_INT4_I8:
        rows = int4_block_rows(p.shape[-1] // 2)
        # (.., halves, blocks, rows): block i = byte rows [i*rows, ..) of both halves
        pb = p.reshape(*p.shape[:-1], 2, -1, rows)
        pscale = torch.clamp(pb.amax(dim=(-3, -1), keepdim=True), min=1e-20) * (1.0 / 127.0)
        p_i8 = torch.round(pb / pscale)
        pv = torch.einsum("bhgnkr,bhnkrd->bhgkd", p_i8, v.reshape(b, hkv, 2, -1, rows, d))
        pv = pv - KV4_BIAS * p_i8.sum(dim=(-3, -1)).unsqueeze(-1)
        out = (pv * pscale[..., 0, :, :]).sum(dim=-2)
    else:
        out = torch.einsum("bhgs,bhsd->bhgd", p.to(torch.bfloat16).float(), v.float())
        if mode == MODE_INT4:
            out = out - KV4_BIAS * p.sum(dim=-1, keepdim=True)
    return (out / safe_l).reshape(b, hq, d).to(q.dtype)


def _check_cuda_inputs(q, k_cache, v_cache, kv_seg, layer_idx, k_scale, v_scale, mode: int) -> None:
    csrc.refuse_sharded(q=q, k_cache=k_cache, v_cache=v_cache, kv_seg=kv_seg, k_scale=k_scale,
                        v_scale=v_scale)
    b, hq, d = q.shape
    if k_cache.dim() != 5 or k_cache.shape != v_cache.shape or k_cache.dtype != v_cache.dtype:
        raise ValueError(f"cache shapes {tuple(k_cache.shape)}/{tuple(v_cache.shape)}")
    n_layers, cb, hkv, rows, cd = k_cache.shape
    int4 = mode in (MODE_INT4, MODE_INT4_I8)
    s = 2 * rows if int4 else rows  # token width
    if cb != b or cd != d:
        raise ValueError(f"cache {tuple(k_cache.shape)} does not fit q {tuple(q.shape)}")
    if hq % hkv or hq // hkv > KERNEL_MAX_GROUP:
        raise ValueError(f"decode kernel takes query groups up to {KERNEL_MAX_GROUP}, got {hq}/{hkv}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"decode kernel takes head dims {KERNEL_HEAD_DIMS}, got {d}")
    if not 0 <= layer_idx < n_layers:
        raise ValueError(f"layer {layer_idx} outside the {n_layers}-layer cache")
    if min(b, s) < 1:
        raise ValueError("decode kernel needs a non-empty batch and cache")
    if tuple(kv_seg.shape) != (b, s):
        raise ValueError(f"kv_seg must be {(b, s)}, got {tuple(kv_seg.shape)}")
    cache_dtype = (torch.bfloat16, torch.int8, torch.uint8, torch.uint8)[mode]
    tensors = [("q", q, torch.bfloat16), ("k_cache", k_cache, cache_dtype),
               ("v_cache", v_cache, cache_dtype), ("kv_seg", kv_seg, torch.int32)]
    if mode != MODE_BF16:
        want = (n_layers, b, hkv, s)
        if tuple(k_scale.shape) != want or tuple(v_scale.shape) != want:
            raise ValueError(f"scales must be {want}, got {tuple(k_scale.shape)}/{tuple(v_scale.shape)}")
        tensors += [("k_scale", k_scale, torch.bfloat16), ("v_scale", v_scale, torch.bfloat16)]
    for name, t, dtype in tensors:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _launch(q, k_cache, v_cache, kv_seg, layer_idx, scale, k_scale, v_scale, mode: int,
            plan: Optional[DecodePlan] = None) -> torch.Tensor:
    """One launch of the split kernel in ``mode`` under ``plan`` (default
    ``decode_plan`` of the call's shapes)."""
    _check_cuda_inputs(q, k_cache, v_cache, kv_seg, layer_idx, k_scale, v_scale, mode)
    b, hq, _ = q.shape
    n_layers, _, hkv, rows = k_cache.shape[:4]
    s = 2 * rows if mode in (MODE_INT4, MODE_INT4_I8) else rows  # token width
    plan = plan or decode_plan(b, hkv, hq // hkv, s, mode, sms=device_sms(q.device.index))
    out = torch.empty_like(q)

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), ptr(k_scale), ptr(v_scale),
            kv_seg.data_ptr(), out.data_ptr(), n_layers, b, hq, hkv, s, int(layer_idx), mode,
            plan.block_rows, plan.cluster, plan.stages, float(scale))
    lib = csrc.library()
    if q.device.index == torch.cuda.current_device():
        rc = lib.st_decode_split(*args, _stream(q.device))
    else:
        with torch.cuda.device(q.device):
            rc = lib.st_decode_split(*args, _stream(q.device))
    csrc.check_launch(rc, "decode attention")
    return out


def _launch_int8_kernel(*args, plan: Optional[DecodePlan] = None) -> torch.Tensor:
    """int8 cache (mode 1), under ``plan``."""
    out = _launch(*args, mode=MODE_INT8, plan=plan)
    _launch_int8_kernel.launches += 1
    return out


def _launch_int4_kernel(*args, plan: Optional[DecodePlan] = None) -> torch.Tensor:
    """int4 cache, dots on the widened nibbles (mode 2), under ``plan``."""
    out = _launch(*args, mode=MODE_INT4, plan=plan)
    _launch_int4_kernel.launches += 1
    return out


def _launch_int4_i8_kernel(*args, plan: Optional[DecodePlan] = None) -> torch.Tensor:
    """int4 cache, int8 dots (mode 3), under ``plan``."""
    out = _launch(*args, mode=MODE_INT4_I8, plan=plan)
    _launch_int4_i8_kernel.launches += 1
    return out


_launch_int8_kernel.launches = 0
_launch_int4_kernel.launches = 0
_launch_int4_i8_kernel.launches = 0
_QUANT_LAUNCHERS = {MODE_INT8: _launch_int8_kernel, MODE_INT4: _launch_int4_kernel,
                    MODE_INT4_I8: _launch_int4_i8_kernel}


def decode_attention(
    q: torch.Tensor,        # (B, Hq, D) — one new token per sequence
    k_cache: torch.Tensor,  # (L, B, Hkv, S, D) bf16 | int8; uint8 (L, B, Hkv, S/2, D) int4
    v_cache: torch.Tensor,
    kv_seg: torch.Tensor,   # (B, S) int32 — nonzero = valid cache cell
    layer_idx: int,
    k_scale: Optional[torch.Tensor] = None,  # (L, B, Hkv, S) bf16 — int8 / int4 caches
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    int4_i8dot: bool = False,
) -> torch.Tensor:
    """Attention of one decode token against layer ``layer_idx`` of the
    stacked cache. Returns (B, Hq, D). ``int4_i8dot`` (int4 caches only) runs
    both dots on int8 operands."""
    d = q.shape[-1]
    scale = scale if scale is not None else d**-0.5
    mode = _cache_mode(k_cache, k_scale, int4_i8dot)
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, kv_seg, layer_idx, scale,
                                      k_scale, v_scale, int4_i8dot)
    args = (q, k_cache, v_cache, kv_seg, layer_idx, scale, k_scale, v_scale)
    if mode != MODE_BF16:
        return _QUANT_LAUNCHERS[mode](*args)
    return _launch_bf16_kernel(*args)


def _launch_bf16_kernel(*args, plan: Optional[DecodePlan] = None) -> torch.Tensor:
    """bf16 cache (mode 0: the split kernel, under ``plan``); counts on
    ``decode_attention.launches``."""
    out = _launch(*args, mode=MODE_BF16, plan=plan)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
