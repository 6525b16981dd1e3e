"""Decode attention over the stacked dense KV cache: the CUDA kernels
(``csrc/decode_attention.cu``) and their plain PyTorch versions.

Counterpart of ``spatialthinker_tpu/ops/decode_attention.py``. One query
token per row attends layer ``layer_idx`` of the (L, B, Hkv, S, D) cache;
``kv_seg`` (B, S) marks valid cells (left padding and the unwritten decode
tail are 0). The query is the newest token, so causality is exactly "attend
every valid cell". Rows with no valid cell give zeros. Four cache formats:

- bf16 (the TPU kernel ``_decode_kernel``) -> ``decode_attention.launches``;
- int8 values with per-cell bf16 scales (L, B, Hkv, S) (``_decode_kernel``,
  ``quantized=True``) -> ``_launch_int8_kernel``. These two run the split
  kernel under one plan per call, ``decode_plan``: the 64-token tiles of a
  (row, kv head) stripe over a cluster of CTAs where the pairs leave CTA
  slots idle, tiles without a valid cell skipped, each CTA's four consumer warps
  with their own running max, met in warp order and then in rank order;
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
KERNEL_MAX_GROUP = 16
KERNEL_MAX_SMEM = 232448  # dynamic shared memory a block may opt in to on sm_90
MODE_BF16, MODE_INT8, MODE_INT4, MODE_INT4_I8 = 0, 1, 2, 3

# the split kernel of modes 0 and 1 (``csrc/decode_attention.cu`` ``decode_split_kernel``)
SPLIT_TILE = 64           # tokens a ring slot holds
SPLIT_CONSUMERS = 4       # consumer warps a CTA, 16 tokens of a tile each (one producer warp more)
SPLIT_MAX_CLUSTER = 8     # the portable cluster size
SPLIT_MAX_STAGES = 4
SPLIT_BOX_BYTES = 8192    # a 64-row x 128-byte TMA box
SPLIT_PART_STRIDE = 132   # floats per head row of the partial outputs
SMEM_PER_SM = 233472      # shared memory of an H100 SM; each resident CTA also takes 1 KB of it


@dataclass(frozen=True)
class DecodePlan:
    """How the split kernel cuts a bf16 / int8 call: ``cluster`` CTAs (ranks)
    per (row, kv head), rank r taking the 64-token tiles r, r + cluster, ...;
    a ring of ``stages`` slots; ``smem`` bytes of shared memory a CTA;
    ``ctas`` CTAs a call."""

    cluster: int
    stages: int
    smem: int
    ctas: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def split_smem(mode: int, g: int, stages: int) -> int:
    """Bytes of shared memory of a split-kernel CTA (``split_layout`` in the
    ``.cu`` file): the ring's slots (K and V boxes, the tile's two scale
    vectors; 1024-byte aligned), which later hold the consumer warps' partial
    outputs and the CTA's sum of them; the slots' headers; per warp and head
    m, l and a combine weight, per head the CTA's m and l and the ranks'
    weights; the mbarriers; 1 KB to align the ring."""
    g16 = 8 if g <= 8 else 16
    slot = _round_up((4 if mode == MODE_BF16 else 2) * SPLIT_BOX_BYTES + 2 * SPLIT_TILE * 2, 1024)
    off = max(stages * slot, (SPLIT_CONSUMERS + 1) * g16 * SPLIT_PART_STRIDE * 4)
    off += stages * 16
    off += (3 * SPLIT_CONSUMERS + 2 + SPLIT_MAX_CLUSTER + 1) * g16 * 4
    return _round_up(off, 8) + 2 * stages * 8 + 1024


def ring_fit(mode: int, g: int) -> int:
    """The deepest ring (2 to 4 slots) that keeps a CTA within
    SMEM_BUDGET_TWO: 3 slots in bf16, 4 in int8."""
    return next((n for n in range(SPLIT_MAX_STAGES, 2, -1) if split_smem(mode, g, n) <= SMEM_BUDGET_TWO), 2)


def cta_slots(mode: int, g: int, sms: int) -> int:
    """CTAs the device holds at once under ``ring_fit``'s ring: ``sms`` times
    the CTAs an SM's shared memory holds (2 in bf16, 3 in int8)."""
    return sms * max(1, SMEM_PER_SM // (split_smem(mode, g, ring_fit(mode, g)) + 1024))


@functools.lru_cache(maxsize=None)
def decode_plan(b: int, hkv: int, g: int, s: int, mode: int, *, sms: int,
                cluster: Optional[int] = None, stages: Optional[int] = None) -> DecodePlan:
    """The plan the card runs for a bf16 (``mode`` 0) or int8 (1) cache: ``b``
    rows, ``hkv`` kv heads of ``g`` query heads, a cache ``s`` tokens wide, on
    a device of ``sms`` streaming multiprocessors (``device_sms``).
    ``cluster`` and ``stages`` override the choice (for measurements and
    tests). The rule is the measured one (``time_decode.py --sweep``,
    PERF.md §6): a CTA walks its tiles one after another behind a
    fixed cost of several µs, and the CTAs an SM holds at once overlap, so the
    cluster splits a stripe's tiles as far as the (row, kv head) pairs leave
    CTA slots idle (``cta_slots``) -- at most 8 ranks and no more than the
    stripe has tiles; the ring is ``ring_fit``'s, no deeper than a rank's
    tiles (at least 2 slots). Raises ValueError for a plan the kernel cannot
    run; the C side refuses the same."""
    if mode not in (MODE_BF16, MODE_INT8) or not 1 <= g <= KERNEL_MAX_GROUP or min(b, hkv, s) < 1:
        raise ValueError(f"no split plan for mode {mode}, G={g}, {b} rows x {hkv} kv heads, width {s}")
    tiles = -(-s // SPLIT_TILE)
    if cluster is None:
        cluster = max(1, min(SPLIT_MAX_CLUSTER, tiles, cta_slots(mode, g, sms) // (b * hkv)))
    if not 1 <= cluster <= SPLIT_MAX_CLUSTER:
        raise ValueError(f"a cluster of {cluster}: 1 to {SPLIT_MAX_CLUSTER} run")
    if stages is None:
        stages = min(ring_fit(mode, g), max(2, -(-tiles // cluster)))
    if not 1 <= stages <= SPLIT_MAX_STAGES:
        raise ValueError(f"a ring of {stages} stages: 1 to {SPLIT_MAX_STAGES} run")
    smem = split_smem(mode, g, stages)
    if smem > KERNEL_MAX_SMEM:
        raise ValueError(f"{stages} stages at G={g} need {smem} bytes of shared memory per block; the card "
                         f"allows {KERNEL_MAX_SMEM}")
    return DecodePlan(cluster, stages, smem, cluster * b * hkv)


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
    """One launch of the kernel of ``mode``: modes 0 and 1 the split kernel
    under ``plan`` (default ``decode_plan`` of the call's shapes), modes 2 and
    3 the int4 kernel."""
    _check_cuda_inputs(q, k_cache, v_cache, kv_seg, layer_idx, k_scale, v_scale, mode)
    b, hq, d = q.shape
    n_layers, _, hkv, rows = k_cache.shape[:4]
    lib = csrc.library()
    out = torch.empty_like(q)

    def ptr(t):
        return None if t is None else t.data_ptr()

    if mode in (MODE_BF16, MODE_INT8):
        plan = plan or decode_plan(b, hkv, hq // hkv, rows, mode, sms=device_sms(q.device.index))
        args = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), ptr(k_scale), ptr(v_scale),
                kv_seg.data_ptr(), out.data_ptr(), n_layers, b, hq, hkv, rows, int(layer_idx), mode,
                plan.cluster, plan.stages, float(scale))
        if q.device.index == torch.cuda.current_device():
            rc = lib.st_decode_split(*args, _stream(q.device))
        else:
            with torch.cuda.device(q.device):
                rc = lib.st_decode_split(*args, _stream(q.device))
        csrc.check_launch(rc, "decode attention")
        return out
    s, block_rows = 2 * rows, int4_block_rows(rows)
    smem = lib.st_decode_attention_smem(mode, hq // hkv, block_rows)
    if smem > KERNEL_MAX_SMEM:
        raise ValueError(
            f"an int4 cache of width {s} is one block of {block_rows} byte rows (its width is no "
            f"multiple of 256) and needs {smem} bytes of shared memory per block; the card "
            f"allows {KERNEL_MAX_SMEM}"
        )
    with torch.cuda.device(q.device):
        rc = lib.st_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), ptr(k_scale), ptr(v_scale),
            kv_seg.data_ptr(), out.data_ptr(), b, hq, hkv, s, d, int(layer_idx), mode, block_rows,
            float(scale), torch.cuda.current_stream().cuda_stream,
        )
    csrc.check_launch(rc, "decode attention")
    return out


def _launch_int8_kernel(*args, plan: Optional[DecodePlan] = None) -> torch.Tensor:
    """int8 cache (mode 1: the split kernel, under ``plan``)."""
    out = _launch(*args, mode=MODE_INT8, plan=plan)
    _launch_int8_kernel.launches += 1
    return out


def _launch_int4_kernel(*args) -> torch.Tensor:
    """int4 cache, dots on the widened nibbles (mode 2 of the kernel)."""
    out = _launch(*args, mode=MODE_INT4)
    _launch_int4_kernel.launches += 1
    return out


def _launch_int4_i8_kernel(*args) -> torch.Tensor:
    """int4 cache, int8 dots (mode 3 of the kernel)."""
    out = _launch(*args, mode=MODE_INT4_I8)
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
