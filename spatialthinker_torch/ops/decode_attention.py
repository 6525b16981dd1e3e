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

The wrapper runs the plain versions for CPU tensors only. A CUDA tensor
launches a kernel or raises — nothing falls back.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import csrc
from .flash_attention import NEG_INF

KV4_BIAS = 8
KERNEL_HEAD_DIMS = (128,)  # text heads of the 3B/7B presets
KERNEL_MAX_GROUP = 16
KERNEL_MAX_SMEM = 232448  # dynamic shared memory a block may opt in to on sm_90
MODE_BF16, MODE_INT8, MODE_INT4, MODE_INT4_I8 = 0, 1, 2, 3
INT8_BLOCK_ROWS = 256  # tokens per block of the int8 kernel (any value gives the same function)


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


def _launch(q, k_cache, v_cache, kv_seg, layer_idx, scale, k_scale, v_scale, mode: int) -> torch.Tensor:
    _check_cuda_inputs(q, k_cache, v_cache, kv_seg, layer_idx, k_scale, v_scale, mode)
    b, hq, d = q.shape
    hkv, rows = k_cache.shape[2], k_cache.shape[3]
    lib = csrc.library()
    if mode == MODE_BF16:
        s, block_rows = rows, 0
    elif mode == MODE_INT8:
        s, block_rows = rows, min(INT8_BLOCK_ROWS, rows)
    else:
        s, block_rows = 2 * rows, int4_block_rows(rows)
    smem = lib.st_decode_attention_smem(mode, hq // hkv, block_rows)
    if smem > KERNEL_MAX_SMEM:
        raise ValueError(
            f"an int4 cache of width {s} is one block of {block_rows} byte rows (its width is no "
            f"multiple of 256) and needs {smem} bytes of shared memory per block; the card "
            f"allows {KERNEL_MAX_SMEM}"
        )
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = lib.st_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            kv_seg.data_ptr(), out.data_ptr(), b, hq, hkv, s, d, int(layer_idx), mode, block_rows,
            float(scale), torch.cuda.current_stream().cuda_stream,
        )
    csrc.check_launch(rc, "decode attention")
    return out


def _launch_int8_kernel(*args) -> torch.Tensor:
    """int8 cache (mode 1 of the kernel)."""
    out = _launch(*args, mode=MODE_INT8)
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
    out = _launch(*args, mode=MODE_BF16)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
