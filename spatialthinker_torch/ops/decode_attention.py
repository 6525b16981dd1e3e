"""Decode attention over the stacked bf16 KV cache: the CUDA kernel
(``csrc/decode_attention.cu``) and its plain PyTorch version.

Counterpart of ``spatialthinker_tpu/ops/decode_attention.py`` in its bf16
mode (the int8-scale and int4 modes come with the quantized engines). One
query token per row attends layer ``layer_idx`` of the (L, B, Hkv, S, D)
cache; ``kv_seg`` (B, S) marks valid cells (left padding and the unwritten
decode tail are 0). The query is the newest token, so causality is exactly
"attend every valid cell". Rows with no valid cell give zeros.

The wrapper runs the plain version for CPU tensors only. A CUDA tensor
launches the kernel or raises — nothing falls back.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import csrc
from .flash_attention import NEG_INF

KERNEL_HEAD_DIMS = (128,)  # text heads of the 3B/7B presets
KERNEL_MAX_GROUP = 16


def decode_attention_plain(
    q: torch.Tensor,        # (B, Hq, D)
    k_cache: torch.Tensor,  # (L, B, Hkv, S, D)
    v_cache: torch.Tensor,
    kv_seg: torch.Tensor,   # (B, S)
    layer_idx: int,
    scale: float,
) -> torch.Tensor:
    """Reference: fp32 masked softmax over the layer's cells (a view of the
    stack, not a copy), weights cast to the cache dtype for the PV product."""
    b, hq, d = q.shape
    k = k_cache[layer_idx]  # (B, Hkv, S, D)
    v = v_cache[layer_idx]
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k.float()) * scale
    valid = (kv_seg != 0)[:, None, None, :]
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1) * valid  # fully masked rows emit zeros
    out = torch.einsum("bhgs,bhsd->bhgd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, hq, d).to(q.dtype)


def _check_cuda_inputs(q, k_cache, v_cache, kv_seg, layer_idx) -> None:
    b, hq, d = q.shape
    if k_cache.dim() != 5 or k_cache.shape != v_cache.shape:
        raise ValueError(f"cache shapes {tuple(k_cache.shape)}/{tuple(v_cache.shape)}")
    n_layers, cb, hkv, s, cd = k_cache.shape
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
    for name, t, dtype in (("q", q, torch.bfloat16), ("k_cache", k_cache, torch.bfloat16),
                           ("v_cache", v_cache, torch.bfloat16), ("kv_seg", kv_seg, torch.int32)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def decode_attention(
    q: torch.Tensor,        # (B, Hq, D) — one new token per sequence
    k_cache: torch.Tensor,  # (L, B, Hkv, S, D) — the full layer stack
    v_cache: torch.Tensor,
    kv_seg: torch.Tensor,   # (B, S) int32 — nonzero = valid cache cell
    layer_idx: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention of one decode token against layer ``layer_idx`` of the
    stacked cache. Returns (B, Hq, D)."""
    d = q.shape[-1]
    scale = scale if scale is not None else d**-0.5
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, kv_seg, layer_idx, scale)
    _check_cuda_inputs(q, k_cache, v_cache, kv_seg, layer_idx)
    b, hq, _ = q.shape
    hkv, s = k_cache.shape[2], k_cache.shape[3]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = csrc.library().st_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), kv_seg.data_ptr(),
            out.data_ptr(), b, hq, hkv, s, d, int(layer_idx), float(scale),
            torch.cuda.current_stream().cuda_stream,
        )
    csrc.check_launch(rc, "decode attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
