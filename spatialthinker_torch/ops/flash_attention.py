"""Flash-attention forward: the CUDA kernel (``csrc/flash_attention.cu``) and
its plain PyTorch version.

Counterpart of ``spatialthinker_tpu/ops/flash_attention.py`` (forward only;
the backward kernels come with training). ``flash_fwd`` returns the output
and the per-row logsumexp, as ``_flash_fwd`` does, so ring attention and the
backward can build on it.

Contract (same as the TPU kernel ``_fwd_kernel_gqa``): q (B, Sq, Hq, D),
k/v (B, Skv, Hkv, D), segment ids (B, S) int32 where 0 = padding. A query
attends a key iff their segment ids are equal and nonzero and, when causal,
``kv_pos <= causal_offset + q_pos``. Fully masked rows give o = 0 and
lse = -1e30.

The wrapper runs the plain version for CPU tensors only. A CUDA tensor
launches the kernel or raises — nothing falls back.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import csrc

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (80, 128)  # vision and text heads of the 3B/7B presets


def make_attention_mask(
    q_seg: torch.Tensor,  # (B, Sq)
    kv_seg: torch.Tensor,  # (B, Skv)
    causal: bool,
    causal_offset: int = 0,
) -> torch.Tensor:
    """Boolean (B, Sq, Skv) mask: same nonzero segment, and causal order."""
    mask = (q_seg[:, :, None] == kv_seg[:, None, :]) & (q_seg[:, :, None] != 0)
    if causal:
        sq, skv = q_seg.shape[1], kv_seg.shape[1]
        q_pos = torch.arange(sq, device=q_seg.device)[:, None] + causal_offset
        kv_pos = torch.arange(skv, device=q_seg.device)[None, :]
        mask = mask & (kv_pos <= q_pos)
    return mask


def flash_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_seg: torch.Tensor, kv_seg: torch.Tensor,
    *, causal: bool, scale: float, causal_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference forward: fp32 scores and softmax over the whole row, the
    softmax weights cast to v's dtype for the PV product (as the kernels do).
    Returns (o (B, Sq, Hq, D) in q's dtype, lse (B, Hq, Sq) fp32)."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    mask = make_attention_mask(q_seg, kv_seg, causal, causal_offset)[:, None, None]
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(dim=-1, keepdim=True)
    safe = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float()) / safe
    lse = torch.where(l == 0, torch.full_like(l, NEG_INF), m + torch.log(safe))
    o = o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)
    return o, lse.reshape(b, hq, sq)


def _check_cuda_inputs(q, k, v, q_seg, kv_seg) -> None:
    b, sq, hq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does not fit q {tuple(q.shape)}")
    skv, hkv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"query heads {hq} are not a multiple of kv heads {hkv}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dims {KERNEL_HEAD_DIMS}, got {d}")
    if min(b, sq, skv) < 1:
        raise ValueError("flash kernel needs non-empty batch and sequences")
    if tuple(q_seg.shape) != (b, sq) or tuple(kv_seg.shape) != (b, skv):
        raise ValueError("segment ids must be (B, Sq) and (B, Skv)")
    for name, t, dtype in (("q", q, torch.bfloat16), ("k", k, torch.bfloat16),
                           ("v", v, torch.bfloat16), ("q_seg", q_seg, torch.int32),
                           ("kv_seg", kv_seg, torch.int32)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def flash_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_seg: torch.Tensor, kv_seg: torch.Tensor,
    *, causal: bool, scale: float, causal_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) through the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if not q.is_cuda:
        return flash_fwd_plain(
            q, k, v, q_seg, kv_seg, causal=causal, scale=scale, causal_offset=causal_offset
        )
    _check_cuda_inputs(q, k, v, q_seg, kv_seg)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = csrc.library().st_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_seg.data_ptr(), kv_seg.data_ptr(),
            o.data_ptr(), lse.data_ptr(), b, sq, skv, hq, hkv, d, int(causal),
            int(causal_offset), float(scale), torch.cuda.current_stream().cuda_stream,
        )
    csrc.check_launch(rc, "flash forward")
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0
