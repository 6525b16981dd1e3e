"""mRoPE, device half (counterpart of ``spatialthinker_tpu/models/qwen2_5_vl/rope.py``;
the host half, ``get_mrope_position_ids``, is in ``host.py``).

``compute_cos_sin`` turns (3, B, S) temporal/height/width position ids into
mrope-merged cos/sin tables once per forward (shared by all layers): channel
chunk c of ``mrope_section`` takes its frequencies from component c.
``apply_rotary`` rotates q/k in the rotate-half layout.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def make_inv_freq(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


def compute_cos_sin(
    position_ids: torch.Tensor,  # (3, B, S) int
    inv_freq: torch.Tensor,      # (head_dim/2,) fp32
    mrope_section: Tuple[int, int, int],
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns mrope-merged cos/sin, each (B, S, head_dim)."""
    freqs = position_ids[..., None].float() * inv_freq  # (3, B, S, half)
    # channel selector: chunk c of mrope_section belongs to component c
    sel = np.concatenate([np.full(w, c) for c, w in enumerate(mrope_section)])
    sel = torch.as_tensor(sel, device=freqs.device)
    merged = torch.where(sel == 0, freqs[0], torch.where(sel == 1, freqs[1], freqs[2]))
    emb = torch.cat([merged, merged], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary(
    q: torch.Tensor,    # (B, S, H, D)
    k: torch.Tensor,    # (B, S, Hkv, D)
    cos: torch.Tensor,  # (B, S, D)
    sin: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    q_out = q * cos + rotate_half(q) * sin
    k_out = k * cos + rotate_half(k) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)
