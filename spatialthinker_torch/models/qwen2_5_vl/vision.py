"""Qwen2.5-VL vision tower in PyTorch (counterpart of
``spatialthinker_tpu/models/qwen2_5_vl/vision.py``; the host-side layout
helpers are in ``host.py``).

Patches arrive host-flattened (N, C*T*P*P) in the UNIFORM-WINDOW layout
(every window is ``window_patch_len`` consecutive slots, edge windows padded
in place, see ``host.prepare_vision_aux``): the Conv3d patch embed is a
matmul, the windowed blocks run as a dense (num_windows, window_len, H, D)
batch and the ``fullatt_block_indexes`` blocks as one (1, N, H, D) sequence
masked by frame ids, both through the flash kernel. Blocks are a
``ModuleList`` run by a Python loop; the full/windowed choice is a Python
branch on the block index.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.attention import attention
from .config import VisionConfig
from .host import window_patch_len
from .rope import rotate_half
from .text import RMSNorm

VISION_EPS = 1e-6


class VisionMLP(nn.Module):
    def __init__(self, cfg: VisionConfig, device=None, dtype=None):
        super().__init__()
        e, inter = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(e, inter, device=device, dtype=dtype)
        self.up_proj = nn.Linear(e, inter, device=device, dtype=dtype)
        self.down_proj = nn.Linear(inter, e, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class VisionBlock(nn.Module):
    def __init__(self, cfg: VisionConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        e = cfg.hidden_size
        self.norm1 = RMSNorm(e, VISION_EPS, device, dtype)
        self.norm2 = RMSNorm(e, VISION_EPS, device, dtype)
        self.qkv = nn.Linear(e, 3 * e, device=device, dtype=dtype)
        self.proj = nn.Linear(e, e, device=device, dtype=dtype)
        self.mlp = VisionMLP(cfg, device, dtype)

    def forward(
        self,
        x: torch.Tensor,       # (N, E)
        cos: torch.Tensor,     # (1, N, 1, D)
        sin: torch.Tensor,
        segment_ids: torch.Tensor,  # (1, N) frame ids, or (num_windows, wlen) window ids
    ) -> torch.Tensor:
        n, e = x.shape
        h, d = self.cfg.num_heads, self.cfg.head_dim
        q, k, v = self.qkv(self.norm1(x)).reshape(1, n, 3, h, d).unbind(2)
        q = (q * cos + rotate_half(q) * sin).to(x.dtype)
        k = (k * cos + rotate_half(k) * sin).to(x.dtype)
        rows, width = segment_ids.shape
        out = attention(
            q.reshape(rows, width, h, d), k.reshape(rows, width, h, d), v.reshape(rows, width, h, d),
            segment_ids=segment_ids, causal=False,
        ).reshape(n, e)
        x = x + self.proj(out)
        return x + self.mlp(self.norm2(x))


class PatchMerger(nn.Module):
    def __init__(self, cfg: VisionConfig, device=None, dtype=None):
        super().__init__()
        width = cfg.spatial_merge_unit * cfg.hidden_size
        self.ln_q = RMSNorm(cfg.hidden_size, VISION_EPS, device, dtype)
        self.fc1 = nn.Linear(width, width, device=device, dtype=dtype)
        self.fc2 = nn.Linear(width, cfg.out_hidden_size, device=device, dtype=dtype)


class VisionTower(nn.Module):
    def __init__(self, cfg: VisionConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        din = cfg.in_channels * cfg.temporal_patch_size * cfg.patch_size * cfg.patch_size
        self.patch_embed = nn.Linear(din, cfg.hidden_size, bias=False, device=device, dtype=dtype)
        self.blocks = nn.ModuleList(VisionBlock(cfg, device, dtype) for _ in range(cfg.depth))
        self.merger = PatchMerger(cfg, device, dtype)


def _vision_cos_sin(pos_ids: torch.Tensor, head_dim: int, theta: float = 10000.0):
    """cos/sin (N, head_dim) from (N, 2) h/w ids: channels [h-freqs | w-freqs] duplicated."""
    quarter = head_dim // 4
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, quarter, dtype=torch.float32, device=pos_ids.device) / quarter)
    )
    freqs_h = pos_ids[:, 0:1].float() * inv_freq[None, :]
    freqs_w = pos_ids[:, 1:2].float() * inv_freq[None, :]
    half = torch.cat([freqs_h, freqs_w], dim=-1)
    emb = torch.cat([half, half], dim=-1)
    return emb.cos(), emb.sin()


def vision_forward(
    tower: VisionTower,
    patches: torch.Tensor,        # (N, C*T*P*P), window order
    pos_ids: torch.Tensor,        # (N, 2)
    seg_full: torch.Tensor,       # (N,)
    seg_window: torch.Tensor,     # (N,)
    reverse_index: torch.Tensor,  # (N/unit,)
    remat: bool = False,
) -> torch.Tensor:
    """Returns merged vision embeddings (N/unit, out_hidden) in natural order.
    ``remat`` checkpoints every block (training: block inputs are kept, the
    body is recomputed in the backward)."""
    cfg = tower.cfg
    n = patches.shape[0]
    e, d = cfg.hidden_size, cfg.head_dim
    x = tower.patch_embed(patches.to(tower.patch_embed.weight.dtype))
    cos, sin = _vision_cos_sin(pos_ids, d)
    cos = cos.to(x.dtype)[None, :, None, :]
    sin = sin.to(x.dtype)[None, :, None, :]

    wlen = window_patch_len(cfg)
    seg_full_b = seg_full[None, :]
    seg_window_w = seg_window.reshape(n // wlen, wlen)
    for i, block in enumerate(tower.blocks):
        full = i in cfg.fullatt_block_indexes
        seg = seg_full_b if full else seg_window_w
        if remat and torch.is_grad_enabled():
            x = checkpoint(block, x, cos, sin, seg, use_reentrant=False)
        else:
            x = block(x, cos, sin, seg)

    # merger: RMSNorm, then fold each 2x2 merge unit into the feature dim
    m = tower.merger
    x = m.ln_q(x)
    x = x.reshape(n // cfg.spatial_merge_unit, cfg.spatial_merge_unit * e)
    x = m.fc2(F.gelu(m.fc1(x), approximate="none"))
    return x.index_select(0, reverse_index.long())
