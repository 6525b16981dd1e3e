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

Under tensor parallelism (``tp``) a block holds this rank's heads of qkv
(column-parallel, ``[q | k | v]`` each cut alike) and its columns of proj
(row-parallel), its I of gate / up / down, and the merger its columns of fc1
and rows of fc2, by the JAX rule table. A row-parallel product's partial sum
is kept in fp32 and added over the group, then its (replicated) bias.
"""

from __future__ import annotations

from typing import Union

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import attention
from ...ops.logprobs import matmul_fp32_out
from ...parallel.tensor import copy_to_tp, reduce_from_tp, tp_size
from .config import VisionConfig
from .host import window_patch_len
from .rope import rotate_half
from .text import RMSNorm, checkpointed, remat_policy

VISION_EPS = 1e-6


def row_parallel(lin: nn.Linear, x: torch.Tensor, tp) -> torch.Tensor:
    """``lin(x)`` of a row-parallel Linear: the group's fp32 partial
    products added, rounded once, then the bias (replicated); ``lin(x)``
    itself without TP."""
    if tp_size(tp) == 1:
        return lin(x)
    return reduce_from_tp(matmul_fp32_out(x, lin.weight), tp, out_dtype=x.dtype) + lin.bias


class VisionMLP(nn.Module):
    def __init__(self, cfg: VisionConfig, device=None, dtype=None, tp=None):
        super().__init__()
        self.tp = tp
        e, inter = cfg.hidden_size, cfg.intermediate_size // tp_size(tp)
        self.gate_proj = nn.Linear(e, inter, device=device, dtype=dtype)
        self.up_proj = nn.Linear(e, inter, device=device, dtype=dtype)
        self.down_proj = nn.Linear(inter, e, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to_tp(x, self.tp)
        return row_parallel(self.down_proj, F.silu(self.gate_proj(x)) * self.up_proj(x), self.tp)


class VisionBlock(nn.Module):
    def __init__(self, cfg: VisionConfig, device=None, dtype=None, tp=None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        e = cfg.hidden_size
        self.num_heads = cfg.num_heads // tp_size(tp)
        width = self.num_heads * cfg.head_dim
        self.norm1 = RMSNorm(e, VISION_EPS, device, dtype)
        self.norm2 = RMSNorm(e, VISION_EPS, device, dtype)
        self.qkv = nn.Linear(e, 3 * width, device=device, dtype=dtype)
        self.proj = nn.Linear(width, e, device=device, dtype=dtype)
        self.mlp = VisionMLP(cfg, device, dtype, tp)

    def forward(
        self,
        x: torch.Tensor,       # (N, E)
        cos: torch.Tensor,     # (1, N, 1, D)
        sin: torch.Tensor,
        segment_ids: torch.Tensor,  # (1, N) frame ids, or (num_windows, wlen) window ids
    ) -> torch.Tensor:
        n, e = x.shape
        h, d = self.num_heads, self.cfg.head_dim
        q, k, v = self.qkv(copy_to_tp(self.norm1(x), self.tp)).reshape(1, n, 3, h, d).unbind(2)
        q = (q * cos + rotate_half(q) * sin).to(x.dtype)
        k = (k * cos + rotate_half(k) * sin).to(x.dtype)
        rows, width = segment_ids.shape
        out = attention(
            q.reshape(rows, width, h, d), k.reshape(rows, width, h, d), v.reshape(rows, width, h, d),
            segment_ids=segment_ids, causal=False,
        ).reshape(n, h * d)
        x = x + row_parallel(self.proj, out, self.tp)
        return x + self.mlp(self.norm2(x))


class PatchMerger(nn.Module):
    def __init__(self, cfg: VisionConfig, device=None, dtype=None, tp=None):
        super().__init__()
        width = cfg.spatial_merge_unit * cfg.hidden_size
        self.ln_q = RMSNorm(cfg.hidden_size, VISION_EPS, device, dtype)
        self.fc1 = nn.Linear(width, width // tp_size(tp), device=device, dtype=dtype)
        self.fc2 = nn.Linear(width // tp_size(tp), cfg.out_hidden_size, device=device, dtype=dtype)


class VisionTower(nn.Module):
    def __init__(self, cfg: VisionConfig, device=None, dtype=None, tp=None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        din = cfg.in_channels * cfg.temporal_patch_size * cfg.patch_size * cfg.patch_size
        self.patch_embed = nn.Linear(din, cfg.hidden_size, bias=False, device=device, dtype=dtype)
        self.blocks = nn.ModuleList(VisionBlock(cfg, device, dtype, tp) for _ in range(cfg.depth))
        self.merger = PatchMerger(cfg, device, dtype, tp)


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
    reverse_index: torch.Tensor,  # (R,): R = N/unit, or more where slots repeat
    remat: Union[bool, str] = False,
) -> torch.Tensor:
    """Returns merged vision embeddings (R, out_hidden) in natural order: row
    r is merge unit ``reverse_index[r]``, so an image that several samples
    share (``pack_distinct_vision_batch``) runs once and is gathered once a
    sample; the gather is in fp32, so its backward sums those samples'
    gradients in fp32.
    ``remat`` checkpoints every block as the text decoder's layers are
    (``text.checkpointed``: "full" keeps block inputs, "dots" and True also
    the weight products). The JAX tower applies its "dots" policy whenever
    remat is on; here the policy asked for holds in both towers."""
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
    remat = remat_policy(remat)
    for i, block in enumerate(tower.blocks):
        full = i in cfg.fullatt_block_indexes
        seg = seg_full_b if full else seg_window_w
        if remat and torch.is_grad_enabled():
            x = checkpointed(block, remat, x, cos, sin, seg)
        else:
            x = block(x, cos, sin, seg)

    # merger: RMSNorm, then fold each 2x2 merge unit into the feature dim
    m = tower.merger
    x = m.ln_q(x)
    x = x.reshape(n // cfg.spatial_merge_unit, cfg.spatial_merge_unit * e)
    x = row_parallel(m.fc2, F.gelu(m.fc1(copy_to_tp(x, tower.tp)), approximate="none"), tower.tp)
    return x.float().index_select(0, reverse_index.long()).to(x.dtype)
