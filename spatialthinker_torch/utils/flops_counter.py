"""Analytic FLOPs counting + MFU against the card's dense bf16 peak.

Parity with the reference's FlopsCounter (verl/utils/flops_counter.py:27-133):
dense matmul + attention FLOPs for a Qwen-shaped decoder (plus the vision
tower, which the reference leaves out), divided by the device's promised peak
to give model FLOPs utilization. The port's own copy of
``spatialthinker_tpu/utils/flops_counter.py`` with an NVIDIA peak table and
the vision tower's attention counted inside each image (the JAX package
counts a batch's patches as one image).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..models.qwen2_5_vl.config import Qwen25VLConfig

# promised dense bf16 peak FLOPs per card (data sheets, no sparsity)
GPU_PEAK_FLOPS = {
    "h100": 989e12,
    "h200": 989e12,
    "a100": 312e12,
}
CPU_NOMINAL_FLOPS = 1e12  # keeps MFU finite in CPU tests; never a device number


def device_peak_flops(device_kind: str) -> float:
    kind = device_kind.lower()
    for key, peak in GPU_PEAK_FLOPS.items():
        if key in kind:
            return peak
    return CPU_NOMINAL_FLOPS if kind == "cpu" else GPU_PEAK_FLOPS["h100"]


def device_kind(device) -> str:
    """``torch.cuda.get_device_name`` for a CUDA device, "cpu" otherwise."""
    import torch

    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


class FlopsCounter:
    def __init__(self, config: Qwen25VLConfig, device="cpu"):
        self.config = config
        self.promised_tflops = device_peak_flops(device_kind(device)) / 1e12

    def _dense_flops_per_token(self) -> float:
        t = self.config.text
        e = t.hidden_size
        heads_dim = t.num_attention_heads * t.head_dim
        kv_dim = t.num_key_value_heads * t.head_dim
        per_layer = 2 * (
            e * heads_dim          # q
            + 2 * e * kv_dim       # k, v
            + heads_dim * e        # o
            + 3 * e * t.intermediate_size  # gate, up, down
        )
        lm_head = 2 * e * t.vocab_size
        return per_layer * t.num_hidden_layers + lm_head

    def _attention_flops(self, seqlen_sum_sq: float) -> float:
        t = self.config.text
        # qk^T and pv: 2 matmuls, 2 FLOPs per MAC, over all heads
        return 4 * t.num_attention_heads * t.head_dim * seqlen_sum_sq * t.num_hidden_layers

    def _vision_flops(self, image_patches: Sequence[int]) -> float:
        """Vision-tower forward FLOPs for images of ``image_patches`` patches
        each. The reference's FlopsCounter ignores the tower entirely,
        overstating multimodal MFU -- counted here: patch embed, per-block
        qkv/proj/gated MLP, window vs full attention context, and the spatial
        merger. Attention stays inside an image: a window block's patch
        attends its window ((window/patch)^2 patches, or the whole image if
        smaller), a full block's the image's own n patches."""
        n = np.asarray([p for p in image_patches if p > 0], np.float64)
        if n.size == 0:
            return 0.0
        v = self.config.vision
        e, inter = v.hidden_size, v.intermediate_size
        din = v.in_channels * v.temporal_patch_size * v.patch_size**2
        dense_per_patch_per_block = 2 * (e * 3 * e + e * e + 3 * e * inter)
        win = (v.window_size // v.patch_size) ** 2
        n_full = len(v.fullatt_block_indexes)
        n_win = v.depth - n_full
        attn = 4 * e * float(np.sum(n * (n_win * np.minimum(win, n) + n_full * n)))
        unit = v.spatial_merge_unit
        merger_per_patch = 2 * (unit * e * e + e * self.config.text.hidden_size)
        embed_per_patch = 2 * din * e
        return float(n.sum()) * (
            v.depth * dense_per_patch_per_block + merger_per_patch + embed_per_patch
        ) + attn

    def estimate_flops(
        self, batch_seqlens: Sequence[int], delta_time: float, image_patches: Sequence[int] = ()
    ) -> Tuple[float, float]:
        """Returns (achieved TFLOPs/s, promised TFLOPs/s per card). Mirrors the
        reference signature: token counts per sequence + wall time; plus the
        batch's images as their patch counts (reference counts text only)."""
        total_tokens = float(sum(batch_seqlens))
        seq_sq = float(sum(s * s for s in batch_seqlens))
        flops = (
            total_tokens * self._dense_flops_per_token()
            + self._attention_flops(seq_sq)
            + self._vision_flops(image_patches)
        )
        achieved = flops / max(delta_time, 1e-9) / 1e12
        return achieved, self.promised_tflops


def compute_mfu(
    counter: FlopsCounter,
    batch_seqlens: Sequence[int],
    delta_time: float,
    n_chips: int,
    ppo_epochs: int = 1,
    image_patches: Sequence[int] = (),
) -> float:
    achieved, promised = counter.estimate_flops(batch_seqlens, delta_time, image_patches)
    # fwd + bwd = 3x forward FLOPs; multiplied by epochs over the same data
    return achieved * 3 * ppo_epochs / (promised * n_chips)
