"""Qwen2.5-VL architecture dimensions + presets (the port's copy of
``spatialthinker_tpu/models/qwen2_5_vl/config.py``: same dataclasses, same
field values, the presets the port runs).

Dims match the public HF checkpoints (Qwen/Qwen2.5-VL-{3B,7B}-Instruct).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class VisionConfig:
    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    tokens_per_second: int = 2
    window_size: int = 112
    out_hidden_size: int = 2048
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    hidden_act: str = "silu"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def spatial_merge_unit(self) -> int:
        return self.spatial_merge_size * self.spatial_merge_size


@dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 151936
    hidden_size: int = 2048
    intermediate_size: int = 11008
    num_hidden_layers: int = 36
    num_attention_heads: int = 16
    num_key_value_heads: int = 2
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    mrope_section: Tuple[int, int, int] = (16, 24, 24)
    tie_word_embeddings: bool = True
    max_position_embeddings: int = 128_000
    hidden_act: str = "silu"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class Qwen25VLConfig:
    text: TextConfig = field(default_factory=TextConfig)
    vision: VisionConfig = field(default_factory=VisionConfig)
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653
    eos_token_id: int = 151645
    pad_token_id: int = 151643


def qwen25_vl_3b() -> Qwen25VLConfig:
    return Qwen25VLConfig()


def qwen25_vl_7b() -> Qwen25VLConfig:
    return Qwen25VLConfig(
        text=TextConfig(
            vocab_size=152064,
            hidden_size=3584,
            intermediate_size=18944,
            num_hidden_layers=28,
            num_attention_heads=28,
            num_key_value_heads=4,
            mrope_section=(16, 24, 24),
            tie_word_embeddings=False,
        ),
        vision=VisionConfig(out_hidden_size=3584),
    )


def qwen25_vl_tiny(vocab_size: int = 1024) -> Qwen25VLConfig:
    """Tiny random-weight config for tests and smoke runs (Qwen-shaped)."""
    return Qwen25VLConfig(
        text=TextConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=2,
            mrope_section=(2, 3, 3),  # sums to head_dim/2 = 8
            tie_word_embeddings=True,
        ),
        vision=VisionConfig(
            depth=2,
            hidden_size=32,
            intermediate_size=64,
            num_heads=2,
            patch_size=14,
            out_hidden_size=64,
            window_size=112,
            fullatt_block_indexes=(1,),
        ),
        image_token_id=vocab_size - 1,
        video_token_id=vocab_size - 2,
        vision_start_token_id=vocab_size - 3,
        vision_end_token_id=vocab_size - 4,
        eos_token_id=vocab_size - 5,
        pad_token_id=0,
    )


PRESETS = {
    "Qwen/Qwen2.5-VL-3B-Instruct": qwen25_vl_3b,
    "Qwen/Qwen2.5-VL-7B-Instruct": qwen25_vl_7b,
    "3b": qwen25_vl_3b,
    "7b": qwen25_vl_7b,
    "tiny": qwen25_vl_tiny,
}


def get_config(name: str) -> Qwen25VLConfig:
    key = name if name in PRESETS else name.lower()
    if key in PRESETS:
        return PRESETS[key]()
    # heuristics on path names like ".../Qwen2.5-VL-7B-Instruct"
    lowered = name.lower()
    if "7b" in lowered:
        return qwen25_vl_7b()
    if "3b" in lowered:
        return qwen25_vl_3b()
    if "tiny" in lowered:
        return qwen25_vl_tiny()
    raise KeyError(f"no preset for model {name!r}")
