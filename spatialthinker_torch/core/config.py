"""Data-pipeline settings of the port (its own copy of ``DataConfig`` from the
JAX package's ``core/config.py``; the trainer's other config sections come
with the trainer)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class DataConfig:
    train_files: str = ""
    val_files: str = ""
    prompt_key: str = "problem"
    answer_key: str = "answer"
    image_key: str = "image"
    mixed_data: bool = False
    text_only: bool = False
    max_prompt_length: int = 2048
    max_response_length: int = 2048
    rollout_batch_size: int = 512
    val_batch_size: int = -1
    format_prompt: str = ""
    shuffle: bool = True
    seed: int = 1
    max_pixels: int = 4_194_304
    min_pixels: int = 262_144
    num_workers: int = 8  # host-side loader threads; 0 = synchronous
    prefetch_batches: int = 2
