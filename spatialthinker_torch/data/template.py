"""Prompt templating for Qwen2.5-VL chat format.

A copy of ``spatialthinker_tpu/data/template.py`` (that package's
``data/__init__`` imports jax). Builds the exact token-string layout the HF
chat template produces for a single-turn user message with interleaved
images, without requiring the processor object: the image placeholder expands to
<|vision_start|> + N x <|image_pad|> + <|vision_end|> where N is the number of
merged vision tokens for that image.
"""

from __future__ import annotations

from typing import Optional, Sequence

IMAGE_PLACEHOLDER = "<image>"
DEFAULT_SYSTEM = "You are a helpful assistant."


def expand_image_tokens(num_merged_tokens: int) -> str:
    return "<|vision_start|>" + "<|image_pad|>" * num_merged_tokens + "<|vision_end|>"


def normalize_image_placement(prompt: str, num_images: int) -> str:
    """Move all <image> tags to the start of the prompt."""
    stripped = prompt.replace(IMAGE_PLACEHOLDER, "")
    return IMAGE_PLACEHOLDER * num_images + stripped


def build_chat_text(
    prompt: str,
    merged_token_counts: Sequence[int],
    system_prompt: Optional[str] = DEFAULT_SYSTEM,
    add_generation_prompt: bool = True,
) -> str:
    """Render the full chat string with vision blocks expanded in place of
    each <image> tag (one count per tag, in order)."""
    parts = prompt.split(IMAGE_PLACEHOLDER)
    if len(parts) - 1 != len(merged_token_counts):
        raise ValueError(
            f"prompt has {len(parts) - 1} image tags but {len(merged_token_counts)} images given"
        )
    user_content = parts[0]
    for count, rest in zip(merged_token_counts, parts[1:]):
        user_content += expand_image_tokens(count) + rest

    text = ""
    if system_prompt is not None:
        text += f"<|im_start|>system\n{system_prompt}<|im_end|>\n"
    text += f"<|im_start|>user\n{user_content}<|im_end|>\n"
    if add_generation_prompt:
        text += "<|im_start|>assistant\n"
    return text
