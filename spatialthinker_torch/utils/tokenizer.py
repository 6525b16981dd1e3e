"""Tokenizer/processor loading with the reference's fixups
(verl/utils/tokenizer.py:21-50): gemma EOS correction and
pad-token fallback to EOS."""

from __future__ import annotations

from typing import Any, Optional


def get_tokenizer(model_path: str, correct_pad_token: bool = True,
                  correct_gemma: bool = True, **kwargs) -> Any:
    from transformers import AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(model_path, **kwargs)
    if correct_gemma and "gemma" in model_path.lower():
        # gemma ships <end_of_turn> as token 107; generation should stop there
        tokenizer.eos_token_id = 107
    if correct_pad_token and tokenizer.pad_token_id is None:
        tokenizer.pad_token = tokenizer.eos_token
    return tokenizer


def get_processor(model_path: str, **kwargs) -> Optional[Any]:
    """Multimodal processor when the model has one; None for text-only."""
    from transformers import AutoProcessor

    try:
        processor = AutoProcessor.from_pretrained(model_path, **kwargs)
    except Exception:
        return None
    return processor if hasattr(processor, "image_processor") else None
