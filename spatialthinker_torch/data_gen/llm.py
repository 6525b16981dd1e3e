"""LLM API callers of the synthesis pipeline: Anthropic question generation
and OpenAI vision validation (counterpart of
``spatialthinker_tpu/data_gen/llm.py``: the same endpoints, headers and
bodies). Both go through ``utils/http.py``'s ``post_with_retry`` (backoff on
429, 5xx and connection errors; a 4xx raises at once) and ``png_base64``,
the eval providers' helpers, instead of a retry loop of their own."""

from __future__ import annotations

import os
from typing import Any, List, Optional

from ..utils.http import png_base64, post_with_retry


def call_anthropic(prompt: str, model: str = "claude-sonnet-4-20250514",
                   temperature: float = 0.0, max_tokens: int = 2048,
                   api_key: Optional[str] = None, retries: int = 3) -> str:
    """One text completion; ``retries`` attempts in all."""
    key = api_key or os.environ.get("ANTHROPIC_API_KEY", "")
    resp = post_with_retry(
        "https://api.anthropic.com/v1/messages",
        headers={"x-api-key": key, "anthropic-version": "2023-06-01"},
        json_body={
            "model": model,
            "max_tokens": max_tokens,
            "temperature": temperature,
            "messages": [{"role": "user", "content": prompt}],
        },
        max_retries=retries - 1, backoff_s=1.0,
    )
    return resp.json()["content"][0]["text"]


def call_openai_vision(question: str, options: List[str], image: Any,
                       model: str = "gpt-4o", api_key: Optional[str] = None,
                       retries: int = 3) -> str:
    """The checker model's answer to one MCQ about ``image`` (a PIL image);
    ``retries`` attempts in all."""
    from .prompts import VALIDATION_PROMPT

    key = api_key or os.environ.get("OPENAI_API_KEY", "")
    options_block = "\n".join(f"({chr(65 + i)}) {o}" for i, o in enumerate(options))
    prompt = VALIDATION_PROMPT.format(question=question, options=options_block)
    resp = post_with_retry(
        "https://api.openai.com/v1/chat/completions",
        headers={"Authorization": f"Bearer {key}"},
        json_body={
            "model": model,
            "messages": [
                {
                    "role": "user",
                    "content": [
                        {"type": "image_url",
                         "image_url": {"url": f"data:image/png;base64,{png_base64(image)}"}},
                        {"type": "text", "text": prompt},
                    ],
                }
            ],
            "max_tokens": 16,
        },
        max_retries=retries - 1, backoff_s=1.0,
    )
    return resp.json()["choices"][0]["message"]["content"]
