"""The hosted-API helpers shared by the eval harness's providers
(``eval/providers.py``) and the synthesis pipeline's LLM callers
(``data_gen/llm.py``): a PNG as base64 and a POST with backoff. Neither
imports torch; ``requests`` is imported at the first call."""

from __future__ import annotations

import base64
import io
from typing import Dict, Optional


def png_base64(image) -> str:
    """A PIL image as base64 PNG bytes (the data-URL / image-block payload)."""
    buf = io.BytesIO()
    image.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def post_with_retry(url: str, *, headers: Dict, json_body: Dict, timeout: int = 120,
                    max_retries: int = 5, backoff_s: float = 2.0, _sleep=None):
    """POST with exponential backoff: retries on 429, 5xx and connection
    errors (one rate limit must not end a benchmark run); raises on any
    other HTTP error at once."""
    import time

    import requests

    sleep = _sleep if _sleep is not None else time.sleep
    last_exc: Optional[Exception] = None
    for attempt in range(max_retries + 1):
        try:
            resp = requests.post(url, headers=headers, json=json_body, timeout=timeout)
        except requests.RequestException as exc:  # connection and timeout errors
            last_exc = exc
        else:
            if resp.status_code == 429 or resp.status_code >= 500:
                last_exc = requests.HTTPError(f"HTTP {resp.status_code}", response=resp)
            else:
                resp.raise_for_status()  # a 4xx is the caller's fault: surface it now
                return resp
        if attempt < max_retries:
            sleep(backoff_s * (2**attempt))
    raise last_exc
