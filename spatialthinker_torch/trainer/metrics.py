"""Training metrics helpers (the port's own copy of ``reduce_metrics`` and
``Timer`` from ``spatialthinker_tpu/trainer/metrics.py``; host code)."""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List

import numpy as np


def reduce_metrics(metrics: Dict[str, List[float]]) -> Dict[str, float]:
    return {k: float(np.mean(v)) for k, v in metrics.items()}


class Timer:
    """Section timing accumulated into a dict."""

    def __init__(self):
        self.timing: Dict[str, float] = {}

    @contextmanager
    def __call__(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.timing[name] = time.perf_counter() - start
