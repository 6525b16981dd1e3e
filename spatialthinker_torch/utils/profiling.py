"""Profiling and memory observability: peak / in-use / total device memory
from ``torch.cuda`` and optional ``torch.profiler`` traces around training
steps (counterpart of ``spatialthinker_tpu/utils/profiling.py``)."""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

import torch

_GB = 1024**3


def device_memory_metrics(device=None, prefix: str = "perf") -> Dict[str, float]:
    """Peak and current allocated memory and the card's total (0s on the CPU)."""
    peak = in_use = limit = 0.0
    if device is not None and torch.device(device).type == "cuda":
        stats = torch.cuda.memory_stats(device)
        peak = stats.get("allocated_bytes.all.peak", 0) / _GB
        in_use = stats.get("allocated_bytes.all.current", 0) / _GB
        limit = torch.cuda.get_device_properties(device).total_memory / _GB
    return {
        f"{prefix}/max_memory_allocated_gb": peak,
        f"{prefix}/memory_in_use_gb": in_use,
        f"{prefix}/memory_limit_gb": limit,
    }


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str], step: int, enabled_steps=(1, 5)):
    """Write a ``torch.profiler`` chrome trace (``step_<n>.json``) for the
    selected steps when ``trace_dir`` is set."""
    if trace_dir and step in enabled_steps:
        os.makedirs(trace_dir, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(os.path.join(trace_dir, f"step_{step}.json"))
    else:
        yield
