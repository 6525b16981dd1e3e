"""Spans around the program's layers, and the summary of a profiled window.

``Spans`` wraps methods of the trainer instance (never the program's code):
under the profiler each call is a ``bench.<phase>`` range, so that device
idle gaps can be named by what the host was doing. ``summarize`` reads the
profiler's events once the unit is over and keeps a small summary, never a
chrome trace: the union of device intervals (busy seconds; the ranges' own
marks on the device timeline are not device work), device seconds by kernel
name, and the longest idle gaps named by the host phase around them.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.autograd import DeviceType


class Spans:
    """``bench.<phase>`` ranges around methods of one trainer instance."""

    def __init__(self):
        self._undo = []

    def wrap(self, obj, method: str, phase: str) -> None:
        inner = getattr(obj, method)
        self._undo.append((obj, method, vars(obj).get(method)))

        def marked(*args, **kwargs):
            with torch.profiler.record_function(f"bench.{phase}"):
                return inner(*args, **kwargs)

        setattr(obj, method, marked)

    def remove(self) -> None:
        for obj, method, before in reversed(self._undo):
            if before is None:
                delattr(obj, method)
            else:
                setattr(obj, method, before)
        self._undo = []


def _ns(event, which: str) -> int:
    for name in (f"{which}_ns", f"{which}_us"):
        fn = getattr(event, name, None)
        if fn is not None:
            return fn() * (1 if name.endswith("_ns") else 1000)
    raise AttributeError(which)


def summarize(prof, top: int = 10) -> Optional[dict]:
    """busy_s, window_s, device seconds by kernel, the top device operations
    and the longest idle gaps of the ``bench.unit`` range of ``prof``."""
    device, ranges = [], []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        if e.device_type() == DeviceType.CUDA and not e.name().startswith("bench."):
            device.append((start, end, e.name()))
        elif e.device_type() != DeviceType.CUDA and e.name().startswith("bench."):
            ranges.append((start, end, e.name()[len("bench."):]))
    unit = [r for r in ranges if r[2] == "unit"]
    if not unit or not device:
        return None
    w0, w1 = unit[0][0], unit[0][1]
    by_name: Dict[str, float] = defaultdict(float)
    spans = []
    for s, e, name in device:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            by_name[name] += (e - s) * 1e-9
            spans.append((s, e))
    spans.sort()
    busy, gaps, cursor = 0, [], w0
    for s, e in spans:
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if w1 > cursor:
        gaps.append((cursor, w1))
    phases = [r for r in ranges if r[2] != "unit"]

    def phase_at(t: float) -> str:
        inside = [r for r in phases if r[0] <= t <= r[1]]
        return min(inside, key=lambda r: r[1] - r[0])[2] if inside else "between phases"

    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "busy_s": busy * 1e-9,
        "window_s": (w1 - w0) * 1e-9,
        "kernel_s": dict(by_name),
        "device_ops": [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[phase_at((a + b) / 2), (b - a) * 1e-9] for a, b in gaps[:top]],
    }


def kernel_seconds(summary: dict, needle: str) -> float:
    return sum(s for name, s in summary["kernel_s"].items() if needle in name)
