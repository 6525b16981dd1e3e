"""The port's span recorder: host seconds of named spans, nested and
accumulated, with counters, on the torch profiler's timeline while it runs.

The trainer makes one ``Timer`` per step (and one for its constructor) and
makes it current with ``active()``, so that the functions below it (log-probs,
packing, the update, the sequence-parallel exchange) open spans and add
counters with ``span`` and ``count`` without an argument of their own.
Outside an active recorder both cost one lookup and record nothing.

The current recorder is the process's, not a context variable's: autograd
runs a CUDA backward on a thread of its own, where a context variable set by
the step reads unset, and the backward's spans (the sequence-parallel
exchanges of the ring's and Ulysses' backward) would be lost."""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch


@dataclass
class Span:
    """One occurrence of a span: its path (``parent/name``), its parent's
    path (None at the top), and its start and end on ``time.perf_counter``."""

    path: str
    parent: Optional[str]
    start: float
    end: float = float("nan")

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Timer:
    """Host seconds of named spans, nested and accumulated, with counters.

    ``timer(name)`` times a span. Opened inside another it records under
    ``parent/name``; a repeated path adds its seconds and calls. ``timing``
    keeps the top-level spans' seconds (``timing_s/*``), ``spans`` every
    occurrence in the order they opened, ``counters`` what ``count`` added
    under the open span's path. ``step`` is the number every span of the
    record shares. While the torch profiler runs, each span is also the range
    ``st/<path>`` on its timeline."""

    def __init__(self, step: int = 0):
        self.step = step
        self.timing: Dict[str, float] = {}
        self.spans: List[Span] = []
        self.counters: Dict[str, float] = {}
        self._open: List[str] = []
        self.start = self.end = float("nan")

    def path(self, name: str) -> str:
        """``name`` under the open span's path."""
        return f"{self._open[-1]}/{name}" if self._open else name

    @contextmanager
    def __call__(self, name: str):
        parent = self._open[-1] if self._open else None
        span = Span(self.path(name), parent, 0.0)
        mark = None
        if torch.autograd._profiler_enabled():
            # a function-scope range, which the profiler keeps on the host's
            # rows: a user-scope one (``record_function``) is also drawn on the
            # device's rows of a CUDA trace, from its first kernel to its last
            # with the device's idle gaps between them, and reads as device work
            mark = torch._C._profiler._RecordFunctionFast(f"st/{span.path}")
            mark.__enter__()
        self.spans.append(span)
        self._open.append(span.path)
        span.start = time.perf_counter()
        try:
            yield span
        finally:
            span.end = time.perf_counter()
            self._open.pop()
            if mark is not None:
                mark.__exit__(None, None, None)
            if parent is None:
                self.timing[name] = self.timing.get(name, 0.0) + span.seconds

    def count(self, name: str, n: float = 1) -> None:
        key = self.path(name)
        self.counters[key] = self.counters.get(key, 0) + n

    @contextmanager
    def active(self):
        """This recorder as the current one (``span``, ``count``) inside the
        block; ``start`` and ``end`` are the block's."""
        global _current
        outer, _current = _current, self
        self.start = time.perf_counter()
        try:
            yield self
        finally:
            self.end = time.perf_counter()
            _current = outer

    def seconds(self, path: str) -> float:
        return sum(s.seconds for s in self.spans if s.path == path)

    def calls(self, path: str) -> int:
        return sum(s.path == path for s in self.spans)

    def self_seconds(self, path: str) -> float:
        """``path``'s seconds less those of the spans opened directly inside it."""
        return self.seconds(path) - sum(s.seconds for s in self.spans if s.parent == path)

    def flat(self) -> Dict[str, float]:
        """Seconds (``spans/<path>_s``), calls (``spans/<path>_calls``) and
        counters (``spans/<path>``): the tracker's ``spans/`` family."""
        out: Dict[str, float] = {}
        for s in self.spans:
            out[f"spans/{s.path}_s"] = out.get(f"spans/{s.path}_s", 0.0) + s.seconds
            out[f"spans/{s.path}_calls"] = out.get(f"spans/{s.path}_calls", 0) + 1
        out.update({f"spans/{k}": v for k, v in self.counters.items()})
        return out


_current: Optional[Timer] = None
_NO_SPAN = nullcontext()


def current_timer() -> Optional[Timer]:
    return _current


def span(name: str):
    """``name`` as a span of the current recorder; nothing without one (the
    ``as`` target is then None)."""
    timer = _current
    return _NO_SPAN if timer is None else timer(name)


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the current recorder's counter ``name`` under the open span."""
    timer = _current
    if timer is not None:
        timer.count(name, n)
