"""Profiling helpers. Counterpart of linne_tpu/utils/profiling.py.

- `trace(logdir)`: a context manager around `torch.profiler` that captures
  the enclosed region (host ops, and on a CUDA machine the card's kernels
  and copies) and writes it into `logdir` as a Chrome trace
  (`*.pt.trace.json`, readable in chrome://tracing or Perfetto); no
  tensorboard package is needed. Spans are on inside it;
- `span(name)`: a named range of the codec's host path ("linne." + name),
  recorded by `torch.profiler` on the thread that runs the profiler, in
  the same trace and on the same clock as the card's kernels and copies.
  Spans are off unless `record_spans(True)` or `trace` turns them on; off,
  `span` returns one shared null context and records nothing. Names are
  dotted ("encode.drain.overflow"), so a subtree sums by its prefix; a
  span's parent is the span that encloses it;
- `StageTimer`: wall-clock stage accounting for the host side (packing,
  entropy coding). Dispatch to the card is asynchronous, so a stage that
  should include device work ends in `torch.cuda.synchronize()` or a host
  copy.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)

SPAN_PREFIX = "linne."
_NULL = contextlib.nullcontext()
_spans_on = False


def record_spans(on: bool) -> bool:
    """Turn the codec's spans on or off; returns the previous setting."""
    global _spans_on
    previous, _spans_on = _spans_on, bool(on)
    return previous


def span(name: str):
    """A context manager around one named range of the host path: the
    shared null context while spans are off, else a
    `record_function("linne." + name)`. Open it on the thread that feeds
    the device; the profiler records no range of other threads."""
    if not _spans_on:
        return _NULL
    return record_function(SPAN_PREFIX + name)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the enclosed region into logdir,
    with the codec's spans on inside it. Yields the profiler, whose
    key_averages() sums the events by name."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    previous = record_spans(True)
    try:
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
            yield prof
    finally:
        record_spans(previous)


class StageTimer:
    """Accumulates wall-clock per named stage; print with report()."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(f"{name:24s} {self.totals[name]*1000:9.2f}ms "
                         f"(x{self.counts[name]})")
        return "\n".join(lines)
