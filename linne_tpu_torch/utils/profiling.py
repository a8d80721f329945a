"""Profiling helpers. Counterpart of linne_tpu/utils/profiling.py.

- `trace(logdir)`: a context manager around `torch.profiler` that captures
  the enclosed region (host ops, and on a CUDA machine the card's kernels
  and copies) and writes it into `logdir` as a Chrome trace
  (`*.pt.trace.json`, readable in chrome://tracing or Perfetto); no
  tensorboard package is needed;
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
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the enclosed region into logdir.
    Yields the profiler, whose key_averages() sums the events by name."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


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
