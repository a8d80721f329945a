"""What a `torch.profiler` trace of the measured window says: the seconds in
which the device ran anything, each kernel's device seconds, the device
operations that took most time, and the idle gaps labelled by what the
host was doing.

The benchmark opens ranges of its own (`record_function`, names starting
with "bench.") around the window and each call into the program; the
window's range fixes the traced window on the trace's clock.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

from torch.autograd import DeviceType

WINDOW = "bench.window"
PREFIX = "bench."
_BASE = re.compile(r"(?:void\s+)?([A-Za-z_][A-Za-z0-9_:]*)")


def kernel_base(name: str) -> str:
    """A device function's name without namespace, template arguments or
    parameters: "void synth_rows_kernel<4>(int const*, ...)" ->
    "synth_rows_kernel"."""
    m = _BASE.match(name.replace("(anonymous namespace)::", "").strip())
    return m.group(1).split("::")[-1] if m else name


class Summary(NamedTuple):
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]          # base name -> device seconds
    device_ops: List[Tuple[str, float]]  # largest first
    idle_gaps: List[Tuple[str, float]]   # host label -> idle seconds


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def device_busy_s(kineto_events) -> float:
    """Seconds in which the device ran anything, overlaps counted once,
    from the profiler's raw events (`prof.profiler.kineto_results.events()`
    of a profile that records device activity alone, so that every event
    belongs to the window it was started around)."""
    spans = []
    for ev in kineto_events:
        if ev.device_type() != DeviceType.CUDA or getattr(
                ev, "is_user_annotation", lambda: False)():
            continue
        start = ev.start_ns()
        spans.append((start, start + ev.duration_ns()))
    return sum(e - s for s, e in _union(spans)) * 1e-9


def summarize(events, top: int = 10) -> Summary:
    """Summary of the profiler's FunctionEvents (`prof.events()`)."""
    window = None
    cpu = []
    device = []
    for ev in events:
        start, end = ev.time_range.start, ev.time_range.end
        if ev.device_type == DeviceType.CUDA:
            if ev.name.startswith(PREFIX) or getattr(
                    ev, "is_user_annotation", False):
                continue  # the device-side copy of a host range
            device.append((start, end, ev.name))
        else:
            if ev.name == WINDOW:
                window = (start, end, ev.thread)
            cpu.append((start, end, ev.name, ev.thread))
    if window is None:
        raise RuntimeError("the trace has no window range")
    w0, w1, thread = window
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in device
              if e > w0 and s < w1]
    busy = _union([(s, e) for s, e, _ in inside])
    kernel_s: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, n in inside:
        by_name[n] += (e - s) * 1e-6
        kernel_s[kernel_base(n)] += (e - s) * 1e-6
    # idle gaps, each labelled by the innermost host range of the window's
    # thread that is open where the gap begins
    gaps = []
    t = w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    host = sorted((s, e, n) for s, e, n, th in cpu
                  if th == thread and e > w0 and s < w1)
    labels: Dict[str, float] = defaultdict(float)
    stack: List[Tuple[float, float, str]] = []
    hi = 0
    for g0, g1 in gaps:  # gaps come in time order
        while hi < len(host) and host[hi][0] <= g0:
            stack.append(host[hi])
            hi += 1
        stack = [h for h in stack if h[1] > g0]
        label = max(stack, key=lambda h: h[0])[2] if stack else "(none)"
        labels[label] += (g1 - g0) * 1e-6
    return Summary(
        (w1 - w0) * 1e-6,
        sum(e - s for s, e in busy) * 1e-6,
        dict(kernel_s),
        sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        sorted(labels.items(), key=lambda kv: -kv[1])[:top])
