#!/usr/bin/env python3
"""The card's idle time in a traced window, split by the program's spans.

    python3 benchmark/spans.py --workload CELL --seed N --seconds S

from the root of a checkout runs one cell as `run.py --trace 1` does (the
same set-up, window, judge and result line) with the program's spans
(`linne_tpu_torch.utils.profiling.span`, ranges named "linne.") recorded
in the window alone, and adds to the line under "spans":

- `idle_by_span`: each idle interval of the card inside `bench.window`,
  split over time by the innermost "linne." range open on the window's
  thread at each instant; time under none goes to "(outside)". The parts
  sum to the window's idle seconds (`idle_by_span`);
- `parts_pct`: the shares of the window that the encode's and the
  decode's host phases leave the card idle (`PARTS`), and the copies
  that waited for all the work queued on the card (the program's
  `queue_waits`) per batch or per full block;
- `window_s`, `idle_s`, `outside_pct`.

`run.py --trace 1` on the same checkout and seed is the same run with the
spans off, the other side of a comparison of their cost. The run is
`run.run_cell` as it is: a hook wraps the program, and the trace's
reduction is wrapped for the run so that the split reads the same events.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from collections import defaultdict
from typing import Dict, List, Tuple

ROOT = pathlib.Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[:] = [p for p in sys.path if pathlib.Path(p or ".").resolve()
                   != ROOT / "benchmark"]
    sys.path.insert(0, str(ROOT))

from benchmark import run as harness  # noqa: E402  (first: its settings)
from benchmark import trace_summary  # noqa: E402
from linne_tpu_torch.utils.profiling import (SPAN_PREFIX,  # noqa: E402
                                             record_spans)
from torch.autograd import DeviceType  # noqa: E402

OUTSIDE = "(outside)"

# per-layer shares of the traced window: (spans, whole subtrees); a
# subtree is the span and every span named below it
PARTS = {
    "idle_dispatch_pct.encode": ((), ("linne.encode.dispatch",)),
    "idle_drain_pct.encode": ((), ("linne.encode.drain",)),
    "idle_framing_pct.encode": (("linne.encode",),
                                ("linne.encode.split", "linne.encode.tails",
                                 "linne.encode.frame")),
    "idle_parse_pct.decode": ((), ("linne.decode.parse",)),
    "idle_synthesis_pct.decode": ((), ("linne.decode.upload",
                                       "linne.decode.layers")),
    "idle_finish_pct.decode": (("linne.decode",),
                               ("linne.decode.download",
                                "linne.decode.assemble")),
}


def _window(events):
    for ev in events:
        if ev.device_type != DeviceType.CUDA and \
                ev.name == trace_summary.WINDOW:
            return ev.time_range.start, ev.time_range.end, ev.thread
    raise RuntimeError("the trace has no window range")


def _idle(events, w0: float, w1: float) -> List[Tuple[float, float]]:
    """The window's idle intervals, in time order: no kernel or copy on
    the device (device-side copies of host ranges left out, as
    `trace_summary.summarize` leaves them out)."""
    busy = []
    for ev in events:
        if ev.device_type != DeviceType.CUDA:
            continue
        if ev.name.startswith((trace_summary.PREFIX, SPAN_PREFIX)) or \
                getattr(ev, "is_user_annotation", False):
            continue
        s, e = ev.time_range.start, ev.time_range.end
        if e > w0 and s < w1:
            busy.append((max(s, w0), min(e, w1)))
    idle = []
    t = w0
    for s, e in trace_summary._union(busy):
        if s > t:
            idle.append((t, s))
        t = max(t, e)
    if t < w1:
        idle.append((t, w1))
    return idle


def _innermost(spans, w0: float, w1: float) -> List[Tuple[float, float, str]]:
    """[(start, end, name)] pieces covering [w0, w1] in time order, each
    named by the innermost span open there (the one opened last), or
    OUTSIDE."""
    points = {w0, w1}
    for s, e, _n in spans:
        points.add(s)
        points.add(e)
    points = sorted(p for p in points if w0 <= p <= w1)
    starts = defaultdict(list)
    ends = defaultdict(list)
    for k, (s, e, _n) in enumerate(spans):
        starts[max(s, w0)].append(k)
        ends[min(e, w1)].append(k)
    open_ = set()
    pieces = []
    for a, b in zip(points, points[1:]):
        open_.difference_update(ends.get(a, ()))
        open_.update(k for k in starts.get(a, ()) if spans[k][1] > a)
        if open_:
            k = max(open_, key=lambda k: (spans[k][0], -spans[k][1]))
            name = spans[k][2]
        else:
            name = OUTSIDE
        pieces.append((a, b, name))
    return pieces


def idle_by_span(events, prefix: str = SPAN_PREFIX) -> Dict[str, float]:
    """{span name: idle seconds} of the profiler's FunctionEvents
    (`prof.events()`): every idle interval of the device inside the
    window range, split over time by the innermost `prefix` range open on
    the window's thread at each instant; time under none goes to
    OUTSIDE. The values sum to the window's idle seconds."""
    events = list(events)
    w0, w1, thread = _window(events)
    spans = [(ev.time_range.start, ev.time_range.end, ev.name)
             for ev in events
             if ev.device_type != DeviceType.CUDA and ev.thread == thread
             and ev.name.startswith(prefix)
             and ev.time_range.end > w0 and ev.time_range.start < w1]
    out: Dict[str, float] = defaultdict(float)
    pieces = _innermost(spans, w0, w1)
    i = 0
    for g0, g1 in _idle(events, w0, w1):
        while i < len(pieces) and pieces[i][1] <= g0:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < g1:
            a, b, name = pieces[j]
            lo, hi = max(a, g0), min(b, g1)
            if hi > lo:
                out[name] += (hi - lo) * 1e-6
            j += 1
    return dict(out)


def part_pct(parts: Dict[str, float], window_s: float, names=(),
             subtrees=()) -> float:
    """Share of the window (%) of the idle seconds under the spans
    `names` and the subtrees `subtrees`."""
    total = sum(v for k, v in parts.items()
                if k in names or any(k == t or k.startswith(t + ".")
                                     for t in subtrees))
    return 100.0 * total / window_s


class _Spanned:
    """The cell's program with the spans on while the profiler records
    (the window of a traced run), counting the window's full blocks and
    its codec's `queue_waits`."""

    def __init__(self, prog, spb: int, encodes: bool):
        self.prog = prog
        self.spb = spb
        self.encodes = encodes
        self.codec = prog.enc if encodes else prog.dec
        self.first = None  # the counters at the window's start
        self.last = None  # and at its end
        self.full_blocks = 0

    def __getattr__(self, name):
        return getattr(self.prog, name)

    def snapshot(self) -> dict:
        return dict(self.prog.counters(), queue_waits=self.codec.queue_waits)

    def __call__(self, *args):
        import torch.autograd.profiler as profiler

        window = profiler._is_profiler_enabled
        if window and self.first is None:
            self.first = self.snapshot()
        previous = record_spans(window)
        try:
            out = self.prog(*args)
        finally:
            record_spans(previous)
        if window:
            if self.encodes:  # (tracks, lengths) -> streams
                self.full_blocks += sum(n // self.spb for n in args[1])
            else:  # (streams,) -> channel lists
                self.full_blocks += sum(len(o[0]) // self.spb for o in out)
        return out

    def close(self) -> None:
        # the harness closes the program after the window, before judging
        self.last = self.snapshot()
        self.codec = None
        self.prog.close()


def run(workload: str, seed: int, seconds: float, device: str = "cuda",
        files: dict | None = None) -> dict:
    """One traced run of the cell (`run.run_cell`) with the spans on in
    its window; the result object with "spans" added."""
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    files = files or harness.cell_files(bench, workload)
    spb = files["config"]["format"]["num_samples_per_block"]
    encodes = files["traffic"]["entry"] == "encode"
    seen = {}
    wrapped = []

    def hook(prog):
        wrapped.append(_Spanned(prog, spb, encodes))
        return wrapped[-1]

    summarize = trace_summary.summarize

    def summarize_and_split(events, *args, **kw):
        events = list(events)
        seen["idle_by_span"] = idle_by_span(events)
        return summarize(events, *args, **kw)

    trace_summary.summarize = summarize_and_split
    try:
        result = harness.run_cell(bench, workload, seed, seconds, True,
                                  device, files, hook)
    finally:
        trace_summary.summarize = summarize
    dev = result["device"]
    window_s = dev["window_s"]
    parts = seen["idle_by_span"]
    prog = wrapped[0]
    spans = {"window_s": window_s, "idle_s": window_s - dev["busy_s"],
             "idle_by_span": dict(sorted(parts.items(),
                                         key=lambda kv: -kv[1])),
             "outside_pct": 100.0 * parts.get(OUTSIDE, 0.0) / window_s}
    kind = ".encode" if encodes else ".decode"
    spans["parts_pct"] = {name: part_pct(parts, window_s, *sel)
                          for name, sel in PARTS.items()
                          if name.endswith(kind)}
    waits = prog.last["queue_waits"] - prog.first["queue_waits"]
    spans.update(queue_waits=waits, full_blocks=prog.full_blocks)
    if encodes:
        batches = prog.last["batches"] - prog.first["batches"]
        spans["batches"] = batches
        if batches:
            spans["queue_waits_per_batch.encode"] = waits / batches
    elif prog.full_blocks:
        spans["queue_waits_per_block.decode"] = waits / prog.full_blocks
    result["spans"] = spans
    return result


def main(argv=None) -> int:
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=bench["run_seconds"])
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("# needs a CUDA card", file=sys.stderr)
        return 3
    result = run(args.workload, args.seed, args.seconds)
    found = harness.loaded_forbidden()
    if found:
        print(f"# modules that must not load were loaded: {found}",
              file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
