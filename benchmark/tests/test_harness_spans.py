"""The card's idle time split by the program's spans (benchmark/spans.py),
on synthetic profiler events, and the existing reduction of the trace
(`trace_summary.summarize`) on the same events, as it was."""

from __future__ import annotations

from torch.autograd import DeviceType

from benchmark import spans, trace_summary
from conftest import tiny_files

MAIN, WORKER = 1, 2


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end


class _Ev:
    """A stand-in for the profiler's FunctionEvent; times in us."""

    def __init__(self, name, start, end, device=DeviceType.CPU,
                 thread=MAIN, annotation=False):
        self.name = name
        self.time_range = _Range(start, end)
        self.device_type = device
        self.thread = thread
        self.is_user_annotation = annotation


def _kernel(name, start, end):
    return _Ev(name, start, end, DeviceType.CUDA, thread=0)


def _near(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(abs(a[k] - b[k]) < 1e-12 for k in a)


def test_one_gap_splits_over_time_between_two_spans():
    # window 0-100 us; the card runs 0-10 and 90-100; the gap 10-90 lies
    # under dispatch to 40, under drain from 40
    events = [
        _Ev("bench.window", 0, 100),
        _Ev("linne.encode.dispatch", 5, 40),
        _Ev("linne.encode.drain", 40, 95),
        _kernel("k", 0, 10), _kernel("k", 90, 100),
    ]
    assert _near(spans.idle_by_span(events),
                 {"linne.encode.dispatch": 30e-6,
                  "linne.encode.drain": 50e-6})


def test_nested_spans_charge_the_innermost():
    events = [
        _Ev("bench.window", 0, 100),
        _Ev("bench.folder", 0, 100),
        _Ev("linne.encode", 10, 90),
        _Ev("linne.encode.drain", 20, 80),
        _Ev("linne.encode.drain.wait", 20, 30),
        _Ev("linne.encode.drain.pack", 50, 80),
        _Ev("aten::copy_", 52, 60),            # not a span of the program
        _Ev("linne.encode.frame", 0, 100, thread=WORKER),  # another thread
        _kernel("k", 25, 35),
        _Ev("linne.encode.drain", 25, 35, DeviceType.CUDA, 0, True),
    ]
    assert _near(spans.idle_by_span(events), {
        spans.OUTSIDE: 20e-6,                  # 0-10, 90-100
        "linne.encode": 20e-6,                 # 10-20, 80-90
        "linne.encode.drain.wait": 5e-6,       # 20-25
        "linne.encode.drain": 15e-6,           # 35-50
        "linne.encode.drain.pack": 30e-6,      # 50-80
    })


def _mixed():
    """A window with overlapping kernels, a gap that starts inside one
    span and ends in another, a copy, and events outside the window."""
    return [
        _Ev("bench.window", 1000, 3000),
        _Ev("bench.folder", 1000, 2000),
        _Ev("bench.folder", 2000, 3000),
        _Ev("linne.encode", 1000, 1990),
        _Ev("linne.encode.dispatch", 1010, 1200),
        _Ev("linne.encode.dispatch.launch", 1050, 1100),
        _Ev("cudaLaunchKernel", 1060, 1070),
        _Ev("linne.encode.drain", 1200, 1900),
        _Ev("linne.encode.drain.overflow", 1300, 1400),
        _Ev("cudaMemcpyAsync", 1310, 1390),
        _Ev("linne.decode", 2100, 2900),
        _Ev("linne.decode.parse", 2100, 2500),
        _kernel("void predict_kernel<4>(int const*)", 1065, 1250),
        _kernel("void predict_kernel<8>(int const*)", 1200, 1300),
        _kernel("Memcpy DtoH (Device -> Pinned)", 1380, 1395),
        _kernel("void synth_rows_kernel<2>(int const*)", 2600, 2700),
        _kernel("early", 0, 1020),
        _kernel("late", 2950, 4000),
        _Ev("linne.decode", 2100, 2900, DeviceType.CUDA, 0, True),
        _Ev("bench.folder", 1000, 2000, DeviceType.CUDA, 0),
    ]


def test_parts_and_outside_sum_to_the_window_idle_seconds():
    events = _mixed()
    parts = spans.idle_by_span(events)
    s = trace_summary.summarize(events)
    assert abs(sum(parts.values()) - (s.window_s - s.busy_s)) < 1e-12
    # idle 1020-1065, 1300-1380, 1395-2600, 2700-2950
    assert _near(parts, {
        "linne.encode.dispatch": 30e-6,          # 1020-1050
        "linne.encode.dispatch.launch": 15e-6,   # 1050-1065
        "linne.encode.drain.overflow": 85e-6,    # 1300-1380, 1395-1400
        "linne.encode.drain": 500e-6,            # 1400-1900
        "linne.encode": 90e-6,                   # 1900-1990
        spans.OUTSIDE: 160e-6,                   # 1990-2100, 2900-2950
        "linne.decode.parse": 400e-6,            # 2100-2500
        "linne.decode": 300e-6,                  # 2500-2600, 2700-2900
    })
    # shares of the window by the per-layer groups
    pct = {name: spans.part_pct(parts, s.window_s, *sel)
           for name, sel in spans.PARTS.items()}
    assert _near({k: round(v, 9) for k, v in pct.items()}, {
        "idle_dispatch_pct.encode": 2.25, "idle_drain_pct.encode": 29.25,
        "idle_framing_pct.encode": 4.5, "idle_parse_pct.decode": 20.0,
        "idle_synthesis_pct.decode": 0.0, "idle_finish_pct.decode": 15.0})


def test_summarize_reads_as_before_on_the_same_events():
    """The reduction every existing per-layer metric and the breakdown
    read, on events that hold the program's spans: the values it gave
    before spans existed, worked out by hand."""
    s = trace_summary.summarize(_mixed())
    assert abs(s.window_s - 2000e-6) < 1e-12
    # busy: 1000-1020, 1065-1300, 1380-1395, 2600-2700, 2950-3000
    assert abs(s.busy_s - 420e-6) < 1e-12
    assert _near(s.kernel_s, {"early": 20e-6, "predict_kernel": 285e-6,
                              "Memcpy": 15e-6, "synth_rows_kernel": 100e-6,
                              "late": 50e-6})
    assert [n for n, _ in s.device_ops] == [
        "void predict_kernel<4>(int const*)",
        "void predict_kernel<8>(int const*)",
        "void synth_rows_kernel<2>(int const*)", "late", "early",
        "Memcpy DtoH (Device -> Pinned)"]
    # each gap whole under the innermost host range open where it begins
    assert _near(dict(s.idle_gaps), {
        "linne.encode.dispatch": 45e-6,          # 1020-1065
        "linne.encode.drain.overflow": 1285e-6,  # 1300-1380, 1395-2600
        "linne.decode": 250e-6,                  # 2700-2950
    })


def test_a_traced_run_on_the_cpu_splits_its_window():
    """The whole cell on the CPU, tiny: spans on in the window alone; the
    parts sum to the window (no card: all of it idle)."""
    from linne_tpu_torch.utils import profiling

    files = tiny_files("cd-m0.encode")
    r = spans.run("cd-m0.encode", 11, 0.1, "cpu", files)
    assert r["correct"], r["checks"]
    sp = r["spans"]
    assert abs(sum(sp["idle_by_span"].values()) - sp["window_s"]) < 1e-6
    assert "linne.encode.drain.pack" in sp["idle_by_span"]
    assert set(sp["parts_pct"]) == {"idle_dispatch_pct.encode",
                                    "idle_drain_pct.encode",
                                    "idle_framing_pct.encode"}
    assert sum(sp["parts_pct"].values()) <= 100.0 + 1e-9
    assert sp["batches"] > 0 and sp["queue_waits_per_batch.encode"] >= 0
    assert profiling.record_spans(False) is False  # off again after


def test_the_harness_traced_run_keeps_the_spans_off(monkeypatch):
    """`run.py --trace 1` as it is, the spans-off side of their cost: no
    span reaches `record_function`, and no idle gap is put down to one."""
    from benchmark import run
    from linne_tpu_torch.utils import profiling

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with spans off")

    monkeypatch.setattr(profiling, "record_function", refuse)
    files = tiny_files("cd-m0.encode")
    r = run.run_cell(run.load_json(run.ROOT / "BENCHMARK.json"),
                     "cd-m0.encode", 11, 0.1, True, "cpu", files)
    assert r["correct"], r["checks"]
    assert not any(n.startswith(profiling.SPAN_PREFIX)
                   for n, _s in r["breakdown"]["idle_gaps"])
