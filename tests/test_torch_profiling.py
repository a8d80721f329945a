"""The port's profiling helpers (linne_tpu_torch/utils/profiling.py):
`trace` writes a Chrome trace of the enclosed region, and `StageTimer`
keeps the JAX package's totals, counts and report format."""

import json
import time

import torch

from linne_tpu.utils import profiling as jax_profiling
from linne_tpu_torch.utils import profiling


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.arange(64 * 64, dtype=torch.float64).reshape(64, 64)
    with profiling.trace(str(tmp_path)) as prof:
        float((x @ x).sum())
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {ev.get("name") for ev in
             json.loads(files[0].read_text())["traceEvents"]}
    assert "aten::mm" in names
    assert "aten::mm" in {ev.key for ev in prof.key_averages()}


# (stage, seconds); "decode" raises inside its stage and is counted anyway
_STAGES = [("pack", 0.003), ("entropy", 0.0105), ("pack", 0.002),
           ("upload", 0.0005), ("decode", 0.25), ("entropy", 0.001)]


def _drive(timer, monkeypatch):
    """Run the stages of _STAGES on a clock that advances by each stage's
    seconds while it runs."""
    now = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: now[0])
    for name, secs in _STAGES:
        try:
            with timer.stage(name):
                now[0] += secs
                if name == "decode":
                    raise ValueError(name)
        except ValueError:
            pass
    return timer


def test_stage_timer_matches_jax(monkeypatch):
    ours = _drive(profiling.StageTimer(), monkeypatch)
    theirs = _drive(jax_profiling.StageTimer(), monkeypatch)
    assert dict(ours.totals) == dict(theirs.totals)
    assert dict(ours.counts) == dict(theirs.counts) == {
        "pack": 2, "entropy": 2, "upload": 1, "decode": 1}
    assert ours.report() == theirs.report()
    assert ours.report().splitlines()[0].startswith("decode ")
