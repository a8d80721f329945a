"""The byte-exact cell (`cd-m7-exact.encode`): its files found by name, the
imports rule for its plain reference, its kernels' roofline readers
against hand counts, and its judge against streams with a fault that
keeps them decodable (a coefficient altered, a block spliced in from the
batched encoder in float32) or not (a block left out). The program and
the reference run on the CPU at blocks of 2048 samples."""

from __future__ import annotations

import copy
import importlib
import json
import struct
import subprocess
import sys

import numpy as np
import pytest

from conftest import ROOT, bench
from benchmark import roofline, run, trace_summary
from benchmark.entries import encode, exact_encode
from benchmark.material import Corpus

CELL = "cd-m7-exact.encode"
N = 2048
BLOCKS = 3


def test_files_are_found_by_name():
    files = run.cell_files(bench(), CELL)
    assert files["cell"]["chips"] == 1
    assert files["config"]["encoder"] == "exact_device"
    assert files["config"]["preset"] == 7
    assert files["traffic"]["entry"] == "exact_encode"
    entry = importlib.import_module("benchmark.entries.exact_encode")
    assert set(entry.NAMES) == set(files["limits"])
    assert all(v == 0 for v in files["limits"].values())
    for key, kind in (("end_to_end", "end_to_end"), ("per_layer", "metrics")):
        names = [m["name"] for m in run.metrics_of(bench(), key, CELL)]
        for name in names:
            assert (ROOT / "benchmark" / kind / f"{name}.py").exists(), name
    per_layer = {m["name"] for m in run.metrics_of(bench(), "per_layer",
                                                   CELL)}
    assert per_layer == {"guard_flagged_pct", "exact_fit_wait_pct",
                         "chain_predict_roofline", "autocorr_serial_roofline",
                         "serial_abs_mean_roofline",
                         "levinson_serial_roofline"}


def test_the_exact_reference_imports_nothing_of_the_program():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, json\n"
         "import benchmark.reference.exact\n"
         "print(json.dumps(sorted({m.split('.')[0] "
         "for m in sys.modules})))\n"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
             "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "linne_tpu",
                      "linne_tpu_torch"}


class _Trace:
    def __init__(self, kernel_s):
        self.kernel_s = kernel_s


def test_roofline_readers_against_hand_counts():
    counters = {
        ("chain_predict", 4, 16, 2, 3): 2,          # 2 launches
        ("autocorr_serial", 3, 10, 2): 1,
        ("serial_abs_mean", 2, 12, 1, 10): 5,
        ("levinson_serial", 3, 4): 1,
        "guard_rows_total": 10, "guard_rows_flagged": 1,
        "fit_wait_s": 0.5,
    }
    secs = 1e-9
    ctx = {"counters": counters, "window_s": 2.0,
           "trace": _Trace({"chain_predict_kernel": secs,
                            "autocorr_kernel": secs,
                            "abs_mean_kernel": secs,
                            "levinson_thread_kernel": secs / 2,
                            "levinson_warp_kernel": secs / 2})}

    def share(ops, nbytes):
        return 100.0 * max(ops / roofline.FP64_FLOPS,
                           nbytes / roofline.HBM_BYTES_PER_S) / secs

    read = lambda name: run.reader("metrics", name).read(ctx)  # noqa: E731
    # 4 rows of 2 units of 8 samples, 3 taps: each unit predicts 5
    # samples, a multiply-add (2 operations) a tap; reads its 8 samples
    # and 3 taps, writes 8: twice
    assert read("chain_predict_roofline") == pytest.approx(
        share(2 * 8 * 5 * 3 * 2, 2 * 8 * 8 * (16 + 3)))
    # 3 segments of 10 at lags 0 and 1: 10 + 9 multiply-adds
    assert read("autocorr_serial_roofline") == pytest.approx(
        share(3 * 2 * 19, 3 * 8 * 12))
    # 5 launches of 2 rows over samples 1..9: an add and an abs a sample
    assert read("serial_abs_mean_roofline") == pytest.approx(
        share(5 * 2 * 2 * 9, 5 * 2 * 8 * 10))
    # 3 recursions of order 4: 4 * 5 multiply-adds and 4 divisions
    assert read("levinson_serial_roofline") == pytest.approx(
        share(3 * (2 * 20 + 4), 3 * 8 * 9))
    assert read("guard_flagged_pct") == pytest.approx(10.0)
    assert read("exact_fit_wait_pct") == pytest.approx(25.0)
    # the parent's program keeps no tally and no wait: nothing, no fault
    bare = {"counters": {"guard_rows_total": 0}, "window_s": 2.0,
            "trace": ctx["trace"]}
    for name in ("chain_predict_roofline", "guard_flagged_pct",
                 "exact_fit_wait_pct"):
        assert run.reader("metrics", name).read(bare) is None
    assert exact_encode.kernel_roofline(
        dict(ctx, trace=None), "chain_predict", ("x",)) is None


def test_kernel_names_match_the_trace():
    names = {"void (anonymous namespace)::autocorr_kernel<2>(double const*, "
             "double*, long, int, int, int, int)": "autocorr_kernel",
             "void (anonymous namespace)::levinson_warp_kernel(double const*"
             ")": "levinson_warp_kernel"}
    for full, base in names.items():
        assert trace_summary.kernel_base(full) == base


# -- the judge -----------------------------------------------------------------

def _files():
    files = copy.deepcopy(run.cell_files(bench(), CELL))
    files["config"]["format"]["num_samples_per_block"] = N
    t = files["traffic"]
    t.update(corpus_tracks=2, folder_tracks=1, track_seconds=0.2,
             warmup_max_passes=1)
    t["material"] = dict(t["material"], silent_tracks=1, burst_tracks=1)
    t["check"] = {"tracks": 8, "blocks": BLOCKS}
    return files


def _track(seed):
    rng = np.random.default_rng(seed)
    t = np.arange(BLOCKS * N + 500)
    x = np.stack([np.round(9000 * np.sin(2 * np.pi * f * t / 44100)
                           + rng.normal(0, 300, t.size))
                  for f in (220.0, 331.0)]).astype(np.int32)
    x[:, :700] = 0
    return x


def _encoder(config, cls=None):
    from linne_tpu_torch.exact.encoder import ExactEncoder

    enc = (cls or ExactEncoder)()
    enc.set_encode_parameter(encode.parameter(config))
    return enc


def _judge(files, x, data):
    corpus = Corpus([x], [x.shape[1]], [[0]], 16)
    return exact_encode.judge(files["config"], files["traffic"], corpus,
                              [(0, data)], 11, "cpu")["numbers"]


def _frames(data: bytes):
    """(header bytes, [frame bytes])."""
    from benchmark.reference.stream import HEADER_SIZE

    out, off = [], HEADER_SIZE
    while off < len(data):
        size = struct.unpack_from(">I", data, off + 2)[0]
        out.append(data[off : off + 6 + size])
        off += 6 + size
    return data[:HEADER_SIZE], out


def test_judge_passes_the_exact_stream():
    files = _files()
    x = _track(1)
    data = _encoder(files["config"]).encode_whole(list(x), x.shape[1])
    assert _judge(files, x, data) == {
        "invalid_streams": 0, "lossless_failures": 0,
        "exact_block_mismatches": 0}


def test_judge_counts_an_altered_coefficient():
    """A coefficient of the first block altered before its residual is
    worked out: the stream is whole and lossless, only its side
    information is not the upstream encoder's."""
    from linne_tpu_torch.exact.encoder import ExactEncoder

    class Altered(ExactEncoder):
        blocks = 0

        def _quantize_layers(self):
            rshifts, coefs = super()._quantize_layers()
            self.blocks += 1
            if self.blocks == 1:
                coefs[1] = coefs[1].copy()
                coefs[1][0] += 1
            return rshifts, coefs

    files = _files()
    x = _track(2)
    data = _encoder(files["config"], Altered).encode_whole(list(x),
                                                           x.shape[1])
    assert _judge(files, x, data) == {
        "invalid_streams": 0, "lossless_failures": 0,
        "exact_block_mismatches": 1}


def test_judge_counts_a_block_from_the_batched_encoder():
    """Block 2 of the exact stream replaced by the batched encoder's (its
    analysis in float32) where the two differ: a valid, lossless stream."""
    import torch

    from linne_tpu_torch.codec.encoder import TorchEncoder

    files = _files()
    x = _track(3)
    exact_data = _encoder(files["config"]).encode_whole(list(x), x.shape[1])
    batched = TorchEncoder(batch_blocks=8, device="cpu")
    batched.dtype = torch.float32
    batched.set_encode_parameter(encode.parameter(files["config"]))
    other = batched.encode_many([x], [x.shape[1]])[0]
    head, mine = _frames(exact_data)
    _h, theirs = _frames(other)
    differ = [b for b in range(BLOCKS) if mine[b] != theirs[b]]
    assert differ
    b = differ[0]
    spliced = head + b"".join(mine[:b] + [theirs[b]] + mine[b + 1:])
    assert _judge(files, x, spliced) == {
        "invalid_streams": 0, "lossless_failures": 0,
        "exact_block_mismatches": 1}


def test_judge_counts_a_block_left_out():
    files = _files()
    x = _track(4)
    head, frames = _frames(
        _encoder(files["config"]).encode_whole(list(x), x.shape[1]))
    got = _judge(files, x, head + b"".join(frames[:1] + frames[2:]))
    assert got["invalid_streams"] == 1


def test_the_float32_reference_fails_the_check():
    """The control one precision below the configuration's: its blocks,
    held to the float64 reference's by the check's own comparison, fail
    the cell's limit."""
    from benchmark import exact_control

    files = _files()
    t = files["traffic"]
    t["material"] = dict(t["material"], silent_tracks=0, burst_tracks=0)
    got = exact_control.reference32(files, 2 ** 33 + 7, "cpu")
    assert got["blocks"] == 2 * BLOCKS
    assert got["exact_block_mismatches"] > 0 and not got["correct"]


def test_a_run_of_the_cell_on_the_cpu(monkeypatch):
    """The whole cell, traced, at a tiny size: correct, its counters read,
    nothing read from a device trace the CPU does not have."""
    from linne_tpu_torch.exact import device_encoder

    monkeypatch.setattr(device_encoder, "_CHUNK", 4)
    r = run.run_cell(bench(), CELL, 2 ** 33 + 5, 0.1, True, "cpu", _files())
    assert r["correct"] and r["failed"] == 0
    assert set(r["checks"]) == set(exact_encode.NAMES)
    assert r["metrics"]["guard_flagged_pct"]["value"] == 0.0
    assert "exact_fit_wait_pct" in r["metrics"]
    assert not any(k.endswith("_roofline") for k in r["metrics"])
