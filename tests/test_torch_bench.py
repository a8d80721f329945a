"""The port's benchmark (linne_tpu_torch/bench.py) on the CPU at tiny
sizes: every row function returns its rows, finite, under the device's
suffix (`_cpu` here, `_cuda` on the card); a rep whose output differs
from the warm run's raises; without a card the bench raises before any
row runs; the byte-exact rows hold DeviceExactEncoder to ExactEncoder's
bytes, and the exact split fits inside its run's wall.

No timing is checked: a CPU run says nothing of the card's speed."""

import json
import math

import numpy as np
import pytest
import torch

from linne_tpu_torch import bench as B
from linne_tpu_torch.codec.encoder import TorchEncoder
from linne_tpu_torch.format.header import LinneHeader

RATE = 44100
SPB = 2048


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rate_names(*stems):
    return {s + "_cpu" + m for s in stems for m in ("", "_min", "_max")}


def _check_rows(rows, rate_stems, other=()):
    """The rows are exactly the rate rows (median, min, max) and `other`;
    every number finite, every rate row positive with min <= median <=
    max."""
    assert set(rows) == _rate_names(*rate_stems) | {s + "_cpu" for s in other}
    for name, value in rows.items():
        assert math.isfinite(value), name
    for stem in rate_stems:
        lo, mid, hi = (rows[f"{stem}_cpu{m}"] for m in ("_min", "", "_max"))
        assert 0 < lo <= mid <= hi, stem


@pytest.fixture(scope="module")
def signal():
    return B.make_signal(4 * SPB)


@pytest.fixture(scope="module")
def stream7(signal):
    rows, data = B.encode_rows(B.Bench(2, "cpu"), signal, RATE, SPB)
    return rows, data


@pytest.fixture(scope="module")
def exact7():
    b = B.Bench(1, "cpu")
    return b, B.exact_device_rows(b, RATE, 512, 7, nblocks=1, ntracks=2,
                                  tblocks=1)


def test_encode_rows(stream7, signal):
    rows, data = stream7
    _check_rows(rows, ["mode7_encode_realtime_x", "encode_msamples_s"])
    header = LinneHeader.unpack(data)
    assert (header.num_channels, header.num_samples) == signal.shape
    assert len(data) < signal.size * 2  # smaller than the 16-bit PCM


def test_decode_rows(stream7, signal):
    b = B.Bench(2, "cpu")
    rows = B.decode_rows(b, signal, RATE, SPB, stream7[1])
    _check_rows(rows, ["decode_mode0_realtime_x", "decode_mode7_realtime_x",
                       "decode_mode7_msamples_s"],
                ["decode_mode0_vs_c_ref_hw", "decode_mode7_vs_c_ref_hw"])


def test_corpus_rows():
    # near-silent input, so that -l's training stops after a few
    # iterations on the CPU
    sig = np.random.default_rng(3).integers(-3, 4, (2, 2 * 1024))
    b = B.Bench(2, "cpu")
    rows = B.corpus_rows(b, sig.astype(np.int32), RATE, 1024, tracks=2,
                         blocks=1)
    _check_rows(rows, ["corpus_encode_realtime_x",
                       "mode7_a2_encode_realtime_x",
                       "mode7_l_encode_realtime_x",
                       "corpus_decode_realtime_x",
                       "corpus_decode_msamples_s"],
                ["corpus_encode_bytes", "mode7_a2_encode_bytes",
                 "mode7_l_encode_bytes"])
    assert set(b.launches) == {
        f"{s}_cpu" for s in ("corpus_encode_realtime_x",
                             "mode7_a2_encode_realtime_x",
                             "mode7_l_encode_realtime_x",
                             "corpus_decode_realtime_x")}
    assert not any(b.launches.values())  # no kernel runs on the CPU


def test_decode_scaling_rows(signal):
    rows = B.decode_scaling_rows(B.Bench(2, "cpu"), signal, RATE, SPB,
                                 nblocks=2, copies=(1, 2))
    _check_rows(rows, ["decode_launch_floor_ms",
                       "decode_pooled_rows_4_msamples_s",
                       "decode_pooled_rows_8_msamples_s"])


def test_decode_under_load_rows(stream7, signal):
    # the host encoder's load kept to one block
    rows = B.decode_under_load_rows(B.Bench(1, "cpu"), signal, RATE, SPB,
                                    stream7[1], copies=2, hog_blocks=1)
    _check_rows(rows, ["decode_underload_native_msamples_s",
                       "decode_underload_device_msamples_s"])


def _exact_rows_check(rows, preset):
    names = B._EXACT_NAMES[preset]
    prefix, mode = names["prefix"], f"exact_device_mode{preset}_"
    _check_rows(rows, [names["host"], names["one"], names["corpus"]],
                [prefix + "byte_identical", prefix + "guard_flagged",
                 prefix + "guard_total"]
                + [mode + k for k in ("framing_s", "fit_enqueue_s",
                                      "row_wait_s", "split_wall_s")])
    assert rows[prefix + "byte_identical_cpu"] is True
    assert rows[prefix + "guard_flagged_cpu"] == 0
    assert rows[prefix + "guard_total_cpu"] > 0


def test_exact_rows_mode0_byte_identical():
    b = B.Bench(1, "cpu")
    rows = B.exact_device_rows(b, RATE, 512, 0, nblocks=2, ntracks=2,
                               tblocks=1)
    _exact_rows_check(rows, 0)


def test_exact_rows_mode7_byte_identical(exact7):
    b, rows = exact7
    _exact_rows_check(rows, 7)
    assert set(b.launches) == {
        f"{s}_cpu" for s in ("exact_host_encode_mode7_realtime_x_short",
                             "exact_device_encode_mode7_realtime_x",
                             "exact_device_corpus_mode7_realtime_x")}


def test_exact_split_within_wall(exact7):
    """Framing and the wait for rows, both on the calling thread, sum to
    no more than the run's wall; so do framing and the fit's enqueue
    here, where the corpus is one fit chunk and its fit ends before the
    first track is framed (on the card, with several chunks, the worker
    thread enqueues while the calling thread frames)."""
    _, rows = exact7
    split = {k: rows[f"exact_device_mode7_{k}_s_cpu"]
             for k in ("framing", "fit_enqueue", "row_wait", "split_wall")}
    assert all(v > 0 for v in split.values()), split
    assert split["framing"] + split["fit_enqueue"] <= split["split_wall"]
    assert split["framing"] + split["row_wait"] <= split["split_wall"]


def test_rep_that_differs_raises(signal, monkeypatch):
    """An encoder whose third call changes one byte: the warm run and the
    first rep agree, the second rep raises."""
    real = TorchEncoder.encode_whole
    calls = []

    def flaky(self, *args, **kw):
        data = real(self, *args, **kw)
        calls.append(1)
        if len(calls) == 3:
            data = data[:-1] + bytes([data[-1] ^ 1])
        return data

    monkeypatch.setattr(TorchEncoder, "encode_whole", flaky)
    with pytest.raises(RuntimeError, match="rep 2's output differs"):
        B.encode_rows(B.Bench(3, "cpu"), signal[:, :2 * SPB], RATE, SPB)
    assert len(calls) == 3


def test_digest():
    a = [b"abc", np.arange(4, dtype=np.int32), (np.zeros((2, 2)),)]
    same = [b"abc", np.arange(4, dtype=np.int32), (np.zeros((2, 2)),)]
    assert B.digest(a) == B.digest(same)
    for other in ([b"abd", a[1], a[2]],
                  [b"abc", np.arange(4, dtype=np.int64), a[2]],
                  [b"abc", a[1], (np.zeros(4),)],
                  [b"ab", b"c", a[1], a[2]],
                  [b"ab", b"c" + a[1].tobytes(), a[2]]):
        assert B.digest(other) != B.digest(a)
    with pytest.raises(TypeError):
        B.digest([1.0])


_ROW_FUNCTIONS = ("encode_rows", "decode_rows", "corpus_rows",
                  "decode_scaling_rows", "decode_under_load_rows",
                  "exact_device_rows")


def test_main_without_card_raises(monkeypatch, capsys):
    """No card and no --device cpu: main raises before any row runs, and
    prints no result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    for name in _ROW_FUNCTIONS:
        monkeypatch.setattr(B, name, lambda *a, _n=name, **k: calls.append(_n))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        B.main([])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        B.main(["--device", "cuda:0", "--reps", "1"])
    assert not calls
    assert capsys.readouterr().out == ""


def test_main_prints_one_json_line(monkeypatch, capsys):
    """The run's wiring, with each row function stubbed: the last line of
    stdout is the result object, the headline first, and stderr carries
    the `# ` lines."""
    stub = {"encode_rows": ({"mode7_encode_realtime_x_cpu": 69.47}, b"x"),
            "decode_rows": {"decode_mode0_realtime_x_cpu": 1.0},
            "corpus_rows": {"corpus_encode_realtime_x_cpu": 2.0},
            "decode_scaling_rows": {"decode_launch_floor_ms_cpu": 0.5},
            "decode_under_load_rows": {"decode_underload_native_cpu": 3.0},
            "exact_device_rows": {"exact_device_corpus_realtime_x_cpu": 4.0}}
    for name, out in stub.items():
        monkeypatch.setattr(B, name, lambda *a, _o=out, **k: _o)
    monkeypatch.setattr(B, "make_signal", lambda n, rate=RATE: None)
    assert B.main(["--device", "cpu", "--reps", "1"]) == 0
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[-1])
    assert result["metric"] == "mode7_encode_realtime_x_cpu"
    assert result["value"] == 69.47 and result["unit"] == "x_realtime"
    assert result["vs_baseline"] == pytest.approx(69.47 / (100 / 14.3959))
    assert result["reps"] == 1 and result["card"] == "none (cpu run)"
    assert result["exact_device_corpus_realtime_x_cpu"] == 4.0
    assert "# card: none (cpu run)" in captured.err
    with pytest.raises(ValueError):
        B.Bench(0, "cpu")
