"""The byte-exact benchmark cell's plain reference and judge on the CPU.

`benchmark/reference/exact.py` (plain NumPy, strict serial float64, the
upstream C encoder's analysis written out) must give every block's type
and side information exactly as the port's byte-exact encoders write
them: `DeviceExactEncoder(device="cpu")` and the host oracle
`ExactEncoder`. The cell's judge (`benchmark/entries/exact_encode.py`)
must pass those streams and count the blocks of a stream that the batched
`TorchEncoder` wrote with its analysis in float32. Blocks of 2048 samples
keep the serial loops fast; the tracks hold a silent block, a block that
starts in silence (zero-signal unit fits), a full-scale noise block (raw)
and a tone, so the block-type estimate reads an arena value left by the
fits of an earlier block.
"""

import json
import pathlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.material import Corpus
from benchmark.entries import exact_encode
from benchmark.reference import exact, stream
from linne_tpu_torch.codec.encoder import TorchEncoder
from linne_tpu_torch.codec.params import EncodeParameter
from linne_tpu_torch.exact import device_encoder as de
from linne_tpu_torch.exact.encoder import ExactEncoder
from linne_tpu_torch.presets import PRESETS
from linne_tpu_torch.utils.profiling import SPAN_PREFIX, record_spans

ROOT = pathlib.Path(__file__).resolve().parent.parent
N = 2048
BLOCKS = 4


def _track(nch, seed):
    """[nch, 4 blocks + a tail]: silence, a tone that starts after 700
    zeros, full-scale noise, a tone with noise."""
    rng = np.random.default_rng(seed)
    n = BLOCKS * N + 300
    t = np.arange(n)
    rows = []
    for c in range(nch):
        tone = (rng.uniform(3000, 12000)
                * np.sin(2 * np.pi * rng.uniform(80, 3000) * t / 44100)
                + rng.normal(0, rng.uniform(20, 400), n))
        rows.append(tone)
    x = np.clip(np.round(np.stack(rows)), -32768, 32767).astype(np.int32)
    x[:, : N + 700] = 0
    x[:, 2 * N : 3 * N] = rng.integers(-32768, 32768, (nch, N))
    return x


def _config(preset, nch):
    cfg = json.loads((ROOT / "benchmark/configs/cd-m7-exact.json").read_text())
    cfg["format"].update(num_channels=nch, num_samples_per_block=N,
                         mid_side=nch == 2)
    cfg.update(preset=preset,
               layer_num_params=list(PRESETS[preset].layer_num_params),
               ridge_terms=list(PRESETS[preset].ridge_terms))
    return cfg


def _param(cfg):
    f = cfg["format"]
    return EncodeParameter(
        num_channels=f["num_channels"], bits_per_sample=16,
        sampling_rate=44100, preset=cfg["preset"],
        ch_process_method=1 if f["mid_side"] else 0,
        num_samples_per_block=N)


def _exact_stream(enc, cfg, x):
    enc.set_encode_parameter(_param(cfg))
    return enc.encode_whole(list(x), x.shape[1])


@pytest.fixture
def small_chunk(monkeypatch):
    monkeypatch.setattr(de, "_CHUNK", 4)


@pytest.mark.parametrize("nch", [1, 2])
@pytest.mark.parametrize("preset", [0, 7])
def test_reference_equals_the_byte_exact_encoders(small_chunk, preset, nch):
    cfg = _config(preset, nch)
    x = _track(nch, 40 + 10 * preset + nch)
    oracle = _exact_stream(ExactEncoder(), cfg, x)
    device = _exact_stream(de.DeviceExactEncoder(device="cpu"), cfg, x)
    assert device == oracle
    want = exact.analyse_tracks([x], BLOCKS, cfg)[0]
    assert [b.block_type for b in want] == [
        exact.BLOCK_SILENT, exact.BLOCK_COMPRESS, exact.BLOCK_RAW,
        exact.BLOCK_COMPRESS]
    parsed = stream.parse_streams([oracle], cfg["layer_num_params"])
    assert parsed.bad == [None]
    assert exact_encode.block_mismatches(parsed, 0, want) == 0
    # each field, block by block, as the stream carries it
    for b, ref in enumerate(want):
        btype, n, _g, row = parsed.blocks[0][b]
        assert btype == ref.block_type
        if btype == exact.BLOCK_COMPRESS:
            g = parsed.groups[n]
            for name in exact.FIELDS:
                assert np.array_equal(getattr(g, name)[row],
                                      getattr(ref, name)), (b, name)


def test_reference_stale_arena_value_reaches_the_estimate():
    """The estimate reads parcor[order] from the arena, one past what its
    own recursion writes: another value left there gives another
    estimate."""
    cfg = _config(7, 2)
    x = _track(2, 77)
    order = cfg["layer_num_params"][0]
    power, parcor, zc = exact.estimates(x[None, :, 3 * N : 4 * N], order, 16)
    fresh = np.zeros(exact.MAX_UNITS + 2)
    stale = fresh.copy()
    stale[order] = 0.5
    args = (float(power[0, 0]), parcor[0, 0], bool(zc[0, 0]), N, order)
    assert exact.code_length(fresh, *args) != exact.code_length(stale, *args)


def _judge(cfg, x, data):
    corpus = Corpus([x], [x.shape[1]], [[0]], 16)
    traffic = {"check": {"tracks": 8, "blocks": BLOCKS}}
    return exact_encode.judge(cfg, traffic, corpus, [(0, data)], 5, "cpu")


def test_judge_passes_exact_streams_and_counts_batched_float32_blocks():
    cfg = _config(7, 2)
    x = _track(2, 91)
    good = _judge(cfg, x, _exact_stream(ExactEncoder(), cfg, x))
    assert good["numbers"] == {"invalid_streams": 0, "lossless_failures": 0,
                               "exact_block_mismatches": 0}
    assert good["verdict"] == [True]
    batched = TorchEncoder(batch_blocks=8, device="cpu")
    batched.dtype = torch.float32
    batched.set_encode_parameter(_param(cfg))
    data = batched.encode_many([x], [x.shape[1]])[0]
    got = _judge(cfg, x, data)
    assert got["numbers"]["invalid_streams"] == 0
    assert got["numbers"]["lossless_failures"] == 0
    assert got["numbers"]["exact_block_mismatches"] > 0
    assert got["verdict"] == [False]


def test_exact_encode_many_spans_and_counters(small_chunk):
    """encode_many's spans under the profiler, the host refits counted
    (one tail a track and channel) and the fit's wait on the clock."""
    cfg = _config(0, 2)
    tracks = [_track(2, 5), _track(2, 6)]
    enc = de.DeviceExactEncoder(device="cpu")
    enc.set_encode_parameter(_param(cfg))
    previous = record_spans(True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = enc.encode_many(tracks, [t.shape[1] for t in tracks])
    finally:
        record_spans(previous)
    for t, data in zip(tracks, out):
        assert data == _exact_stream(ExactEncoder(), cfg, t)
    names = {ev.name for ev in prof.events()
             if ev.name.startswith(SPAN_PREFIX)}
    assert {"linne.exact", "linne.exact.prefit", "linne.exact.frame",
            "linne.exact.oracle"} <= names
    # the tails, and any row or decision the guard sent to the host
    assert enc.host_refit_rows == (2 * 2 + enc.guard_rows_flagged
                                   + 2 * enc.guard_decisions_flagged)
    assert enc.fit_wait_s >= 0.0
    assert enc.guard_rows_total == 2 * BLOCKS * 2
