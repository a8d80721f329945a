"""The codec's spans (utils/profiling.py: `span`, `record_spans`, `trace`)
and the `queue_waits` counters of `TorchEncoder` and `TorchDecoder`, on the
CPU: spans off record nothing; under `trace` the encode and decode phases
appear once per batch (or group) and nest in their entry call; the
counters follow the copies that wait for all the work queued on the
device."""

import numpy as np
import pytest
import torch

from linne_tpu_torch.codec import encoder as E
from linne_tpu_torch.codec import torch_decoder as TD
from linne_tpu_torch.codec.encoder import TorchEncoder
from linne_tpu_torch.codec.params import EncodeParameter
from linne_tpu_torch.constants import CH_PROCESS_MS
from linne_tpu_torch.utils import profiling

SPB = 2048


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _encoder(bps=16, batch_blocks=2, **kw):
    enc = TorchEncoder(batch_blocks=batch_blocks, **kw)
    enc.set_encode_parameter(EncodeParameter(
        num_channels=2, bits_per_sample=bps, sampling_rate=44100,
        num_samples_per_block=SPB, preset=0, ch_process_method=CH_PROCESS_MS))
    return enc


def _noise(n, seed, scale=300.0):
    rng = np.random.default_rng(seed)
    return np.round(rng.normal(0, scale, (2, n))).astype(np.int32)


def _encode(enc, tracks):
    return enc.encode_many([[t[0], t[1]] for t in tracks],
                           [t.shape[1] for t in tracks])


def _spans(prof):
    """[(name, start, end, thread)] of the codec's spans in a trace."""
    return [(ev.name, ev.time_range.start, ev.time_range.end, ev.thread)
            for ev in prof.events()
            if ev.name.startswith(profiling.SPAN_PREFIX)]


def _inside(inner, outer):
    return (inner[3] == outer[3] and outer[1] <= inner[1]
            and inner[2] <= outer[2])


def test_spans_off_never_call_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with spans off")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert profiling.record_spans(False) is False
    assert profiling.span("encode") is profiling.span("decode.parse")
    tracks = [_noise(2 * SPB + 100, 1)]
    streams = _encode(_encoder(device="cpu"), tracks)
    out = TD.TorchDecoder(device="cpu").decode_many(streams)
    assert np.array_equal(np.stack(out[0]), tracks[0])
    # the same calls with spans on reach the patched record_function
    profiling.record_spans(True)
    try:
        with pytest.raises(AssertionError, match="linne.encode"):
            _encode(_encoder(device="cpu"), tracks)
    finally:
        profiling.record_spans(False)


def test_trace_turns_spans_on_inside_and_restores_them(tmp_path):
    assert profiling.record_spans(False) is False
    with profiling.trace(str(tmp_path)):
        with profiling.span("encode"):
            pass
        assert profiling.record_spans(True) is True
    assert profiling.record_spans(False) is False
    profiling.record_spans(True)
    try:
        with profiling.trace(str(tmp_path / "again")):
            pass
        assert profiling.record_spans(False) is True
    finally:
        profiling.record_spans(False)


def test_encode_many_spans_nest_once_per_batch(tmp_path):
    """Two tracks of two full blocks and a host tail each, two blocks a
    batch: one dispatch and one drain a batch (each with its phases),
    every one inside the single `linne.encode`, on one thread."""
    enc = _encoder(device="cpu")
    tracks = [_noise(2 * SPB + 300, 2), _noise(2 * SPB + 300, 3)]
    batches = len(enc.batch_widths)
    with profiling.trace(str(tmp_path)) as prof:
        _encode(enc, tracks)
    batches = len(enc.batch_widths) - batches
    assert batches == 2
    spans = _spans(prof)
    by_name = {}
    for s in spans:
        by_name.setdefault(s[0][len(profiling.SPAN_PREFIX):], []).append(s)
    (top,) = by_name["encode"]
    for name in ("encode.split", "encode.tails", "encode.frame"):
        assert len(by_name[name]) == 1
    for name in ("encode.dispatch", "encode.drain"):
        assert len(by_name[name]) == batches
    # staging: the batch's padding and narrowing, then each shard's rows
    # (one shard on one device)
    assert len(by_name["encode.dispatch.stage"]) == 2 * batches
    for name in ("encode.dispatch.stage", "encode.dispatch.launch",
                 "encode.dispatch.fetch", "encode.drain.wait",
                 "encode.drain.overflow", "encode.drain.pack"):
        if name != "encode.dispatch.stage":
            assert len(by_name[name]) == batches
        parent = name.rsplit(".", 1)[0]
        for s in by_name[name]:
            assert any(_inside(s, p) for p in by_name[parent]), name
    assert all(_inside(s, top) for s in spans)
    # the phases of one parent follow each other
    for d in by_name["encode.dispatch"]:
        kids = sorted((s for s in spans if s[0].startswith(d[0] + ".")
                       and _inside(s, d)), key=lambda s: s[1])
        assert [k[0].rsplit(".", 1)[1] for k in kids] == [
            "stage", "stage", "launch", "fetch"]


def test_decode_many_shows_each_decode_span(tmp_path):
    tracks = [_noise(2 * SPB + 300, 4), _noise(SPB + 300, 5)]
    streams = _encode(_encoder(device="cpu"), tracks)
    dec = TD.TorchDecoder(device="cpu")
    with profiling.trace(str(tmp_path)) as prof:
        out = dec.decode_many(streams)
    for o, t in zip(out, tracks):
        assert np.array_equal(np.stack(o), t)
    spans = _spans(prof)
    names = [s[0][len(profiling.SPAN_PREFIX):] for s in spans]
    assert names.count("decode") == 1
    (top,) = [s for s in spans if s[0] == "linne.decode"]
    assert names.count("decode.parse") == names.count("decode.assemble") == 1
    # two block lengths: the full blocks and the tails, one upload, layer
    # loop and download each
    for name in ("decode.upload", "decode.layers", "decode.download"):
        assert names.count(name) == 2
    assert all(_inside(s, top) for s in spans)


def _drain_waits(enc, monkeypatch):
    """Record (queue_waits added, overflow rows added) of every drain."""
    seen = []
    drain = enc._drain_batch

    def recording(*item):
        w, r = enc.queue_waits, enc.overflow_rows
        out = drain(*item)
        seen.append((enc.queue_waits - w, enc.overflow_rows - r))
        return out

    monkeypatch.setattr(enc, "_drain_batch", recording)
    return seen


@pytest.mark.parametrize("devices", [["cpu"], ["cpu", "cpu"]])
def test_encoder_queue_waits_follow_the_overflow_fetch(monkeypatch, devices):
    """At a 6-bit class every live block overflows; silent blocks do not.
    A batch adds two waits (the index's pageable upload and the blocking
    read) for each shard that holds an overflow row and none otherwise;
    building a block length's chain adds one upload of the ridge terms a
    distinct device."""
    monkeypatch.setattr(E, "_res_width_classes", lambda bps: (6,))
    loud = _noise(2 * SPB, 6)
    silent = np.zeros((2, 2 * SPB), np.int32)
    enc = _encoder(devices=devices)
    seen = _drain_waits(enc, monkeypatch)
    _encode(enc, [loud, silent])
    # the loud track's batch (one row a shard over two entries), then the
    # silent one's
    assert seen == [(2 * len(devices), 2), (0, 0)]
    assert enc.queue_waits == len(set(enc.devices)) + 2 * len(devices)
    # a built chain uploads nothing more
    seen.clear()
    before = enc.queue_waits
    _encode(enc, [silent, loud, loud])
    assert seen == [(0, 0), (2 * len(devices), 2), (2 * len(devices), 2)]
    assert enc.queue_waits - before == 4 * len(devices)


def test_encoder_queue_waits_without_overflow_are_the_chain_alone():
    """At the widest class no block of quiet material overflows: the
    count is the ridge upload of the one chain built."""
    enc = _encoder(device="cpu")
    _encode(enc, [_noise(4 * SPB, 7, scale=40.0)])
    assert enc.overflow_rows == 0
    assert enc.queue_waits == 1


def _wide_stream():
    """A 24-bit stream whose residual rows all exceed int16: four full
    blocks and a tail."""
    rng = np.random.default_rng(8)
    n = 4 * SPB + 500
    t = np.arange(n)
    tone = 3e6 * np.sin(2 * np.pi * 330 * t / 44100)
    sig = np.round(np.stack([tone, 0.5 * tone])
                   + rng.normal(0, 1 << 14, (2, n))).astype(np.int32)
    enc = _encoder(bps=24, batch_blocks=4, device="cpu")
    return sig, enc.encode_whole([sig[0], sig[1]], n)


@pytest.mark.parametrize("width,devices", [
    (None, ["cpu"]),          # int32 patches, nothing flagged
    (6, ["cpu"]),             # every row flagged and fetched again
    (6, ["cpu", "cpu"]),      # the same on two shards a block length
])
def test_decoder_queue_waits_follow_uploads_and_refetch(monkeypatch, width,
                                                        devices):
    """Per block length and shard: one upload of the int16 rows, two for
    the int32 patch (its index and its rows), three a synthesis group
    (index, coefficients, shifts), and two for the flagged refetch."""
    sig, data = _wide_stream()
    if width is not None:
        monkeypatch.setattr(TD, "_download_width", lambda bps: width)
    launches = []
    synth = TD.synthesize_rows

    def counting(x, c, rs):
        launches.append(x.shape[0])
        return synth(x, c, rs)

    monkeypatch.setattr(TD, "synthesize_rows", counting)
    dec = TD.TorchDecoder(devices=devices)
    (out,) = dec.decode_many([data])
    assert np.array_equal(np.stack(out), sig)
    # four full blocks and a tail, split into shards of whole blocks
    shards = sum(min(blocks, len(devices)) for blocks in (4, 1))
    want = shards * (1 + 2) + 3 * len(launches)
    if width is not None:
        want += 2 * shards
    assert dec.flagged_rows == (2 * 5 if width else 0)
    assert dec.queue_waits == want
