"""The port's decoders under hostile streams: the counterpart of
tests/test_fuzz_decoder.py for linne_tpu_torch's Decoder, StreamingDecoder
and TorchDecoder(device="cpu"), on streams of the port's
TorchEncoder(device="cpu").

Corrupted, truncated and random streams must raise FormatError (or its
CorruptionError subclass) or decode to samples, with CRC checking on or
off. TorchDecoder must agree with the port's host Decoder and with the
JAX package's host Decoder on every input: all raise, or all give the
same samples. The JAX package's host Decoder is the reference: it follows
the reference decoder's semantics, which its native runtime
(native/linne_host.cpp) implements, and shares no code with the port, so
a fault of the port's host copy cannot hide a fault of TorchDecoder.

Hostile inputs come from tests/torch_hostile_streams.py, which
chip_smoke.py's hostile-stream phase sends through TorchDecoder on the
card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import WAVEFORMS
from linne_tpu.codec.decoder import Decoder as JaxDecoder
from linne_tpu.codec.params import DecoderConfig as JaxDecoderConfig
from linne_tpu.format.header import FormatError as JaxFormatError
from linne_tpu_torch.codec.decoder import Decoder
from linne_tpu_torch.codec.encoder import TorchEncoder
from linne_tpu_torch.codec.params import DecoderConfig, EncodeParameter
from linne_tpu_torch.codec.streaming import StreamingDecoder
from linne_tpu_torch.codec.torch_decoder import TorchDecoder
from linne_tpu_torch.constants import (
    CH_PROCESS_MS,
    CH_PROCESS_NONE,
    BLOCK_TYPE_SILENT,
    HEADER_SIZE,
)
from linne_tpu_torch.format.header import FormatError, LinneHeader
from linne_tpu_torch.presets import PRESETS

import torch_hostile_streams as H

# two full blocks and a tail: the pooled decode runs two block-length
# groups. The block is shorter than the JAX test's 2560 so that
# TorchDecoder's plain synthesis (a Python loop over time) stays quick.
SPB = 1024
LENGTH = 2 * SPB + 300
NO_CRC = DecoderConfig(check_crc=False)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the plain synthesis runs many small ops,
    which slow down when several test workers oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _encode(preset, nch=2, bps=16, wave="gauss", silent_tail=False):
    samples = WAVEFORMS[wave](LENGTH, nch, bps)
    if silent_tail:
        samples[:, 2 * SPB:] = 0
    enc = TorchEncoder(device="cpu")
    enc.set_encode_parameter(EncodeParameter(
        num_channels=nch, bits_per_sample=bps, sampling_rate=44100,
        num_samples_per_block=SPB, preset=preset,
        ch_process_method=CH_PROCESS_MS if nch > 1 else CH_PROCESS_NONE))
    return enc.encode_whole([samples[c] for c in range(nch)], LENGTH)


@pytest.fixture(scope="module")
def stream():
    """The JAX test's recipe (gauss, stereo 16-bit, preset 2, MS)."""
    return _encode(2)


@pytest.fixture(scope="module")
def streams():
    """Stereo 16-bit at presets 0, 2 and 7, a mono 24-bit sine at preset
    7, and a stereo sine whose tail is a silent block."""
    out = {f"p{p}": _encode(p) for p in (0, 2, 7)}
    out["mono24"] = _encode(7, nch=1, bps=24, wave="sine")
    out["silent_tail"] = _encode(2, wave="sine", silent_tail=True)
    return out


def _host(data, cfg=NO_CRC):
    return Decoder(cfg).decode_whole(data)


def _torch(data, cfg=NO_CRC):
    return TorchDecoder(cfg, device="cpu").decode_whole(data)


def _jax(data, cfg=NO_CRC):
    """The JAX package's host Decoder under the same config."""
    return JaxDecoder(JaxDecoderConfig(**dataclasses.asdict(cfg))
                      ).decode_whole(data)


def _streaming(data, cfg=NO_CRC, chunk=4096):
    sd = StreamingDecoder(data, cfg)
    parts = []
    while not sd.exhausted:
        part = sd.read(chunk)
        if part.shape[1] == 0:
            break
        parts.append(part)
    return parts


DECODERS = {"host": _host, "torch": _torch, "streaming": _streaming}


def _outcome(decode, data):
    """The samples, or None where the decoder raised FormatError (the
    port's or the JAX package's)."""
    try:
        return decode(data)
    except (FormatError, JaxFormatError):
        return None


def _assert_agree(data, what=""):
    """TorchDecoder and the port's host Decoder against the JAX package's
    host Decoder: all raise FormatError, or all give the same samples.
    Returns True where they gave samples."""
    want = _outcome(_jax, data)
    for name, decode in (("host", _host), ("TorchDecoder", _torch)):
        got = _outcome(decode, data)
        assert (want is None) == (got is None), (
            f"{what}: the JAX Decoder "
            f"{'raised' if want is None else 'decoded'}, {name} "
            f"{'raised' if got is None else 'decoded'}")
        if want is not None:
            assert len(want) == len(got)
            for w, g in zip(want, got):
                assert np.array_equal(w, g), f"{what}: {name}'s samples differ"
    return want is not None


def test_giant_num_samples_header_rejected(stream):
    """A corrupt num_samples that no body of the stream's size can carry
    is a FormatError before anything is allocated, CRC on or off; a
    plausible but wrong one still errors (the body ends early)."""
    bad = H.giant_num_samples(stream)
    for crc in (True, False):
        cfg = DecoderConfig(check_crc=crc)
        for decode in (_jax, _host, _torch):
            with pytest.raises((FormatError, JaxFormatError)):
                decode(bad, cfg)
    bad = bytearray(stream)
    bad[14:18] = (3 * SPB + 300).to_bytes(4, "big")
    for decode in (_jax, _host, _torch):
        with pytest.raises((FormatError, JaxFormatError)):
            decode(bytes(bad), DecoderConfig())


def test_per_block_corrupt_payload_raises_format_error(stream):
    """The per-block path (StreamingDecoder over Decoder.decode_block)
    raises FormatError or CorruptionError on corrupt payloads, never a
    raw RuntimeError."""
    hits = 0
    for bad in H.mutations(stream, 60, seed=31, start=40):
        for crc in (True, False):
            try:
                _streaming(bad, DecoderConfig(check_crc=crc))
            except FormatError:
                hits += 1  # includes CorruptionError
    assert hits > 0, "corruptions never reached the payload error path"


@pytest.mark.parametrize("decoder", ["host", "torch", "streaming"])
def test_random_byte_corruption(stream, decoder):
    """1-7 random bytes past the header, CRC off: a FormatError or
    samples, nothing else."""
    rng = np.random.default_rng(0)
    for _ in range(60):
        bad = bytearray(stream)
        for _ in range(int(rng.integers(1, 8))):
            bad[int(rng.integers(30, len(bad)))] = int(rng.integers(0, 256))
        _outcome(DECODERS[decoder], bytes(bad))


@pytest.mark.parametrize("decoder", ["host", "torch", "streaming"])
def test_truncations(stream, decoder):
    """Every cut of the stream 7 bytes apart over its first 400 bytes,
    then 97 apart: a truncated body is a FormatError for the whole-stream
    decoders; the streaming one stops or raises FormatError."""
    cuts = list(range(30, 400, 7)) + list(range(400, len(stream), 97))
    for cut in cuts:
        got = _outcome(DECODERS[decoder], stream[:cut])
        if decoder != "streaming":
            assert got is None, f"cut {cut} decoded"


@pytest.mark.parametrize("decoder", ["host", "torch", "streaming"])
def test_random_payload_after_valid_header(stream, decoder):
    rng = np.random.default_rng(1)
    for _ in range(50):
        junk = rng.integers(0, 256, size=500, dtype=np.uint8).tobytes()
        _outcome(DECODERS[decoder], stream[:30] + junk)


@pytest.mark.parametrize("decoder", ["host", "torch", "streaming"])
def test_crc_catches_corruption(stream, decoder):
    """With CRC on (the default), every payload corruption is detected:
    a CorruptionError, or a FormatError where the flip hits a frame
    field."""
    rng = np.random.default_rng(2)
    for _ in range(30):
        bad = bytearray(stream)
        bad[int(rng.integers(60, len(bad)))] ^= 0x80
        with pytest.raises(FormatError):
            DECODERS[decoder](bytes(bad), DecoderConfig(check_crc=True))


@pytest.mark.parametrize("name", ["p0", "p2", "p7", "mono24"])
def test_differential_host_vs_torch_decoder(streams, name):
    """Seeded mutations (1-5 bytes at offset 30 or later, CRC off) of each
    stream: TorchDecoder, the port's host Decoder and the JAX package's
    host Decoder all raise FormatError, or all give the same samples."""
    data = streams[name]
    decoded = sum(_assert_agree(bad, f"{name} mutation {k}") for k, bad in
                  enumerate(H.mutations(data, 100, seed=3)))
    assert decoded > 0  # some mutations must decode (garbage) identically


@pytest.mark.parametrize("name", ["p2", "mono24"])
def test_differential_header_and_frame_mutations(streams, name):
    """Mutations anywhere in the stream header or a block's frame fields
    (size, CRC, type, num_samples), CRC off: TorchDecoder and the port's
    host Decoder agree with the JAX package's host Decoder."""
    data = streams[name]
    rng = np.random.default_rng(5)
    frames = H.block_offsets(data)
    for k in range(60):
        bad = bytearray(data)
        if k % 2:
            bad[int(rng.integers(0, 30))] = int(rng.integers(0, 256))
        else:
            off = frames[int(rng.integers(len(frames)))]
            bad[off + int(rng.integers(2, 11))] = int(rng.integers(0, 256))
        _assert_agree(bytes(bad), f"{name} mutation {k}")


def test_streaming_decoder_fuzz(stream):
    """The pull decoder on streams mutated anywhere, header included:
    FormatError, ValueError from a header field, or samples."""
    rng = np.random.default_rng(11)
    for _ in range(60):
        bad = bytearray(stream)
        for _ in range(int(rng.integers(1, 6))):
            bad[int(rng.integers(0, len(bad)))] = int(rng.integers(0, 256))
        try:
            _streaming(bytes(bad), chunk=777)
        except (FormatError, ValueError):
            pass


@pytest.mark.parametrize("name", ["p0", "p2", "p7", "mono24"])
def test_units_above_order_decodes_as_the_host_decoder(streams, name):
    """A compress block whose side info gives a layer more units than
    taps (order // units == 0) decodes as the native runtime decodes it:
    the layer leaves those rows as they are. TorchDecoder gives the port's
    and the JAX package's host Decoder samples, CRC on."""
    data = H.units_above_order(streams[name])
    units = H.layer_units(data)
    orders = PRESETS[LinneHeader.unpack(data).preset].layer_num_params
    assert any(u > p for u, p in zip(units[0], orders)), (units, orders)
    want = _host(data, DecoderConfig())
    jax_want = JaxDecoder().decode_whole(data)
    got = _torch(data, DecoderConfig())
    for w, j, g in zip(want, jax_want, got):
        assert np.array_equal(w, j)
        assert np.array_equal(w, g)


@pytest.mark.parametrize("name", ["p2", "mono24"])
def test_rshift_zero_rows_take_the_flagged_refetch(streams, name):
    """rshift 0 in one channel's layers: no rounding offset, no shift, so
    the recurrence grows past the download width; the flagged rows come
    back at int32 and TorchDecoder gives the port's and the JAX package's
    host Decoder samples."""
    data = H.rshift_zero(streams[name])
    dec = TorchDecoder(device="cpu")
    got = dec.decode_whole(data)
    assert dec.flagged_rows > 0
    want = _jax(data, DecoderConfig())
    for w, h, g in zip(want, _host(data, DecoderConfig()), got):
        assert np.array_equal(w, h)
        assert np.array_equal(w, g)


@pytest.mark.parametrize("case", [
    "past_num_samples", "short_of_num_samples", "frame_size_below_5",
    "compress_zero_samples", "type_3"])
def test_block_frame_faults_agree(streams, case):
    """Frame fields the native block scan rejects: a block that runs past
    the header's num_samples, a block_size below the 5 bytes of its fixed
    fields, a compress block of 0 samples, an unknown type. The JAX
    package's host Decoder raises, and so do the port's host Decoder and
    TorchDecoder. The stream's last
    block is silent, so no payload error hides a frame check."""
    data = streams["silent_tail"]
    last = len(H.block_offsets(data)) - 1
    assert H.block_kinds(data)[last] == BLOCK_TYPE_SILENT
    bad = {
        "past_num_samples": lambda: H.block_samples_field(data, last, 400),
        "short_of_num_samples": lambda: H.block_samples_field(
            data, last, 200),
        "frame_size_below_5": lambda: H.block_size_field(
            data, last, 0)[: H.block_offsets(data)[last] + 11],
        "compress_zero_samples": lambda: H.block_samples_field(data, 0, 0),
        "type_3": lambda: (data[:HEADER_SIZE + 8] + b"\x03"
                           + data[HEADER_SIZE + 9:]),
    }[case]()
    with pytest.raises(JaxFormatError):
        _jax(bad)
    with pytest.raises(FormatError):
        _host(bad)
    with pytest.raises(FormatError):
        _torch(bad)
