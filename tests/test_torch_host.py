"""The port's own copies of the host layers against the JAX package's:
the byte-exact ExactEncoder, the host Decoder, the native payload packer
and unpacker, WAV I/O, and the pure-Python path taken without the native
library.

Everything here is integer or strict serial float64 on the host, so every
comparison is exact: equal bytes, equal samples. Streams are kept to three
blocks of 2048 samples because the exact path is slow on purpose.
"""

import numpy as np
import pytest

from linne_tpu import native as jax_native
from linne_tpu.codec.decoder import Decoder as JaxDecoder
from linne_tpu.codec.params import EncodeParameter as JaxEncodeParameter
from linne_tpu.exact.encoder import ExactEncoder as JaxExactEncoder
from linne_tpu.io import wav as jax_wav
from linne_tpu_torch import native
from linne_tpu_torch.codec.decoder import Decoder
from linne_tpu_torch.codec.params import EncodeParameter
from linne_tpu_torch.constants import BLOCK_TYPE_COMPRESS, HEADER_SIZE
from linne_tpu_torch.exact.encoder import ExactEncoder
from linne_tpu_torch.format.block import BLOCK_HEADER_SIZE, parse_block_header
from linne_tpu_torch.format.huffman import get_codebook
from linne_tpu_torch.format.rice import _max_porder
from linne_tpu_torch.io import wav
from linne_tpu_torch.presets import PRESETS

SPB = 2048
N = 2 * SPB + 500  # two full blocks and a tail
_CASES = [(preset, ch) for preset in (0, 4, 7) for ch in (1, 2)]


def _signal(n, ch, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    left = (8000 * np.sin(2 * np.pi * 220 * t / 44100)
            + 2500 * np.sin(2 * np.pi * 1870 * t / 44100)
            + rng.normal(0, 250, n))
    rows = [left] + [0.7 * left + rng.normal(0, 300, n)
                     for _ in range(ch - 1)]
    return np.clip(np.round(np.stack(rows)), -32768, 32767).astype(np.int32)


def _encode(encoder_cls, param_cls, sig, preset):
    ch = sig.shape[0]
    enc = encoder_cls()
    enc.set_encode_parameter(param_cls(
        num_channels=ch, bits_per_sample=16, sampling_rate=44100,
        num_samples_per_block=SPB, preset=preset,
        ch_process_method=1 if ch >= 2 else 0))
    return enc.encode_whole([sig[c] for c in range(ch)], sig.shape[1])


@pytest.fixture(scope="module")
def jax_streams():
    """linne_tpu's ExactEncoder bytes per (preset, channels)."""
    return {(preset, ch): _encode(JaxExactEncoder, JaxEncodeParameter,
                                  _signal(N, ch, 10 * preset + ch), preset)
            for preset, ch in _CASES}


@pytest.mark.parametrize("preset,ch", _CASES)
def test_exact_encoder_bytes_equal(jax_streams, preset, ch):
    sig = _signal(N, ch, 10 * preset + ch)
    data = _encode(ExactEncoder, EncodeParameter, sig, preset)
    assert data == jax_streams[(preset, ch)]


@pytest.mark.parametrize("preset,ch", _CASES)
def test_decoder_equals_jax_decoder(jax_streams, preset, ch):
    data = jax_streams[(preset, ch)]
    sig = _signal(N, ch, 10 * preset + ch)
    ours = Decoder().decode_whole(data)
    theirs = JaxDecoder().decode_whole(data)
    for c in range(ch):
        assert np.array_equal(ours[c], theirs[c])
        assert np.array_equal(ours[c], sig[c])


def _compress_payloads(data):
    """(n, payload) of every compress block of a stream."""
    out = []
    off = HEADER_SIZE
    while off < len(data):
        bh = parse_block_header(data[off:])
        if bh.block_type == BLOCK_TYPE_COMPRESS:
            start = off + BLOCK_HEADER_SIZE
            out.append((bh.num_samples, data[start : off + bh.total_size]))
        off += bh.total_size
    return out


@pytest.mark.parametrize("preset,ch", _CASES)
def test_native_pack_unpack_equal(jax_streams, preset, ch):
    """Both libraries unpack every compress payload to the same arrays,
    and pack those arrays back to the same bytes, which are the
    payload's."""
    assert native.available() and jax_native.available()
    preset_def = PRESETS[preset]
    cb = get_codebook(preset_def.coef_freq_table)
    orders = np.asarray(preset_def.layer_num_params, np.int32)
    payloads = _compress_payloads(jax_streams[(preset, ch)])
    assert payloads
    for n, payload in payloads:
        args = (payload, cb.node0_array, cb.node1_array, cb.root,
                cb.num_symbols, ch, n, 16, orders)
        ours = native.unpack_compress_payload(*args)
        theirs = jax_native.unpack_compress_payload(*args)
        for a, b in zip(ours, theirs):
            assert np.array_equal(a, b)
        res, coefs, log2u, rshift, pprev, pcoef, _consumed = ours
        porder = np.empty(ch, np.int32)
        k2s = np.zeros((ch, 1 << _max_porder(n)), np.int32)
        for c in range(ch):
            po, k2 = native.exact_rice_search(res[c])
            porder[c] = po
            k2s[c, : k2.shape[0]] = k2
        pack = (res, coefs, log2u, rshift, pprev, pcoef, porder, k2s,
                cb.codes_array, cb.lens_array, 16, orders)
        packed = native.pack_compress_payload(*pack)
        assert packed == jax_native.pack_compress_payload(*pack)
        assert packed == payload


@pytest.mark.parametrize("ch,bps", [(1, 8), (2, 16), (2, 24), (8, 16)])
def test_wav_round_trip_same_bytes(tmp_path, ch, bps):
    rng = np.random.default_rng(ch * bps)
    lim = 1 << (bps - 1)
    sig = rng.integers(-lim, lim, (ch, 1001)).astype(np.int32)
    ours, theirs = tmp_path / "ours.wav", tmp_path / "theirs.wav"
    wav.write_wav(str(ours), sig, 44100, bps)
    jax_wav.write_wav(str(theirs), sig, 44100, bps)
    assert ours.read_bytes() == theirs.read_bytes()
    fmt, back = wav.read_wav(str(theirs))
    jfmt, jback = jax_wav.read_wav(str(ours))
    assert (fmt.num_channels, fmt.sampling_rate, fmt.bits_per_sample,
            fmt.num_samples) == (jfmt.num_channels, jfmt.sampling_rate,
                                 jfmt.bits_per_sample, jfmt.num_samples)
    assert np.array_equal(np.stack(back), sig)
    assert np.array_equal(np.stack(jback), sig)


@pytest.mark.parametrize("preset,ch", [(0, 1), (4, 2), (7, 2)])
def test_no_native_path_same_bytes(jax_streams, monkeypatch, preset, ch):
    """Without the native library the port's pure-Python exact encoder
    and decoder give linne_tpu's native bytes and samples."""
    monkeypatch.setattr(native, "available", lambda: False)
    sig = _signal(N, ch, 10 * preset + ch)
    data = _encode(ExactEncoder, EncodeParameter, sig, preset)
    assert data == jax_streams[(preset, ch)]
    out = Decoder().decode_whole(data)
    for c in range(ch):
        assert np.array_equal(out[c], sig[c])


@pytest.mark.parametrize("preset,ch", [(0, 1), (7, 2)])
def test_streaming_decoder_equals_jax(jax_streams, preset, ch):
    """Pulls of uneven sizes, then seeks into the middle of a block, to a
    block edge, to the end and back to 0: the same frames as the JAX
    package's StreamingDecoder, and the signal's."""
    from linne_tpu.codec.streaming import StreamingDecoder as JaxStreaming
    from linne_tpu_torch.codec.streaming import StreamingDecoder

    data = jax_streams[(preset, ch)]
    sig = _signal(N, ch, 10 * preset + ch)
    ours, theirs = StreamingDecoder(data), JaxStreaming(data)
    pos = 0
    for size in (1, 777, SPB, 3000, 5000):
        a, b = ours.read(size), theirs.read(size)
        assert np.array_equal(a, b)
        assert np.array_equal(a, sig[:, pos : pos + size])
        pos += a.shape[1]
    assert ours.exhausted and theirs.exhausted and pos == N
    for target in (SPB + 5, SPB, N, 0):
        ours.seek(target)
        theirs.seek(target)
        a, b = ours.read(600), theirs.read(600)
        assert np.array_equal(a, b)
        assert np.array_equal(a, sig[:, target : target + 600])


def test_file_backend_renders_jax_wav(jax_streams, tmp_path):
    """Player + FileBackend render the stream to the same 16-bit WAV as
    the JAX package's."""
    from linne_tpu import player as jax_player
    from linne_tpu.codec.streaming import StreamingDecoder as JaxStreaming
    from linne_tpu_torch import player
    from linne_tpu_torch.codec.streaming import StreamingDecoder

    data = jax_streams[(4, 2)]
    ours, theirs = tmp_path / "ours.wav", tmp_path / "theirs.wav"
    n = player.Player(StreamingDecoder(data),
                      player.FileBackend(str(ours))).run(1000)
    m = jax_player.Player(JaxStreaming(data),
                          jax_player.FileBackend(str(theirs))).run(1000)
    assert n == m == N
    assert ours.read_bytes() == theirs.read_bytes()
    fmt, back = wav.read_wav(str(ours))
    assert np.array_equal(np.stack(back), _signal(N, 2, 42))
