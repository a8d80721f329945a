"""The W-bit transfers of the port against the JAX package on the CPU:
ops/bitpack.py bit for bit, the encoder's packed result (side columns and
the residual plane at each width class) bit for bit, the adaptive width
and the overflow fetch byte for byte, and the decoder's slim upload and
download (int16 rows with int32 patches, the W-bit plane with its overflow
flags, the chunked download) sample for sample.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import WAVEFORMS
from linne_tpu.codec import encoder as jax_encoder
from linne_tpu.codec import params as jax_params
from linne_tpu.codec.decoder import Decoder as JaxDecoder
from linne_tpu.codec.encoder import TpuEncoder
from linne_tpu.ops import bitpack as J
from linne_tpu_torch import native
from linne_tpu_torch.codec import encoder as E
from linne_tpu_torch.codec import torch_decoder as TD
from linne_tpu_torch.codec.decoder import Decoder
from linne_tpu_torch.codec.encoder import TorchEncoder
from linne_tpu_torch.codec.params import EncodeParameter
from linne_tpu_torch.constants import CH_PROCESS_MS
from linne_tpu_torch.ops import bitpack as T

SPB = 2048


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _plane(n, seed):
    """Random int32 rows [3, 2, n] with both int32 extremes."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2**31, 2**31, (3, 2, n), dtype=np.int64)
    x = x.astype(np.int32)
    x[0, 0, 0] = -2**31
    x[0, 1, -1] = 2**31 - 1
    return x


@pytest.mark.parametrize("width", range(1, 32))
def test_pack_plane_words_bit_equal_to_jax(width):
    """Every width, ragged lengths; the packed words invert through
    native.unpack_bits to the low `width` bits, sign-extended."""
    assert T.pack_geometry(width) == J.pack_geometry(width)
    g, _wpg = T.pack_geometry(width)
    sign = 1 << (width - 1)
    for n in (g + 3, 1000):
        x = _plane(n, width * 1000 + n)
        got = T.pack_plane_words(torch.from_numpy(x), width).numpy()
        want = np.asarray(jax.jit(J.pack_plane_words, static_argnums=1)(
            jnp.asarray(x), width))
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want), n
        low = ((x.astype(np.int64) & ((1 << width) - 1)) ^ sign) - sign
        back = native.unpack_bits(got, width, -(-n // g) * g)[..., :n]
        assert np.array_equal(back, low)


def _param(bps=16, preset=0, cls=EncodeParameter):
    return cls(num_channels=2, bits_per_sample=bps, sampling_rate=44100,
               num_samples_per_block=SPB, preset=preset,
               ch_process_method=CH_PROCESS_MS)


def _blocks(bps, count=4, seed=3):
    sig = WAVEFORMS["gauss"](count * SPB, 2, bps, seed=seed) // 64
    sig[:, :SPB] = WAVEFORMS["sine"](SPB, 2, bps)  # a tonal block
    sig[:, 2 * SPB : 3 * SPB] = 0                   # a silent block
    return np.ascontiguousarray(sig.reshape(2, count, SPB).transpose(1, 0, 2))


@pytest.fixture(scope="module")
def jax_analyze():
    """TpuEncoder's analysis per sample width (one compile of the pre and
    fit stages each; every W compiles its finish stage)."""
    out = {}
    for bps in (16, 24):
        enc = TpuEncoder(batch_blocks=4)
        enc.set_encode_parameter(_param(bps, cls=jax_params.EncodeParameter))
        out[bps] = enc._analyze_fn(SPB)[0]
    return out


@pytest.mark.parametrize("bps,width", [(16, 14), (16, 12), (16, 10),
                                       (24, 24), (24, 20)])
def test_packed_tensor_equals_tpu_encoder(jax_analyze, bps, width):
    """The packed result (flags, residual width, side columns, byte-packed
    coefficient and k2 planes, the W-bit residual plane) at every width
    class, and the int32 residual beside it."""
    assert width in E._res_width_classes(bps)
    assert E._res_width_classes(bps) == jax_encoder._res_width_classes(bps)
    blocks = _blocks(bps)
    enc = TorchEncoder(batch_blocks=4, device="cpu")
    enc.set_encode_parameter(_param(bps))
    got = enc._analyze_fn(SPB)[0](torch.from_numpy(blocks), width)
    want = jax_analyze[bps](blocks, width)
    assert np.array_equal(got["packed"].numpy(), np.asarray(want["packed"]))
    assert np.array_equal(got["residual"].numpy(),
                          np.asarray(want["residual"]))


def _corpus():
    """A quiet track, then a loud one: six batches of two blocks and a
    host-encoded tail."""
    t = np.arange(6 * SPB)
    quiet = np.round(140 * np.sin(2 * np.pi * 220 * t / 44100)
                     + 20 * np.sin(2 * np.pi * 0.013 * t)).astype(np.int32)
    loud = WAVEFORMS["gauss"](5 * SPB + 300, 2, 16, seed=4)
    return [np.stack([quiet, -quiet]), loud]


def _encode_both(tracks, bps=16, **kw):
    """(port streams, port encoder, JAX streams, the JAX widths)."""
    chans = [[t[0], t[1]] for t in tracks]
    lengths = [t.shape[1] for t in tracks]
    enc = TorchEncoder(batch_blocks=2, **kw)
    enc.set_encode_parameter(_param(bps))
    ours = enc.encode_many(chans, lengths)
    ref = TpuEncoder(batch_blocks=2)
    ref.set_encode_parameter(_param(bps, cls=jax_params.EncodeParameter))
    widths = []
    pick = ref._pick_width

    def recording(n):
        widths.append(pick(n))
        return widths[-1]

    ref._pick_width = recording
    return ours, enc, ref.encode_many(chans, lengths), widths


def test_adaptive_width_sequence_equals_tpu_encoder():
    """The W of every dispatch over a quiet and a loud track, and the
    bytes, equal TpuEncoder's. Three batches are in flight before the
    first drain, so batches 1-3 go at the widest class, and batches 4-6
    (the loud track) at the narrow class the quiet batches chose: each of
    their five blocks overflows and takes its int32 rows."""
    tracks = _corpus()
    ours, enc, theirs, widths = _encode_both(tracks, device="cpu")
    assert ours == theirs
    assert enc.batch_widths == widths == [14, 14, 14, 10, 10, 10]
    assert enc.overflow_rows == 5
    for data, t in zip(ours, tracks):
        assert np.array_equal(np.stack(Decoder().decode_whole(data)), t)


@pytest.mark.parametrize("devices", [["cpu"], ["cpu", "cpu"]])
def test_forced_overflow_equals_tpu_encoder(monkeypatch, devices):
    """With a 6-bit class every live block overflows and takes its int32
    rows from the residual tensor of the shard that holds it: the bytes
    still equal TpuEncoder's under the same patch, and decode."""
    monkeypatch.setattr(E, "_res_width_classes", lambda bps: (6,))
    monkeypatch.setattr(jax_encoder, "_res_width_classes", lambda bps: (6,))
    tracks = _corpus()
    ours, enc, theirs, widths = _encode_both(tracks, devices=devices)
    assert ours == theirs
    assert set(enc.batch_widths) == set(widths) == {6}
    # 11 full blocks, all live, 10 of them wider than 6 bits; over two
    # entries each batch of two rows puts one row on each shard
    assert enc.overflow_rows == 10
    for data, t in zip(ours, tracks):
        assert np.array_equal(np.stack(Decoder().decode_whole(data)), t)


def _wide_stream():
    """A 24-bit stream whose residual rows exceed int16: a tone under
    loud noise, compressed (not raw) blocks, and a tail."""
    rng = np.random.default_rng(8)
    n = 4 * SPB + 500
    t = np.arange(n)
    tone = 3e6 * np.sin(2 * np.pi * 330 * t / 44100)
    sig = np.round(np.stack([tone, 0.5 * tone])
                   + rng.normal(0, 1 << 14, (2, n))).astype(np.int32)
    enc = TorchEncoder(batch_blocks=4, device="cpu")
    enc.set_encode_parameter(_param(24))
    return sig, enc.encode_whole([sig[0], sig[1]], n)


@pytest.mark.parametrize("width,chunk,devices", [
    (None, None, ["cpu"]),      # int16 upload with int32 patches
    (6, None, ["cpu"]),         # every row flagged and fetched again
    (None, 2, ["cpu"]),         # chunked download
    (6, 1, ["cpu", "cpu"]),     # all of it, a flagged row on each shard
])
def test_decoder_slim_transfers(monkeypatch, width, chunk, devices):
    sig, data = _wide_stream()
    if width is not None:
        monkeypatch.setattr(TD, "_download_width", lambda bps: width)
    if chunk is not None:
        monkeypatch.setattr(TD, "_DL_CHUNK_ROWS", chunk)
    dec = TD.TorchDecoder(devices=devices)
    out = dec.decode_many([data, data])
    host = JaxDecoder().decode_whole(data)
    for o in out:
        assert np.array_equal(np.stack(o), sig)
        assert np.array_equal(np.stack(o), np.stack(host))
    rows = 2 * 2 * 4 + 2 * 2  # both copies: 4 full blocks and a tail each
    # every row exceeds int16 and goes up at int32 as well
    assert dec.bytes_up == (2 * 2 * (4 * SPB + 500) * 2
                            + 2 * 2 * (4 * SPB + 500) * 4 + rows * 8)
    assert dec.flagged_rows == (rows if width else 0)
    # two block lengths, the rows split over the shards
    want_chunks = sum(-(-r // chunk) if chunk and r > 2 * chunk else 1
                      for r in _shard_rows(devices))
    assert dec.download_chunks == want_chunks


def _shard_rows(devices):
    """Rows per (block length, shard): 8 full blocks and 2 tails, 2
    channels each, split into contiguous shards of whole blocks."""
    out = []
    for blocks in (8, 2):
        q, r = divmod(blocks, len(devices))
        out += [2 * (q + (i < r)) for i in range(len(devices))
                if q + (i < r)]
    return out


def test_decoder_pools_by_sample_width():
    """A 16-bit and a 24-bit stream in one decode_many: each pool comes
    down at its own width (bps + 2), so no row of either is flagged."""
    sig24, data24 = _wide_stream()
    sig16 = WAVEFORMS["gauss"](3 * SPB + 100, 2, 16, seed=6)
    enc = TorchEncoder(batch_blocks=4, device="cpu")
    enc.set_encode_parameter(_param(16))
    data16 = enc.encode_whole([sig16[0], sig16[1]], sig16.shape[1])
    dec = TD.TorchDecoder(device="cpu")
    out16, out24 = dec.decode_many([data16, data24])
    assert np.array_equal(np.stack(out16), sig16)
    assert np.array_equal(np.stack(out24), sig24)
    assert dec.flagged_rows == 0
