"""The port's batched encoder (TorchEncoder on the CPU) against the JAX
reference's TpuEncoder: byte-identical streams.

Both analyze in float64 on the CPU, so equal bytes are the expected
outcome, not a tolerance: a differing quantized coefficient, unit count or
Rice parameter changes the stream.
"""

import numpy as np
import pytest

from linne_tpu.codec.decoder import Decoder
from linne_tpu.codec.encoder import TpuEncoder
from linne_tpu.codec.params import EncodeParameter
from linne_tpu.constants import CH_PROCESS_MS
from linne_tpu_torch.codec.encoder import TorchEncoder

# (preset, block size): presets 0, 4 and 7 cover all three layer structures
_CASES = [(0, 2048), (4, 2560), (7, 2560)]


def _signal(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    left = (9000 * np.sin(2 * np.pi * 220 * t / 44100)
            + 3000 * np.sin(2 * np.pi * 1234 * t / 44100)
            + rng.normal(0, 200, n))
    right = 0.8 * left + rng.normal(0, 300, n)
    sig = np.clip(np.round(np.stack([left, right])), -32768, 32767)
    sig = sig.astype(np.int32)
    sig[:, 2 * 2048 : 2 * 2048 + 300] = 0  # a quiet stretch
    return sig


def _param(preset, spb):
    return EncodeParameter(
        num_channels=2, bits_per_sample=16, sampling_rate=44100,
        num_samples_per_block=spb, preset=preset,
        ch_process_method=CH_PROCESS_MS)


@pytest.fixture(scope="module")
def jax_streams():
    """TpuEncoder bytes per (preset, tail_mode). One encoder per preset:
    the device-tail encode builds both block lengths, and the host-tail
    encode then reuses the full-block build."""
    out = {}
    for preset, spb in _CASES:
        n = 3 * spb + 700
        sig = _signal(n, preset)
        enc = TpuEncoder(batch_blocks=4, tail_mode="device")
        enc.set_encode_parameter(_param(preset, spb))
        for mode in ("device", "host"):
            enc.tail_mode = mode
            out[(preset, mode)] = enc.encode_whole([sig[0], sig[1]], n)
    return out


@pytest.mark.parametrize("tail_mode", ["device", "host"])
@pytest.mark.parametrize("preset,spb", _CASES)
def test_bytes_equal_tpu_encoder(jax_streams, preset, spb, tail_mode):
    n = 3 * spb + 700
    sig = _signal(n, preset)
    enc = TorchEncoder(batch_blocks=4, tail_mode=tail_mode, device="cpu")
    enc.set_encode_parameter(_param(preset, spb))
    data = enc.encode_whole([sig[0], sig[1]], n)
    assert data == jax_streams[(preset, tail_mode)]
    out = Decoder().decode_whole(data)
    assert np.array_equal(np.stack(out), sig)


def test_encode_many_equals_encode_whole():
    """Cross-track batching, tails grouped by length, a short track with no
    full block: encode_many bytes equal per-track encode_whole bytes."""
    spb = 2048
    lengths = [3 * spb + 100, spb + 100, 700, 2 * spb]
    tracks = [_signal(n, 10 + i) for i, n in enumerate(lengths)]
    enc = TorchEncoder(batch_blocks=2, device="cpu")
    enc.set_encode_parameter(_param(4, spb))
    many = enc.encode_many([[t[0], t[1]] for t in tracks], lengths)
    for t, n, data in zip(tracks, lengths, many):
        solo = TorchEncoder(batch_blocks=2, device="cpu")
        solo.set_encode_parameter(_param(4, spb))
        assert data == solo.encode_whole([t[0], t[1]], n)
        assert np.array_equal(np.stack(Decoder().decode_whole(data)), t)


def test_encode_block_matches_encode_whole():
    spb = 2048
    n = 2 * spb + 333
    sig = _signal(n, 3)
    enc = TorchEncoder(device="cpu")
    enc.set_encode_parameter(_param(0, spb))
    whole = enc.encode_whole([sig[0], sig[1]], n)
    from linne_tpu.format.header import LinneHeader

    out = bytearray(LinneHeader(
        num_channels=2, num_samples=n, sampling_rate=44100,
        bits_per_sample=16, num_samples_per_block=spb, preset=0,
        ch_process_method=CH_PROCESS_MS).pack())
    for pos in range(0, n, spb):
        take = min(spb, n - pos)
        out += enc.encode_block([sig[0][pos : pos + take],
                                 sig[1][pos : pos + take]], take)
    assert bytes(out) == whole


def test_learning_and_af_are_not_ported():
    enc = TorchEncoder(device="cpu")
    for kw in ({"enable_learning": True}, {"num_afmethod_iterations": 2}):
        p = _param(0, 2048)
        for k, v in kw.items():
            setattr(p, k, v)
        with pytest.raises(NotImplementedError):
            enc.set_encode_parameter(p)
