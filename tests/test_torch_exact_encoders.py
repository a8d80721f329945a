"""The port's byte-exact encoders on the CPU: DeviceExactEncoder
(linne_tpu_torch/exact/device_encoder.py, the fit batched on a torch
device, here the CPU) and ParallelExactEncoder (host threads) against the
port's ExactEncoder, which tests/test_torch_host.py holds byte-equal to the
JAX package's; and the port's CLI against the JAX CLI.

Every comparison is of whole streams, byte for byte. Blocks of 2048
samples keep the oracle fast; each signal ends in a tail block, which both
encoders fit on the host.
"""

import numpy as np
import pytest
import torch

from linne_tpu_torch import cli
from linne_tpu_torch.codec.decoder import Decoder
from linne_tpu_torch.codec.params import EncodeParameter
from linne_tpu_torch.exact import device_encoder as de
from linne_tpu_torch.exact.encoder import ExactEncoder
from linne_tpu_torch.exact.parallel_encoder import ParallelExactEncoder
from linne_tpu_torch.io.wav import write_wav

N = 2048


def _signal(n, seed):
    """Two channels of tone plus noise, each with its own level."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    rows = [np.round(rng.uniform(1500, 24000)
                     * np.sin(2 * np.pi * rng.uniform(60, 6000) * t / 44100)
                     + rng.normal(0, rng.uniform(15, 2500), n))
            for _ in range(2)]
    return np.clip(np.stack(rows), -32768, 32767).astype(np.int32)


def _param(preset, af=0, learn=False):
    return EncodeParameter(
        num_channels=2, bits_per_sample=16, sampling_rate=44100,
        preset=preset, ch_process_method=1, num_samples_per_block=N,
        num_afmethod_iterations=af, enable_learning=learn)


def _encode(enc, param, sig):
    enc.set_encode_parameter(param)
    return enc.encode_whole([sig[0], sig[1]], sig.shape[1])


def _oracle(param, sig):
    return _encode(ExactEncoder(), param, sig)


@pytest.fixture
def small_chunk(monkeypatch):
    """Four fit rows per batch, so that a few blocks span several batches
    and a ragged last one."""
    monkeypatch.setattr(de, "_CHUNK", 4)


def test_device_encoder_byte_identical(small_chunk):
    """Preset 0: two full blocks (device fit), a quiet stretch that keeps
    the block-type decision honest, and a tail (host fit)."""
    sig = _signal(N * 2 + 777, seed=31)
    sig[:, N : N + 400] = 0
    param = _param(0)
    enc = de.DeviceExactEncoder(device="cpu")
    got = _encode(enc, param, sig)
    assert got == _oracle(param, sig)
    assert enc.guard_rows_total == 4 and enc.guard_rows_flagged == 0
    out = Decoder().decode_whole(got)
    assert all(np.array_equal(out[c], sig[c]) for c in range(2))


@pytest.mark.parametrize("af,learn", [(1, False), (2, False), (0, True),
                                      (2, True)])
def test_device_encoder_af_and_learning_byte_identical(small_chunk, af,
                                                       learn):
    """Preset 1 (two ridge terms) with -a N (device searches and forwards
    around the host IRLS refit) and -l (host trainer seeded by the device
    fit), alone and together."""
    sig = _signal(N * 3 + 777, seed=41 + af + 10 * learn)
    param = _param(1, af, learn)
    got = _encode(de.DeviceExactEncoder(device="cpu"), param, sig)
    assert got == _oracle(param, sig)


@pytest.mark.parametrize("preset,af", [(0, 0), (1, 2)])
def test_device_encoder_encode_many_matches_whole(small_chunk, preset, af):
    """Corpus fits pooled across tracks emit each track's encode_whole
    bytes, and so the oracle's."""
    lens = [N * 2 + 501, N, N + 99]
    tracks = [_signal(ns, seed=100 + i) for i, ns in enumerate(lens)]
    param = _param(preset, af)
    enc = de.DeviceExactEncoder(device="cpu")
    enc.set_encode_parameter(param)
    many = enc.encode_many([[s[0], s[1]] for s in tracks], lens)
    assert enc.guard_rows_total == 8  # 4 full blocks x 2 channels
    for i, sig in enumerate(tracks):
        solo = _encode(de.DeviceExactEncoder(device="cpu"), param, sig)
        assert many[i] == solo == _oracle(param, sig), f"track {i}"


def test_device_encoder_instance_reuse_reprefits():
    """A second encode_whole on one instance fits the new signal."""
    param = _param(0)
    s1, s2 = _signal(N * 2, seed=301), _signal(N * 2 + 99, seed=302)
    enc = de.DeviceExactEncoder(device="cpu")
    _encode(enc, param, s1)
    assert _encode(enc, param, s2) == _oracle(param, s2)


def test_guard_flagged_rows_fall_back_to_oracle(monkeypatch):
    """With the guard bounds forced huge every fit row is flagged and takes
    the host oracle: bytes unchanged, flags counted."""
    sig = _signal(N * 2 + 321, seed=71)
    param = _param(0)
    ref = _oracle(param, sig)
    monkeypatch.setattr(de, "_MARGIN_REL", 1e9)
    monkeypatch.setattr(de, "_MARGIN_ABS", 1e9)
    enc = de.DeviceExactEncoder(device="cpu")
    assert _encode(enc, param, sig) == ref
    assert enc.guard_rows_total == 4
    assert enc.guard_rows_flagged == 4


def test_guard_decision_margin_refresh(monkeypatch):
    """With the decision bound forced huge (rows never flagged), each
    block-type decision after a device block re-fits the previous block
    on the host oracle first: bytes unchanged."""
    sig = _signal(N * 3, seed=72)
    param = _param(1)
    ref = _oracle(param, sig)
    monkeypatch.setattr(de, "_MARGIN_REL", 1e9)
    monkeypatch.setattr(de.DeviceExactEncoder, "_row_flagged",
                        lambda self, row: False)
    enc = de.DeviceExactEncoder(device="cpu")
    assert _encode(enc, param, sig) == ref
    assert enc.guard_decisions_flagged >= 1
    assert enc.guard_rows_flagged == 0


def test_guard_af_margins(monkeypatch):
    """-a N: rows flagged by the host-quantize margins take the oracle,
    bytes unchanged."""
    sig = _signal(N * 2, seed=73)
    param = _param(0, af=2)
    ref = _oracle(param, sig)
    monkeypatch.setattr(de, "_MARGIN_ABS", 1e9)
    enc = de.DeviceExactEncoder(device="cpu")
    assert _encode(enc, param, sig) == ref
    assert enc.guard_rows_flagged == enc.guard_rows_total == 4


def test_device_encoder_refuses_missing_card(monkeypatch):
    """device="cuda" without a card raises; nothing falls back to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        de.DeviceExactEncoder()


@pytest.mark.parametrize("af,learn", [(0, False), (1, True)])
def test_parallel_encoder_byte_identical(af, learn):
    sig = _signal(N * 3 + 555, seed=91 + af)
    param = _param(1, af, learn)
    got = _encode(ParallelExactEncoder(num_threads=3), param, sig)
    assert got == _oracle(param, sig)


def test_parallel_encoder_encode_many():
    lens = [N * 2 + 11, N + 700]
    tracks = [_signal(ns, seed=400 + i) for i, ns in enumerate(lens)]
    param = _param(0)
    enc = ParallelExactEncoder(num_threads=2)
    enc.set_encode_parameter(param)
    many = enc.encode_many([[s[0], s[1]] for s in tracks], lens)
    assert many == [_oracle(param, s) for s in tracks]


# -- the CLI ------------------------------------------------------------------


@pytest.fixture(scope="module")
def wav_in(tmp_path_factory):
    """One full 10240-sample block (the CLI's block) and a tail."""
    path = tmp_path_factory.mktemp("cli") / "in.wav"
    write_wav(str(path), _signal(10240 + 501, seed=93), 44100, 16)
    return str(path)


@pytest.mark.parametrize("flags", [
    ["--exact", "-m", "1", "-a", "1", "-l"],
    ["--exact", "--threads", "2"],
    ["--exact", "--threads", "2", "-m", "1", "-a", "1"],
])
def test_cli_exact_bytes_equal_jax_cli(tmp_path, wav_in, flags):
    """-a and -l on the byte-exact paths encode (exit 0) and give the JAX
    CLI's bytes."""
    from linne_tpu import cli as jax_cli

    ours, theirs = tmp_path / "ours.lnn", tmp_path / "theirs.lnn"
    assert cli.main(["-e", *flags, wav_in, str(ours)]) == 0
    assert jax_cli.main(["-e", *flags, wav_in, str(theirs)]) == 0
    assert ours.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("flags", [[], ["-m", "1", "-a", "2"], ["-l"]])
def test_cli_exact_device_equals_exact(tmp_path, wav_in, small_chunk, flags):
    """--exact-device --device cpu gives --exact's bytes."""
    a, b = tmp_path / "a.lnn", tmp_path / "b.lnn"
    assert cli.main(["-e", "--exact", *flags, wav_in, str(a)]) == 0
    assert cli.main(["-e", "--exact-device", "--device", "cpu", *flags,
                     wav_in, str(b)]) == 0
    assert a.read_bytes() == b.read_bytes()


def test_cli_refusals(tmp_path, wav_in):
    """--threads needs --exact and a count >= 1 (exit 1, no file)."""
    out = tmp_path / "x.lnn"
    assert cli.main(["-e", "--exact-device", "--threads", "2", wav_in,
                     str(out)]) == 1
    assert cli.main(["-e", "--exact", "--threads", "0", wav_in,
                     str(out)]) == 1
    assert not out.exists()
