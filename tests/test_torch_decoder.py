"""The port's pooled decoder (TorchDecoder on the CPU) against the host
Decoder and the JAX reference's TpuDecoder, and the port's CLI.

Decoding is integer arithmetic end to end, so every comparison is
sample-exact.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import REPO_ROOT, WAVEFORMS
from linne_tpu.codec.decoder import Decoder as JaxDecoder
from linne_tpu.codec.tpu_decoder import TpuDecoder
from linne_tpu_torch.codec.decoder import Decoder
from linne_tpu_torch.codec.encoder import TorchEncoder
from linne_tpu_torch.codec.params import EncodeParameter
from linne_tpu_torch.constants import BLOCK_TYPE_COMPRESS, BLOCK_TYPE_RAW, BLOCK_TYPE_SILENT, HEADER_SIZE
from linne_tpu_torch.format.block import parse_block_header
from linne_tpu_torch.io.wav import read_wav, write_wav
from linne_tpu_torch.codec.torch_decoder import TorchDecoder
from linne_tpu_torch.ops import synthesis as S

SPB = 2048


def _encode(sig, preset, bps=16):
    ch, n = sig.shape
    enc = TorchEncoder(batch_blocks=4, device="cpu")
    enc.set_encode_parameter(EncodeParameter(
        num_channels=ch, bits_per_sample=bps, sampling_rate=44100,
        num_samples_per_block=SPB, preset=preset,
        ch_process_method=1 if ch >= 2 else 0))
    return enc.encode_whole([sig[c] for c in range(ch)], n)


def _block_types(data):
    types = []
    off = HEADER_SIZE
    while off < len(data):
        bh = parse_block_header(data[off:])
        types.append(bh.block_type)
        off += bh.total_size
    return types


@pytest.fixture(scope="module")
def corpus():
    """Three streams of one preset: silent, raw and compress blocks, tails
    of two lengths."""
    rng = np.random.default_rng(21)
    a = WAVEFORMS["sine"](3 * SPB + 500, 2, 16)
    a[:, SPB : 2 * SPB] = 0                                  # silent block
    a[:, 2 * SPB : 3 * SPB] = rng.integers(                 # raw block
        -32768, 32768, (2, SPB))
    b = WAVEFORMS["gauss"](2 * SPB + 900, 2, 16)
    c = WAVEFORMS["chirp"](2 * SPB, 2, 16)
    sigs = [a, b, c]
    datas = [_encode(s, 5) for s in sigs]
    kinds = set(t for d in datas for t in _block_types(d))
    assert kinds == {BLOCK_TYPE_COMPRESS, BLOCK_TYPE_RAW, BLOCK_TYPE_SILENT}
    return sigs, datas


def test_decode_many_equals_decoder_and_tpu_decoder(corpus):
    sigs, datas = corpus
    before = S.KERNEL_LAUNCHES
    ours = TorchDecoder(device="cpu").decode_many(datas)
    assert S.KERNEL_LAUNCHES == before  # CPU rows take the plain version
    theirs = TpuDecoder().decode_many(datas)
    for sig, data, o, t in zip(sigs, datas, ours, theirs):
        host = JaxDecoder().decode_whole(data)
        for ch in range(sig.shape[0]):
            assert np.array_equal(o[ch], sig[ch])
            assert np.array_equal(o[ch], host[ch])
            assert np.array_equal(o[ch], np.asarray(t[ch]))


def test_decode_whole_mono_preset7():
    sig = WAVEFORMS["gauss"](2 * SPB + 555, 1, 16)
    out = TorchDecoder(device="cpu").decode_whole(_encode(sig, 7))
    assert np.array_equal(out[0], sig[0])


@pytest.mark.parametrize("wf,n,ch,bps,preset", [
    ("noise", SPB + 300, 2, 16, 0),
    ("nyquist", SPB, 2, 16, 3),
    ("const", SPB + 10, 2, 16, 7),
    ("silence", SPB + 200, 2, 16, 0),
    ("chirp", 2 * SPB + 50, 1, 24, 7),   # 24 bit: int32 upload
    ("flipsine", SPB + 64, 8, 16, 4),    # eight channels
    ("gauss", SPB + 5, 2, 8, 0),         # 8 bit; 5-sample tail: raw frame
])
def test_waveform_roundtrip(wf, n, ch, bps, preset):
    """Port encode + port decode across the waveform matrix: lossless, and
    equal to the host Decoder."""
    sig = WAVEFORMS[wf](n, ch, bps)
    data = _encode(sig, preset, bps)
    out = TorchDecoder(device="cpu").decode_whole(data)
    host = JaxDecoder().decode_whole(data)
    for c in range(ch):
        assert np.array_equal(out[c], sig[c])
        assert np.array_equal(host[c], sig[c])


def _cli(*args):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "PYTHONSTARTUP")}
    env["PYTHONPATH"] = str(REPO_ROOT)
    env["OMP_NUM_THREADS"] = "1"  # the test workers share the cores
    return subprocess.run(
        [sys.executable, "-m", "linne_tpu_torch.cli", *args],
        capture_output=True, text=True, env=env, cwd=str(REPO_ROOT))


@pytest.mark.parametrize("encoder", [["--device", "cpu"], ["--exact"]])
def test_cli_encode_decode_roundtrip(tmp_path, encoder):
    sig = WAVEFORMS["sine"](SPB * 5 + 77, 2, 16)
    wav = tmp_path / "in.wav"
    write_wav(str(wav), sig, 44100, 16)
    lnn = tmp_path / "out.lnn"
    r = _cli("-e", "-m", "4", *encoder, str(wav), str(lnn))
    assert r.returncode == 0, r.stderr
    assert np.array_equal(np.stack(Decoder().decode_whole(lnn.read_bytes())),
                          sig)
    back = tmp_path / "back.wav"
    r = _cli("-d", str(lnn), str(back))
    assert r.returncode == 0, r.stderr
    assert np.array_equal(read_wav(str(back))[1], sig)


@pytest.mark.parametrize("flags", [["-l"], ["-a", "2"], ["-l", "-a", "1"]])
def test_cli_learning_and_af_flags_round_trip(tmp_path, flags):
    """-l and -a, which the batched encoder once refused with exit 2, now
    encode through it (one full block, then a host-encoded tail) and
    round-trip losslessly. Noise: its training stops within ~110
    iterations, where a pure tone trains to the 2000-iteration cap."""
    sig = WAVEFORMS["gauss"](10240 + 1000, 1, 16)
    wav = tmp_path / "in.wav"
    write_wav(str(wav), sig, 44100, 16)
    lnn = tmp_path / "o.lnn"
    r = _cli("-e", "--device", "cpu", *flags, str(wav), str(lnn))
    assert r.returncode == 0, r.stderr
    assert np.array_equal(np.stack(Decoder().decode_whole(lnn.read_bytes())),
                          sig)
