"""The port on a CUDA card: the synthesis kernel against its plain torch
version, and the encoder and decoder on the card against the CPU.

Every test skips without a card. The file imports no jax, so it also runs
on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from linne_tpu_torch.codec.decoder import Decoder
from linne_tpu_torch.codec.encoder import TorchEncoder
from linne_tpu_torch.codec.params import EncodeParameter
from linne_tpu_torch.codec.torch_decoder import TorchDecoder
from linne_tpu_torch.ops import synthesis as S

pytestmark = pytest.mark.cuda


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _synth_inputs(rows, ns, npu):
    rng = np.random.default_rng(rows * ns + npu)
    x = rng.integers(-30000, 30000, (rows, ns)).astype(np.int32)
    # coefficients up to 2^14 make the int32 accumulator wrap
    c = rng.integers(-(1 << 14), 1 << 14, (rows, npu)).astype(np.int32)
    rs = rng.integers(8, 15, rows).astype(np.int32)
    rs[::7] = 0
    return tuple(torch.from_numpy(a).cuda() for a in (x, c, rs))


# the design's edges: taps around the 32-lane chunk, rows shorter than a
# chunk, ragged last chunks; 13 rows is not a multiple of the 4 warps per
# block
_EDGES = [(13, ns, npu)
          for npu in (1, 2, 4, 16, 31, 32, 33, 64, 127, 128)
          for ns in sorted({npu + 1, 33, 777, 10240})]


@pytest.mark.parametrize("rows,ns,npu", [
    (4, 2048, 32), (130, 1024, 8), (64, 2560, 128), (8, 10240, 128),
    (33, 16, 16), (7, 300, 3), (5, 8, 128)] + _EDGES)
def test_kernel_matches_plain_version(rows, ns, npu):
    _require_card()
    x, c, rs = _synth_inputs(rows, ns, npu)
    before = S.KERNEL_LAUNCHES
    got = S.synthesize_rows(x, c, rs)
    torch.cuda.synchronize()
    assert S.KERNEL_LAUNCHES == before + 1
    assert torch.equal(got, S.synthesize_rows_ref(x, c, rs))


def test_kernel_refuses_more_taps_than_it_holds():
    _require_card()
    x, c, rs = _synth_inputs(2, 300, S.KERNEL_MAX_NPU + 1)
    before = S.KERNEL_LAUNCHES
    with pytest.raises(ValueError):
        S.synthesize_rows(x, c, rs)
    assert S.KERNEL_LAUNCHES == before


def _track(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    left = 9000 * np.sin(2 * np.pi * 330 * t / 44100) + rng.normal(0, 300, n)
    right = 0.7 * left + rng.normal(0, 200, n)
    return np.clip(np.round(np.stack([left, right])), -32768,
                   32767).astype(np.int32)


@pytest.mark.parametrize("preset", [0, 7])
def test_card_round_trip_matches_cpu(preset):
    """Card encode bytes equal the CPU port's (both analyze in float64);
    the card decode launches the kernel and equals the host Decoder."""
    _require_card()
    spb = 2048
    sigs = [_track(3 * spb + 300, preset), _track(2 * spb, preset + 1)]
    param = EncodeParameter(
        num_channels=2, bits_per_sample=16, sampling_rate=44100,
        num_samples_per_block=spb, preset=preset, ch_process_method=1)
    streams = {}
    for device in ("cpu", "cuda"):
        enc = TorchEncoder(batch_blocks=4, device=device)
        enc.set_encode_parameter(param)
        streams[device] = enc.encode_many([[s[0], s[1]] for s in sigs],
                                          [s.shape[1] for s in sigs])
    assert streams["cuda"] == streams["cpu"]
    before = S.KERNEL_LAUNCHES
    outs = TorchDecoder(device="cuda").decode_many(streams["cuda"])
    assert S.KERNEL_LAUNCHES > before
    for sig, data, out in zip(sigs, streams["cuda"], outs):
        host = Decoder().decode_whole(data)
        for ch in range(2):
            assert np.array_equal(out[ch], sig[ch])
            assert np.array_equal(host[ch], sig[ch])
