"""Randomized cross-composition property of TorchEncoder.encode_many: the
counterpart of tests/test_property_encode_many.py for the port, on the CPU.

encode_many pools full blocks from every track into shared batches and
groups tails by length; the bytes of each track must not depend on the
batch composition: they equal a per-track encode_whole whatever tracks
ride along, whatever their lengths and however the batches split
(batch_blocks, a device list). Seeded compositions cover every tail class
(none, short, odd, a sub-block track, a tail shorter than the deepest
layer order), 8/16/24-bit samples, one to three channels, shallow and
deep presets and batch_blocks 2-8.
"""

import numpy as np
import pytest
import torch

from conftest import WAVEFORMS
from linne_tpu_torch.codec.decoder import Decoder
from linne_tpu_torch.codec.encoder import TorchEncoder
from linne_tpu_torch.codec.params import EncodeParameter
from linne_tpu_torch.constants import CH_PROCESS_MS, CH_PROCESS_NONE

SPB = 2560
_WF_NAMES = ["sine", "noise", "gauss", "chirp", "silence", "const"]
# tail classes: multiple of the block, even short tail, odd tail,
# sub-block track, tail shorter than the deepest layer order
_TAIL_CLASSES = [0, 700, 777, -SPB + 901, 40]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the encoder's stages run many small ops,
    which slow down when several test workers oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gen(wf, ns, nch, bps, seed):
    fn = WAVEFORMS[wf]
    if wf in ("noise", "gauss"):
        return fn(ns, nch, bps, seed=seed)
    return fn(ns, nch, bps)


def _random_corpus(rng, nch, bps):
    lens = []
    tracks = []
    for _ in range(int(rng.integers(2, 5))):
        nblocks = int(rng.integers(1, 3))
        tail = _TAIL_CLASSES[int(rng.integers(len(_TAIL_CLASSES)))]
        ns = max(nblocks * SPB + tail, 40)
        wf = _WF_NAMES[int(rng.integers(len(_WF_NAMES)))]
        tracks.append(_gen(wf, ns, nch, bps, int(rng.integers(1e6))))
        lens.append(ns)
    return tracks, lens


def _param(nch, bps, preset):
    return EncodeParameter(
        num_channels=nch, bits_per_sample=bps, sampling_rate=44100,
        num_samples_per_block=SPB, preset=preset,
        ch_process_method=CH_PROCESS_MS if nch >= 2 else CH_PROCESS_NONE)


def _encoder(nch, bps, preset, **kw):
    enc = TorchEncoder(**kw)
    enc.set_encode_parameter(_param(nch, bps, preset))
    return enc


@pytest.mark.parametrize("seed", range(12))
def test_encode_many_random_compositions(seed):
    rng = np.random.default_rng(1000 + seed)
    bps = [8, 16, 24][seed % 3]
    nch = [2, 1, 3, 2][seed % 4]
    preset = [0, 5, 0, 2, 7, 1][seed % 6]
    tracks, lens = _random_corpus(rng, nch, bps)

    bb = int(2 ** rng.integers(1, 4))  # batch_blocks in {2, 4, 8}
    many = _encoder(nch, bps, preset, batch_blocks=bb,
                    device="cpu").encode_many([list(t) for t in tracks],
                                              lens)
    for i, (t, ns) in enumerate(zip(tracks, lens)):
        # bytes independent of corpus composition and batch split
        solo = _encoder(nch, bps, preset, batch_blocks=bb, device="cpu")
        assert many[i] == solo.encode_whole(list(t), ns), \
            f"seed={seed} track={i} bb={bb} preset={preset} bps={bps}"
        decoded = Decoder().decode_whole(many[i])
        for c in range(nch):
            assert np.array_equal(decoded[c], t[c])


def test_encode_many_random_composition_device_list():
    """The same invariant with the full-block batches split over a device
    list (["cpu", "cpu"]): bytes equal the one-device per-track encode at
    another batch split."""
    rng = np.random.default_rng(77)
    tracks, lens = _random_corpus(rng, 2, 16)
    many = _encoder(2, 16, 0, batch_blocks=8, devices=["cpu", "cpu"]
                    ).encode_many([list(t) for t in tracks], lens)
    for i, (t, ns) in enumerate(zip(tracks, lens)):
        solo = _encoder(2, 16, 0, batch_blocks=4, device="cpu")
        assert many[i] == solo.encode_whole(list(t), ns), f"track={i}"
