"""The `-l` benchmark cell's plain trainer on the CPU.

`benchmark/reference/training.py` (plain PyTorch: the reference analysis's
fits, then a lag-scan forward trained by autograd) must train every row
of a block as the port's `TorchEncoder` with `enable_learning` does: the
same stop iteration a row, the same float parameters to rounding, and so
the same side information in the stream. Blocks of 2048 samples of
seeded coloured noise, whose rows stop within a few hundred iterations,
at presets 1 and 7; and the reference with its training skipped differs.
"""

import functools

import numpy as np
import pytest
import torch

from benchmark.entries import learn_encode
from benchmark.reference import stream
from benchmark.reference import training as reference
from linne_tpu_torch.codec.encoder import TorchEncoder
from linne_tpu_torch.codec.params import EncodeParameter
from linne_tpu_torch.ops import training
from linne_tpu_torch.presets import PRESETS

N = 2048


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the trainers dispatch many small ops, and the
    float sums do not depend on the machine's core count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _blocks(seed, amp):
    """[2, 2 * N] stereo coloured noise at `amp`."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (2, 2 * N + 64))
    k = np.exp(-np.arange(16) / 3.0)
    y = np.stack([np.convolve(x[c], k, "valid")[: 2 * N] for c in range(2)])
    y = y / y.std() * amp
    y[1] = 0.7 * y[0] + 0.3 * y[1]
    return np.clip(np.round(y), -32768, 32767).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _port(seed, amp, preset):
    """The port's stream of `_blocks(seed, amp)` and its trainer's output:
    (bytes, trained params per layer [2, 2, order], stops [2, 2])."""
    sig = _blocks(seed, amp)
    seen = []
    real = training.make_train_fn

    def make(*args, **kw):
        inner = real(*args, **kw)

        def train(s, params, log2u, stops=None):
            out = inner(s, params, log2u, stops)
            seen.append((out[0], stops))
            return out
        return train

    enc = TorchEncoder(batch_blocks=2, device="cpu")
    enc.set_encode_parameter(EncodeParameter(
        num_channels=2, bits_per_sample=16, sampling_rate=44100,
        num_samples_per_block=N, preset=preset, ch_process_method=1,
        enable_learning=True))
    training.make_train_fn = make
    try:
        data = enc.encode_whole([sig[0], sig[1]], sig.shape[1])
    finally:
        training.make_train_fn = real
    (params, stops), = seen
    assert enc.train_batches == 1
    assert enc.train_active_row_iterations == int(stops.sum())
    assert enc.train_row_iterations == 4 * int(stops.max())
    return data, params, stops


# (preset, amplitude, seed): rows that stop at 2 and rows that train for
# 146-438 iterations
CASES = [(1, 1400, 1), (7, 1000, 1)]


@pytest.mark.parametrize("preset,amp,seed", CASES)
def test_reference_trains_as_the_port(preset, amp, seed):
    sig = _blocks(seed, amp)
    data, params, stops = _port(seed, amp, preset)
    pr = PRESETS[preset]
    orders, ridges = list(pr.layer_num_params), list(pr.ridge_terms)
    blocks = torch.from_numpy(np.stack([sig[:, :N], sig[:, N:]]))
    fit = reference.fit(blocks, orders, ridges, 16, True)
    assert fit.btype.tolist() == [0, 0]
    want, want_stops = reference.train(
        fit.sig.reshape(4, N), [p.reshape(4, -1) for p in fit.params],
        [l2.reshape(4) for l2 in fit.log2u])
    assert want_stops.reshape(2, 2).tolist() == stops.tolist()
    assert int(stops.max()) > 100 and int(stops.min()) == 2
    for got, ref in zip(params, want):
        np.testing.assert_allclose(got.reshape(4, -1).numpy(), ref.numpy(),
                                   rtol=1e-8, atol=1e-15)
    learned = reference.analyse(blocks, orders, ridges, 16, True)
    assert learned.stops.tolist() == stops.tolist()
    parsed = stream.parse_streams([data], orders)
    sample = [(0, 0), (0, 1)]
    compared, mismatched, got_l1, want_l1 = learn_encode.compare(
        parsed, [(0, 0)], parsed.bad, {0: [data]}, sample, learned, N)
    assert (compared, mismatched) == (2, 0)
    assert got_l1 == want_l1


def test_untrained_reference_differs(monkeypatch):
    """The fits' parameters passed through: every block's side
    information differs, and its residual is larger."""
    monkeypatch.setattr(reference, "train", lambda sig, params, log2u: (
        [p.clone() for p in params],
        torch.zeros(sig.shape[0], dtype=torch.int64)))
    sig = _blocks(1, 1000)
    data, _params, _stops = _port(1, 1000, 7)
    pr = PRESETS[7]
    blocks = torch.from_numpy(np.stack([sig[:, :N], sig[:, N:]]))
    skipped = reference.analyse(blocks, list(pr.layer_num_params),
                                list(pr.ridge_terms), 16, True)
    assert not skipped.stops.any()
    parsed = stream.parse_streams([data], list(pr.layer_num_params))
    compared, mismatched, got_l1, want_l1 = learn_encode.compare(
        parsed, [(0, 0)], parsed.bad, {0: [data]}, [(0, 0), (0, 1)],
        skipped, N)
    assert (compared, mismatched) == (2, 2)
    assert got_l1 < want_l1
