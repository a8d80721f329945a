"""The port on a CUDA card: the synthesis kernel and the byte-exact
encoder's serial float64 kernels against their plain torch versions, the
encoder and decoder on the card against the CPU, and the byte-exact device
encoder on the card against the host oracle.

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
from linne_tpu_torch.exact.device_encoder import DeviceExactEncoder
from linne_tpu_torch.exact.encoder import ExactEncoder
from linne_tpu_torch.ops import exact_serial as ES
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


# -- the byte-exact encoder's serial float64 kernels --------------------------


def _bits(t):
    return t.contiguous().view(torch.int64)


def _segments(rows, units, ns, seed):
    """Welch-windowed-scale noise plus a tone; row 0 is all zero."""
    rng = np.random.default_rng(seed)
    t = np.arange(ns)
    seg = (rng.normal(0, 0.05, (rows, units, ns))
           + 0.4 * np.sin(2 * np.pi * rng.uniform(0.01, 0.2,
                                                  (rows, units, 1)) * t))
    seg[0] = 0.0
    return torch.from_numpy(seg).cuda()


# odd and even lengths, lags 1..129, nlags == ns; 13 rows is not a multiple
# of the kernels' 128-thread blocks
@pytest.mark.parametrize("rows,units,ns,nlags", [
    (13, 1, 10240, 129), (5, 2, 81, 9), (3, 4, 64, 1), (7, 3, 130, 129),
    (2, 1, 16, 16), (13, 128, 80, 2)])
def test_autocorr_kernel_matches_plain_version(rows, units, ns, nlags):
    _require_card()
    seg = _segments(rows, units, ns, rows + ns + nlags)
    before = ES.KERNEL_LAUNCHES["autocorr_serial"]
    got = ES.autocorr_serial(seg, nlags)
    torch.cuda.synchronize()
    assert ES.KERNEL_LAUNCHES["autocorr_serial"] == before + 1
    assert torch.equal(_bits(got), _bits(ES.autocorr_serial_ref(seg, nlags)))


@pytest.mark.parametrize("order", [1, 2, 31, 32, 33, 64, 128])
def test_levinson_kernel_matches_plain_version(order):
    """Autocorrelations of seeded segments after a ridge, a zero-signal
    row (|r0| < FLT_EPSILON) and a tiny one."""
    _require_card()
    seg = _segments(13, 1, 4 * order + 16, order)
    seg[3] *= 1e-5
    ac = ES.autocorr_serial_ref(seg, order + 1)[:, 0].contiguous()
    ac[:, 0] *= 1.0 + 1.0 / 512.0
    before = ES.KERNEL_LAUNCHES["levinson_serial"]
    got = ES.levinson_serial(ac, order)
    torch.cuda.synchronize()
    assert ES.KERNEL_LAUNCHES["levinson_serial"] == before + 1
    want = ES.levinson_serial_ref(ac, order)
    assert bool(want[2][0]) and not bool(want[2][1])
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(_bits(g), _bits(w))
    assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("rows,n,start", [(13 * 8, 10240, 1), (3, 77, 0),
                                          (130, 2048, 0)])
def test_abs_mean_kernel_matches_plain_version(rows, n, start):
    _require_card()
    x = _segments(rows, 1, n, n)[:, 0].contiguous()
    before = ES.KERNEL_LAUNCHES["serial_abs_mean"]
    got = ES.serial_abs_mean(x, start, n)
    torch.cuda.synchronize()
    assert ES.KERNEL_LAUNCHES["serial_abs_mean"] == before + 1
    assert torch.equal(_bits(got), _bits(ES.serial_abs_mean_ref(x, start, n)))


@pytest.mark.parametrize("rows,n,units,npu", [
    (13, 10240, 1, 128), (5, 384, 4, 8), (3, 2048, 128, 1), (7, 300, 3, 5)])
def test_chain_predict_kernel_matches_plain_version(rows, n, units, npu):
    _require_card()
    x = _segments(rows, 1, n, n + npu)[:, 0].contiguous()
    rng = np.random.default_rng(units + npu)
    params = torch.from_numpy(rng.normal(0, 0.4, (rows, units, npu))).cuda()
    before = ES.KERNEL_LAUNCHES["chain_predict"]
    got = ES.chain_predict(x, params)
    torch.cuda.synchronize()
    assert ES.KERNEL_LAUNCHES["chain_predict"] == before + 1
    for g, w in zip(got, ES.chain_predict_ref(x, params)):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("preset", [1, 7])
def test_device_exact_encoder_on_card_matches_oracle(preset):
    """DeviceExactEncoder on the card: the host oracle's bytes, every
    serial kernel launched, no row flagged by the guard."""
    _require_card()
    spb = 2048
    sig = _track(3 * spb + 300, preset + 20)
    param = EncodeParameter(
        num_channels=2, bits_per_sample=16, sampling_rate=44100,
        num_samples_per_block=spb, preset=preset, ch_process_method=1)
    host = ExactEncoder()
    host.set_encode_parameter(param)
    ref = host.encode_whole([sig[0], sig[1]], sig.shape[1])
    before = dict(ES.KERNEL_LAUNCHES)
    enc = DeviceExactEncoder(device="cuda")
    enc.set_encode_parameter(param)
    assert enc.encode_whole([sig[0], sig[1]], sig.shape[1]) == ref
    assert all(ES.KERNEL_LAUNCHES[k] > before[k] for k in ES.KERNELS)
    assert enc.guard_rows_total == 6 and enc.guard_rows_flagged == 0


# -- -a and -l on the batched encoder ----------------------------------------


def test_af_refine_on_card_matches_cpu():
    """cuBLAS and cuSOLVER sum in another order than the CPU, and IRLS
    amplifies that (tests/test_torch_afmethod.py), hence rtol 1e-8. The
    all-zero row's singular matrix gives zeros on both."""
    from scipy.signal import lfilter

    from linne_tpu_torch.ops import afmethod

    _require_card()
    rng = np.random.default_rng(7)
    data = lfilter([1.0], [1.0, -0.5], rng.normal(0, 0.1, (9, 5000)), axis=1)
    data[2] = 0.0
    a0 = torch.from_numpy(rng.normal(0, 0.1, (9, 16)))
    data = torch.from_numpy(data)
    cpu = afmethod.af_refine(data, a0, 3)
    card = afmethod.af_refine(data.cuda(), a0.cuda(), 3).cpu()
    np.testing.assert_allclose(card.numpy(), cpu.numpy(), rtol=1e-8,
                               atol=1e-12)
    assert not card[2].any() and not cpu[2].any()


def test_train_fn_on_card_matches_cpu():
    from linne_tpu_torch.constants import (
        TRAINING_LEARNING_RATE,
        TRAINING_LOSS_EPSILON,
        TRAINING_MAX_NUM_ITERATIONS,
    )
    from linne_tpu_torch.ops import training
    from linne_tpu_torch.ops.analysis import candidate_units

    _require_card()
    orders, n = [2, 32], 1280
    units = [candidate_units(o, n) for o in orders]
    rng = np.random.default_rng(4)
    sig = rng.normal(0, 0.1, (5, 2, n))
    sig[1, 0] = 0.0
    params = [rng.normal(0, 0.1, (5, 2, o)) for o in orders]
    log2u = [rng.choice([int(np.log2(u)) for u in c], (5, 2)).astype(np.int32)
             for c in units]
    # 100x the encoder's stopping threshold: ~130 iterations, not ~1400
    train = training.make_train_fn(
        orders, units, TRAINING_MAX_NUM_ITERATIONS, TRAINING_LEARNING_RATE,
        100 * TRAINING_LOSS_EPSILON)
    out = {}
    for device in ("cpu", "cuda"):
        out[device] = train(
            torch.from_numpy(sig).to(device),
            [torch.from_numpy(p).to(device) for p in params],
            [torch.from_numpy(l).to(device) for l in log2u])
    (cpu, cpu_its), (card, card_its) = out["cpu"], out["cuda"]
    assert card_its == cpu_its
    for c, g in zip(cpu, card):
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), rtol=1e-8,
                                   atol=1e-15)


def test_af_learning_round_trip_on_card():
    """-a 2 -l on the card: lossless under both decoders (the card decode
    launches the kernel), and within 0.1 % of the CPU port's size."""
    _require_card()
    spb = 2048
    sigs = [_track(3 * spb + 300, 3), _track(2 * spb, 4)]
    param = EncodeParameter(
        num_channels=2, bits_per_sample=16, sampling_rate=44100,
        num_samples_per_block=spb, preset=1, ch_process_method=1,
        num_afmethod_iterations=2, enable_learning=True)
    streams = {}
    for device in ("cpu", "cuda"):
        enc = TorchEncoder(batch_blocks=4, device=device)
        enc.set_encode_parameter(param)
        streams[device] = enc.encode_many([[s[0], s[1]] for s in sigs],
                                          [s.shape[1] for s in sigs])
    before = S.KERNEL_LAUNCHES
    outs = TorchDecoder(device="cuda").decode_many(streams["cuda"])
    assert S.KERNEL_LAUNCHES > before
    for sig, data, ref, out in zip(sigs, streams["cuda"], streams["cpu"],
                                   outs):
        assert abs(len(data) - len(ref)) <= 0.001 * len(ref)
        assert np.array_equal(np.stack(out), sig)
        assert np.array_equal(np.stack(Decoder().decode_whole(data)), sig)
