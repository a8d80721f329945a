"""The port on a CUDA card: the synthesis kernel, the byte-exact
encoder's serial float64 kernels and the batched encode's serial loops
(analysis_scans, `-k scans`) against their plain torch versions, the
encoder and decoder on the card against the CPU, the byte-exact device
encoder on the card against the host oracle, the device-list split of
the encoders and the decoder against one card, and the slim transfers and
the matrix-unit analysis routes on the card against the CPU.

Where a test holds the card to the CPU port at a tight tolerance, both
take the same analysis route (`routes`): by default the card takes the
matrix-unit routes where the CPU keeps the lag/FFT routes.

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
from linne_tpu_torch.ops import analysis as A
from linne_tpu_torch.ops import analysis_scans as AS
from linne_tpu_torch.ops import exact_serial as ES
from linne_tpu_torch.ops import intops as I
from linne_tpu_torch.ops import rice_search as R
from linne_tpu_torch.ops import synthesis as S
from linne_tpu_torch.parallel.mesh import shards
from linne_tpu_torch.presets import PRESETS
from torch_levinson_model import lanes_for, levinson_schur
from torch_rice_model import edge_plane, tie_plane

pytestmark = pytest.mark.cuda


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.fixture(params=[False, True], ids=["lag-fft", "matmul"])
def routes(request, monkeypatch):
    """The analysis route both devices take: the lag/FFT routes or the
    matrix-unit routes."""
    monkeypatch.setattr(A, "_MATMUL_ROUTES_OVERRIDE", request.param)
    return request.param


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
def test_card_round_trip_matches_cpu(preset, routes):
    """Card encode bytes equal the CPU port's (both analyze in float64, on
    the same route); the card decode launches the kernel and equals the
    host Decoder."""
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


# odd and even lengths (odd rows stage with cp.async, even ones with TMA
# bulk copies), lags 1..129, nlags == ns, nlags == 1, nlags not a multiple
# of the lags a thread, rows shorter than the window a tile reaches past
# its end, and segment counts that no CTA size divides
_AC_EDGES = [(13, 1, 10240, 129), (5, 2, 81, 9), (3, 4, 64, 1),
             (7, 3, 130, 129), (2, 1, 16, 16), (13, 128, 80, 2),
             (5, 1, 6, 6), (3, 2, 10, 7), (4, 1, 50, 7), (131, 1, 80, 2),
             (131, 1, 641, 9), (3, 1, 23, 20), (2, 1, 2049, 129)]


@pytest.fixture(params=[None, 1, 2, 4], ids=["auto", "k1", "k2", "k4"])
def lags_per_thread(request, monkeypatch):
    """The autocorrelation kernel's lags a thread: its own choice, or each
    of its choices forced."""
    monkeypatch.setattr(ES, "_AUTOCORR_K_OVERRIDE", request.param)
    return request.param


def _check_autocorr(seg, nlags):
    before = ES.KERNEL_LAUNCHES["autocorr_serial"]
    shape = (seg.numel() // seg.shape[-1], seg.shape[-1], nlags)
    tally = ES.LAUNCH_SHAPES["autocorr_serial"].get(shape, 0)
    got = ES.autocorr_serial(seg, nlags)
    torch.cuda.synchronize()
    assert ES.KERNEL_LAUNCHES["autocorr_serial"] == before + 1
    assert ES.LAUNCH_SHAPES["autocorr_serial"][shape] == tally + 1
    assert torch.equal(_bits(got), _bits(ES.autocorr_serial_ref(seg, nlags)))


@pytest.mark.parametrize("rows,units,ns,nlags", _AC_EDGES)
def test_autocorr_kernel_matches_plain_version(rows, units, ns, nlags,
                                               lags_per_thread):
    _require_card()
    _check_autocorr(_segments(rows, units, ns, rows + ns + nlags), nlags)


@pytest.mark.parametrize("nlags", [9, 129])
@pytest.mark.parametrize("extra", [-1, 0, 1])
def test_autocorr_kernel_tile_edges(nlags, extra, lags_per_thread):
    """Rows one sample short of, at and one past three tiles of the ring
    (the tile of the kernel's plan for these segments)."""
    _require_card()
    tile = ES.autocorr_plan(13, 10240, nlags, lags_per_thread)["tile"]
    ns = 3 * tile + extra
    plan = ES.autocorr_plan(13, ns, nlags, lags_per_thread)
    assert plan["tile"] == tile and plan["stages"] == 2
    _check_autocorr(_segments(13, 1, ns, ns + nlags), nlags)


def _preset7_calls():
    """(units, ns, nlags) of every autocorr_serial call of a preset-7 fit
    (layers 4, 128, 16; block 10240)."""
    calls = []
    for order in (4, 128, 16):
        u = 1
        while u <= order:
            calls.append((u, 10240 // u, order // u + 1))
            u *= 2
    return calls


@pytest.mark.parametrize("units,ns,nlags", _preset7_calls())
def test_autocorr_kernel_preset7_calls(units, ns, nlags):
    """Every call shape of a preset-7 fit chunk, at 13 rows of 4 ridge
    terms."""
    _require_card()
    _check_autocorr(_segments(13 * 4, units, ns, units), nlags)


@pytest.mark.parametrize("ns,nlags", [(80, 2), (641, 9), (2048, 129)])
def test_autocorr_kernel_special_values(ns, nlags, lags_per_thread):
    """NaN, +-Inf, -0.0 and subnormal samples: NaN products (the shield's
    rerun), 0 * Inf, Inf - Inf sums, signed zeros, subnormal products."""
    _require_card()
    seg = _segments(6, 2, ns, ns + nlags)
    seg[1, 0, 3] = float("nan")
    seg[1, 1, ns // 2] = float("inf")
    seg[2, 0, ::2] = float("inf")
    seg[2, 0, 1::2] = 0.0
    seg[2, 1, ::5] = -float("inf")
    seg[3, 0] = -0.0
    seg[3, 1, 1::3] = -0.0
    seg[4] *= 2.0 ** -1030
    seg[5, 0] *= 2.0 ** -530
    _check_autocorr(seg, nlags)


def test_autocorr_kernel_unaligned_rows(lags_per_thread):
    """Rows that start 8 bytes past a 16-byte boundary stage with
    cp.async."""
    _require_card()
    seg = _segments(9, 1, 1000, 3)
    flat = torch.empty(seg.numel() + 1, dtype=seg.dtype, device="cuda")
    shifted = flat[1:].view(seg.shape)
    shifted.copy_(seg)
    assert shifted.data_ptr() % 16 == 8
    _check_autocorr(shifted, 65)


def test_dadd_probe_measures_a_latency():
    _require_card()
    cycles = ES.dadd_cycles()
    assert 2.0 < cycles < 64.0


def _check_levinson(ac, order):
    """One launch, bit-equal to the plain version; returns the zero-case
    flags."""
    before = ES.KERNEL_LAUNCHES["levinson_serial"]
    got = ES.levinson_serial(ac, order)
    torch.cuda.synchronize()
    assert ES.KERNEL_LAUNCHES["levinson_serial"] == before + 1
    want = ES.levinson_serial_ref(ac, order)
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(_bits(g), _bits(w))
    assert torch.equal(got[2], want[2])
    return want[2]


def _levinson_rows(nseg, order, seed):
    """Autocorrelations of seeded segments after a ridge; row 0 is a
    zero-signal row (|r0| < FLT_EPSILON), row 3 a tiny one."""
    seg = _segments(nseg, 1, 4 * order + 16, seed)
    seg[3 % nseg] *= 1e-5
    ac = ES.autocorr_serial_ref(seg, order + 1)[:, 0].contiguous()
    ac[:, 0] *= 1.0 + 1.0 / 512.0
    return ac


@pytest.mark.parametrize("order", range(1, 129))
def test_levinson_kernel_matches_plain_version(order):
    """Every order the format has, on 13 segments: the thread path up to
    order 32 (each template), the warp path above, as the plan picks."""
    _require_card()
    plan = ES.levinson_plan(13, order)
    assert plan["warp"] == (order > 32)
    zc = _check_levinson(_levinson_rows(13, order, order), order)
    assert bool(zc[0]) and not bool(zc[1])


def _preset7_levinson_calls():
    """(units, order) of every levinson_serial call of a preset-7 fit."""
    return [(u, order // u) for order in (4, 128, 16)
            for u in (1, 2, 4, 8, 16, 32, 64, 128) if u <= order]


@pytest.mark.parametrize("units,order", _preset7_levinson_calls())
def test_levinson_kernel_preset7_calls(units, order):
    """Every call shape of a preset-7 fit chunk, at 5 rows of units
    segments each."""
    _require_card()
    _check_levinson(_levinson_rows(5 * units, order, units), order)


@pytest.mark.parametrize("order", [2, 8, 31, 33, 128])
def test_levinson_kernel_special_rows(order):
    """A constant signal (ek exactly 0 after the first step, then 0 / -0),
    a pure tone (ek near 0), NaN and +-Inf lags, r0 = +-Inf, a zero row."""
    _require_card()
    ac = _levinson_rows(8, order, 7 * order)
    lags = torch.arange(order + 1, dtype=torch.float64, device="cuda")
    ac[1] = 1.0
    ac[2] = torch.cos(0.3 * lags)
    ac[3, min(order, 3)] = float("nan")
    ac[4, 1] = float("inf")
    ac[5, order] = -float("inf")
    ac[6, 0] = float("inf")
    ac[7] = 0.0
    zc = _check_levinson(ac, order)
    assert bool(zc[0]) and bool(zc[7]) and not bool(zc[1])


def _check_abs_mean(x, start, n):
    before = ES.KERNEL_LAUNCHES["serial_abs_mean"]
    got = ES.serial_abs_mean(x, start, n)
    torch.cuda.synchronize()
    assert ES.KERNEL_LAUNCHES["serial_abs_mean"] == before + 1
    assert torch.equal(_bits(got), _bits(ES.serial_abs_mean_ref(x, start, n)))


@pytest.mark.parametrize("rows,n,start", [
    (13 * 8, 10240, 1), (3, 77, 0), (130, 2048, 0), (13, 77, 1), (5, 1, 0),
    (5, 1, 1), (7, 2, 1), (7, 3, 1), (4, 16, 16)])
def test_abs_mean_kernel_matches_plain_version(rows, n, start):
    """Odd and even lengths (neighbouring rows of odd length start on and
    off a 16-byte boundary), n = 1, start == n, a single sample."""
    _require_card()
    _check_abs_mean(_segments(rows, 1, n, n)[:, 0].contiguous(), start, n)


@pytest.mark.parametrize("lead,start", [((3, 3), 1), ((3, 8), 1),
                                        ((3, 5), 1), ((3,), 0)])
def test_abs_mean_kernel_preset7_calls(lead, start):
    """The four call shapes of a preset-7 fit chunk ([B, L, 10240] for L =
    3, 8, 5 unit levels from start 1, then [B, 10240] from 0) at 3 rows."""
    _require_card()
    x = _segments(int(np.prod(lead)), 1, 10240, len(lead) + start)
    _check_abs_mean(x.reshape(lead + (10240,)), start, 10240)


@pytest.mark.parametrize("per_cta", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("start", [0, 1])
def test_abs_mean_kernel_plans(per_cta, start):
    """Each rows-a-CTA bucket of the plan, with rows of several tiles."""
    _require_card()
    sms = ES.abs_mean_plan(1, start, 3001)["sms"]
    nrows = per_cta * sms
    plan = ES.abs_mean_plan(nrows, start, 3001)
    assert plan["rows_per_cta"] == per_cta and plan["tiles"] > 1
    x = _segments(nrows, 1, 3003, per_cta)[:, 0].contiguous()
    _check_abs_mean(x, start, 3001)  # n < row_len, odd


@pytest.mark.parametrize("extra", [-2, -1, 0, 1, 2])
@pytest.mark.parametrize("start", [0, 1])
def test_abs_mean_kernel_tile_edges(extra, start):
    """Rows whose span from the aligned element at or below start ends
    around three tiles of the ring, on and off a 16-byte boundary."""
    _require_card()
    tile = ES.abs_mean_plan(13, start, 10240)["tile"]
    n = 3 * tile + start + extra
    plan = ES.abs_mean_plan(13, start, n)
    assert plan["tile"] == tile and plan["stages"] == 2
    _check_abs_mean(_segments(13, 1, n, n)[:, 0].contiguous(), start, n)


@pytest.mark.parametrize("n", [77, 2500])
def test_abs_mean_kernel_special_values(n):
    """NaN, +-Inf, -0.0 and subnormal samples, in the first, the middle
    and the last tile."""
    _require_card()
    x = _segments(6, 1, n, n)[:, 0].contiguous()
    x[0, 1] = float("nan")
    x[1, n // 2] = float("inf")
    x[1, n - 1] = -float("inf")
    x[2, ::3] = -0.0
    x[3] = -0.0
    x[4] *= 2.0 ** -1060
    x[5, n - 1] = float("nan")
    for start in (0, 1):
        _check_abs_mean(x, start, n)


@pytest.mark.parametrize("row_len,n,start", [(1000, 1000, 1), (999, 999, 0),
                                             (2600, 2599, 1)])
def test_abs_mean_kernel_unaligned_rows(row_len, n, start):
    """Rows that start 8 bytes past a 16-byte boundary (a view at offset
    1): the head and tail samples the lanes read themselves."""
    _require_card()
    x = _segments(9, 1, row_len, row_len)[:, 0].contiguous()
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 == 8
    _check_abs_mean(shifted, start, n)


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
    tallied = {k: sum(v.values()) for k, v in ES.LAUNCH_SHAPES.items()}
    enc = DeviceExactEncoder(device="cuda")
    enc.set_encode_parameter(param)
    assert enc.encode_whole([sig[0], sig[1]], sig.shape[1]) == ref
    assert all(ES.KERNEL_LAUNCHES[k] > before[k] for k in ES.KERNELS)
    # every launch is tallied under its shape
    assert all(sum(ES.LAUNCH_SHAPES[k].values()) - tallied[k]
               == ES.KERNEL_LAUNCHES[k] - before[k] for k in ES.KERNELS)
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


def test_train_fn_on_card_matches_cpu(routes):
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


def test_learning_folder_repeats_its_bytes_on_card():
    """-l at preset 7 on the card: a folder of 4 short tracks encoded twice
    by one encoder, and once by a fresh one, gives the same bytes, which
    decode bit for bit; the trainer's counters advance and its span
    `encode.train` is in a profiler trace."""
    _require_card()
    from torch.profiler import ProfilerActivity, profile

    from linne_tpu_torch.utils.profiling import SPAN_PREFIX, record_spans

    spb = 10240
    sigs = []
    for i, n in enumerate((2 * spb + 700, 3 * spb, spb + 4000, 2 * spb)):
        rng = np.random.default_rng(40 + i)
        x = rng.normal(0, 1, (2, n + 15))
        y = np.stack([np.convolve(x[c], np.exp(-np.arange(16) / 3.0),
                                  "valid") for c in range(2)])
        y = y / y.std() * 800
        y[1] = 0.7 * y[0] + 0.3 * y[1]
        sigs.append(np.clip(np.round(y), -32768, 32767).astype(np.int32))
    param = EncodeParameter(
        num_channels=2, bits_per_sample=16, sampling_rate=44100,
        num_samples_per_block=spb, preset=7, ch_process_method=1,
        enable_learning=True)
    args = ([[s[0], s[1]] for s in sigs], [s.shape[1] for s in sigs])
    names = ("train_batches", "train_iterations", "train_row_iterations",
             "train_active_row_iterations", "train_s")
    enc = TorchEncoder(batch_blocks=4, device="cuda")
    enc.set_encode_parameter(param)
    first = enc.encode_many(*args)
    once = {k: getattr(enc, k) for k in names}
    assert once["train_batches"] == 2  # 8 full blocks in batches of 4
    assert 2 <= once["train_iterations"] <= 2 * 2000
    assert (once["train_batches"] * 2 <= once["train_active_row_iterations"]
            <= once["train_row_iterations"])
    assert once["train_s"] > 0
    previous = record_spans(True)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            second = enc.encode_many(*args)
            torch.cuda.synchronize()
    finally:
        record_spans(previous)
    assert second == first
    assert SPAN_PREFIX + "encode.train" in {e.key for e in
                                            prof.key_averages()}
    for k in names[:-1]:  # the same work again
        assert getattr(enc, k) == 2 * once[k]
    fresh = TorchEncoder(batch_blocks=4, device="cuda")
    fresh.set_encode_parameter(param)
    assert fresh.encode_many(*args) == first
    for sig, data in zip(sigs, first):
        assert np.array_equal(np.stack(Decoder().decode_whole(data)), sig)


# -- block data parallelism over a device list ---------------------------------

# a CPU entry beside the card catches tensors made on the wrong device; two
# entries on one card are all a one-card machine can split over; "every
# card" needs two or more
_DEVICE_LISTS = [["cpu", "cuda:0"], ["cuda:0", "cuda:0"], "every card"]


def _device_list(devices, rows=None):
    """The list to split over; "every card" skips below two cards, or
    where `rows` do not divide over the cards."""
    if devices != "every card":
        return devices
    count = torch.cuda.device_count()
    if count < 2 or (rows is not None and rows % count):
        pytest.skip(f"needs two or more cards ({count} here) that divide "
                    f"{rows} rows" if rows else
                    f"needs two or more cards ({count} here)")
    return [f"cuda:{i}" for i in range(count)]


def _streams(preset):
    spb = 2048
    sigs = [_track(3 * spb + 300, preset + 30), _track(2 * spb, preset + 31)]
    param = EncodeParameter(
        num_channels=2, bits_per_sample=16, sampling_rate=44100,
        num_samples_per_block=spb, preset=preset, ch_process_method=1)
    return sigs, param


@pytest.mark.parametrize("devices", _DEVICE_LISTS)
def test_decoder_device_list_on_card(devices):
    """Integer synthesis: the split decode equals the one-card decode
    whatever the entries, and the card's shard launches the kernel."""
    _require_card()
    devices = _device_list(devices)
    sigs, param = _streams(7)
    enc = TorchEncoder(batch_blocks=4, device="cuda")
    enc.set_encode_parameter(param)
    datas = enc.encode_many([[s[0], s[1]] for s in sigs],
                            [s.shape[1] for s in sigs]) * 2
    one = TorchDecoder(device="cuda").decode_many(datas)
    before = S.KERNEL_LAUNCHES
    split = TorchDecoder(devices=devices).decode_many(datas)
    assert S.KERNEL_LAUNCHES > before
    for sig, a, b in zip(sigs * 2, one, split):
        assert np.array_equal(np.stack(b), np.stack(a))
        assert np.array_equal(np.stack(b), sig)


@pytest.mark.parametrize("devices", _DEVICE_LISTS)
def test_device_exact_encoder_device_list_on_card(devices):
    """Strict float64 fits: the split encode gives the one-card bytes and
    the host oracle's, with no row flagged."""
    _require_card()
    devices = _device_list(devices, rows=128)
    sigs, param = _streams(1)
    chans = [[s[0], s[1]] for s in sigs]
    lengths = [s.shape[1] for s in sigs]
    refs = []
    for c, n in zip(chans, lengths):
        host = ExactEncoder()
        host.set_encode_parameter(param)
        refs.append(host.encode_whole(c, n))
    one = DeviceExactEncoder(device="cuda")
    one.set_encode_parameter(param)
    split = DeviceExactEncoder(devices=devices)
    split.set_encode_parameter(param)
    assert one.encode_many(chans, lengths) == refs
    assert split.encode_many(chans, lengths) == refs
    assert split.guard_rows_flagged == 0


@pytest.mark.parametrize("devices", _DEVICE_LISTS[1:])
def test_encoder_device_list_on_card(devices):
    """The split encode gives the one-card bytes."""
    _require_card()
    devices = _device_list(devices)
    sigs, param = _streams(7)
    chans = [[s[0], s[1]] for s in sigs]
    lengths = [s.shape[1] for s in sigs]
    streams = []
    for kw in ({"device": "cuda"}, {"devices": devices}):
        enc = TorchEncoder(batch_blocks=4, **kw)
        enc.set_encode_parameter(param)
        streams.append(enc.encode_many(chans, lengths))
    assert streams[1] == streams[0]


@pytest.mark.parametrize("devices", _DEVICE_LISTS)
def test_mesh_helpers_on_card(devices, routes):
    """sharded_analyze over the list equals the one-card call bit for bit
    (a CPU entry takes the card's route); one sharded train step matches
    the same split on the CPU (each shard's loss is its own mean, so the
    split sets the gradient's scale; the card's FFT and products round
    differently from the CPU's in the last bits)."""
    from linne_tpu_torch.parallel import mesh

    _require_card()
    devices = mesh.make_block_mesh(_device_list(devices))
    spb = 2048
    sig = _track(8 * spb, 40)
    blocks = np.ascontiguousarray(sig.reshape(2, 8, spb).transpose(1, 0, 2))
    enc = TorchEncoder(device="cuda")
    enc.set_encode_parameter(EncodeParameter(
        num_channels=2, bits_per_sample=16, sampling_rate=44100,
        num_samples_per_block=spb, preset=7, ch_process_method=1))
    one = enc._analyze_fn(spb)[0](torch.from_numpy(blocks).cuda())
    assert torch.equal(mesh.sharded_analyze(enc, devices, blocks, spb),
                       one["packed"].cpu())

    orders, n = (2, 32), 512
    rows = 2 * len(devices)
    rng = np.random.default_rng(41)
    signal = torch.from_numpy(rng.normal(0, 0.1, (rows, 2, n)))
    params = tuple(torch.from_numpy(rng.normal(0, 0.05, (rows, 2, o)))
                   for o in orders)
    momentum = tuple(torch.zeros_like(p) for p in params)
    out = {}
    for name, where in (("cpu", [torch.device("cpu")] * len(devices)),
                        ("split", devices)):
        step = mesh.make_sharded_train_step(where, orders, n, torch.float64)
        out[name] = step(params, signal, momentum)
    for want, got in zip(out["cpu"][0] + out["cpu"][1],
                         out["split"][0] + out["split"][1]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10,
                                   atol=1e-15)
    assert abs(float(out["split"][2]) - float(out["cpu"][2])) <= 1e-12


# -- the slim transfers and the matrix-unit routes -----------------------------


@pytest.mark.parametrize("width", [1, 6, 8, 10, 12, 14, 18, 20, 24, 30, 31])
def test_pack_plane_words_card_equals_cpu(width):
    """Bit for bit, on random int32 rows with both extremes and a ragged
    length; native.unpack_bits inverts the card's words."""
    from linne_tpu_torch import native
    from linne_tpu_torch.ops.bitpack import pack_geometry, pack_plane_words

    _require_card()
    rng = np.random.default_rng(width)
    x = rng.integers(-2**31, 2**31, (5, 2, 1027), dtype=np.int64)
    x = x.astype(np.int32)
    x[0, 0, 0], x[0, 1, -1] = -2**31, 2**31 - 1
    card = pack_plane_words(torch.from_numpy(x).cuda(), width).cpu()
    assert torch.equal(card, pack_plane_words(torch.from_numpy(x), width))
    g, _ = pack_geometry(width)
    sign = 1 << (width - 1)
    low = ((x.astype(np.int64) & ((1 << width) - 1)) ^ sign) - sign
    back = native.unpack_bits(card.numpy(), width, -(-1027 // g) * g)
    assert np.array_equal(back[..., :1027], low)


def test_forced_overflow_round_trip_on_card(monkeypatch):
    """A 6-bit residual class and a 6-bit download on the card: every live
    block and row takes its int32 fetch, the bytes equal the card's
    default encode's, and the decode is lossless."""
    from linne_tpu_torch.codec import encoder as E
    from linne_tpu_torch.codec import torch_decoder as TD

    _require_card()
    sigs, param = _streams(7)
    chans = [[s[0], s[1]] for s in sigs]
    lengths = [s.shape[1] for s in sigs]
    enc = TorchEncoder(batch_blocks=4, device="cuda")
    enc.set_encode_parameter(param)
    plain = enc.encode_many(chans, lengths)
    assert enc.overflow_rows == 0
    monkeypatch.setattr(E, "_res_width_classes", lambda bps: (6,))
    forced = TorchEncoder(batch_blocks=4, device="cuda")
    forced.set_encode_parameter(param)
    assert forced.encode_many(chans, lengths) == plain
    assert forced.overflow_rows > 0
    monkeypatch.setattr(TD, "_download_width", lambda bps: 6)
    monkeypatch.setattr(TD, "_DL_CHUNK_ROWS", 2)
    dec = TorchDecoder(device="cuda")
    for sig, out in zip(sigs, dec.decode_many(plain)):
        assert np.array_equal(np.stack(out), sig)
    assert dec.flagged_rows > 0 and dec.download_chunks > 2


def test_matmul_routes_on_card_match_cpu(routes):
    """autocorrelation, unit_forward and fit_layer at order 128 on the card
    against the CPU port on the same route; on the card the default is the
    matrix-unit route."""
    _require_card()
    assert A._use_matmul_routes(torch.zeros(1, device="cuda")) == routes
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(0, 1, (2, 4, 2, 10240)))
    p = torch.from_numpy(rng.normal(0, 0.05, (2, 4, 2, 2, 64)))
    for fn, args, tol in ((A.autocorrelation, (129,), 1e-9),
                          (A.autocorrelation, (17,), 1e-9),
                          (A.unit_forward, (p, 2), 1e-11)):
        cpu = fn(x, *args)
        card = fn(x.cuda(), *(a.cuda() if torch.is_tensor(a) else a
                               for a in args)).cpu()
        np.testing.assert_allclose(card.numpy(), cpu.numpy(), rtol=tol,
                                   atol=1e-8)
    cpu = A.fit_layer(x, 128, 0.0)
    card = A.fit_layer(x.cuda(), 128, 0.0)
    assert torch.equal(card[0].cpu(), cpu[0])
    np.testing.assert_allclose(card[1].cpu().numpy(), cpu[1].numpy(),
                               atol=1e-10)


def test_card_default_route_is_matmul(monkeypatch):
    _require_card()
    monkeypatch.setattr(A, "_MATMUL_ROUTES_OVERRIDE", None)
    assert A._use_matmul_routes(torch.zeros(1, device="cuda"))
    assert not A._use_matmul_routes(torch.zeros(1))


# -- the batched encode's serial loops (csrc/analysis_scans.cu) --------------
#
# The quantizer and the predict cascade are bit-equal to their plain
# versions. The recursion sums a . s in its own order: on rows that the data
# determine (the plain version's prediction error prod(1 - parcor^2) at or
# above 1e-8 of lag 0, every |parcor| < 1) it is held to 1e-9 of the row's
# largest |value|; on rows below (rank-deficient up to rounding, a pure
# tone) both versions divide rounding noise by rounding noise, and only NaN
# and +-Inf are held to the same places. Silent and guard rows are
# bit-equal.

_LEV_RTOL, _LEV_DETERMINED = 1e-9, 1e-8


def _scan(name, *args):
    """One call through the kernel's wrapper, which launches it once."""
    before = AS.KERNEL_LAUNCHES[name]
    got = getattr(AS, name)(*args)
    torch.cuda.synchronize()
    assert AS.KERNEL_LAUNCHES[name] == before + 1
    return got


def _quantize_rows(order, seed, shift=7):
    """Seeded rows at three scales, an all-zero row, rows at and just above
    the 2^-7 threshold, exact .5 ties at rshift `shift` (row 6: max |c| =
    96 * 2^-shift sets the shift), error feedback near the +-128 clamp."""
    rng = np.random.default_rng(seed)
    step = 2.0 ** -shift
    c = rng.normal(0, 0.3, (8, order)) * np.array(
        [1e-2, 1.0, 4.0, 0.0, 1.0, 1.0, 1.0, 1.0])[:, None]
    c[4] = 2.0 ** -7
    c[5] = np.where(np.arange(order) % 2, -1, 1) * 2.0 ** -7 * (1 + 2e-16)
    c[6] = (rng.integers(-64, 64, order)
            + 0.5 * rng.integers(0, 2, order)) * step
    c[6, 0] = 96 * step
    c[7] = np.where(np.arange(order) % 3, 127.49, -127.87) * step
    return torch.from_numpy(c).cuda()


@pytest.mark.parametrize("order", range(1, 129))
def test_scans_quantize_kernel_matches_plain_version(order):
    _require_card()
    c = _quantize_rows(order, order)
    got = _scan("quantize_coefficients", c, 8)
    want = A._quantize_coefficients_plain(c, 8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1][3] == 8 and got[1][4] == 8 and got[1][6] == 7


@pytest.mark.parametrize("shift", [3, 7, 12])
def test_scans_quantize_kernel_ties(shift):
    """Exact .5 ties at rshift 3, 7 and 12 (the error feedback meets them
    on row 6): the kernel bit for bit the plain version and the port's host
    quantizer (exact/lpc.py), which scales by math.pow(2.0, rshift)."""
    _require_card()
    from linne_tpu_torch.exact import lpc as HL

    order = 32
    c = _quantize_rows(order, shift, shift)
    got = _scan("quantize_coefficients", c, 8)
    want = A._quantize_coefficients_plain(c, 8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for r, row in enumerate(c.cpu().numpy()):
        q, rs = HL.quantize_coefficients(row, order, 8)
        assert np.array_equal(got[0][r].cpu().numpy(), q) and got[1][r] == rs
    assert got[1][6] == got[1][7] == shift


# -- the grouped quantizer: both variants (quantize_kernel<E>) ----------------

_QUANT_GROUPS = [(4, 128, 16), (128,), (1, 2, 3, 4)]
_QUANT_ROWS = [1, 31, 33, 128, 517]


def _quant(counter, fn, *args):
    """One call of a grouped quantizer wrapper, which launches its kernel
    once (counted under `counter`)."""
    before = AS.KERNEL_LAUNCHES[counter]
    got = fn(*args)
    torch.cuda.synchronize()
    assert AS.KERNEL_LAUNCHES[counter] == before + 1
    return got


def _same(got, want):
    """Bit for bit: float64 as int64 bits (NaN bits included; both ran on
    the card), ints as they are."""
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.is_floating_point():
            assert torch.equal(_bits(g), _bits(w))
        else:
            assert torch.equal(g, w)


@pytest.mark.parametrize("rows", _QUANT_ROWS)
@pytest.mark.parametrize("orders", _QUANT_GROUPS)
def test_scans_quantize_group_matches_plain_version(orders, rows):
    """The batched encoder's variant over ragged groups, the layers as
    column slices of one tensor (rows at its stride): bit for bit the
    grouped plain version, and the same as on contiguous copies."""
    _require_card()
    from chip_smoke import quantize_group

    layers, _ = quantize_group(orders, rows, rows + sum(orders), width=3)
    got = _quant("quantize_coefficients", AS.quantize_layers, layers, 8)
    _same(got, A._quantize_layers_plain(layers, 8))
    copies = [c.contiguous() for c in layers]
    _same(_quant("quantize_coefficients", AS.quantize_layers, copies, 8),
          got)


@pytest.mark.parametrize("rows", _QUANT_ROWS)
@pytest.mark.parametrize("orders", _QUANT_GROUPS)
def test_scans_quantize_exact_group_matches_plain_version(orders, rows):
    """The byte-exact fit's variant over ragged groups of an arena wider
    than its layers, with NaN and +-Inf rows: int coefficients, rshifts
    and both margins bit for bit the plain version on the card, and the
    same on a contiguous copy of the layers' columns."""
    _require_card()
    from linne_tpu_torch.ops import exact_device as ED
    from chip_smoke import quantize_group

    _, arena = quantize_group(orders, rows, rows + sum(orders), exact=True,
                              width=5)
    got = _quant("quantize_layer", AS.quantize_layers_exact, arena, orders,
                 8)
    _same(got, ED._quantize_layers_plain(arena, orders, 8))
    copy = arena[:, :sum(orders)].contiguous()
    _same(_quant("quantize_layer", AS.quantize_layers_exact, copy, orders,
                 8), got)


@pytest.mark.parametrize("order", range(1, 129))
def test_scans_quantize_exact_kernel_every_order(order):
    """The byte-exact variant at every order 1-128, one layer, on
    chip_smoke.py:quantize_special_rows (thresholds, ties, the clamp, NaN
    and +-Inf rows, a bin edge): bit for bit the plain version, margins
    included; the fit's _quantize_layers launches it."""
    _require_card()
    from linne_tpu_torch.ops import exact_device as ED
    from chip_smoke import quantize_special_rows

    c = quantize_special_rows(order, order)
    got = _quant("quantize_layer", AS.quantize_layers_exact, c, (order,), 8)
    _same(got, ED._quantize_layers_plain(c, (order,), 8))
    _same(_quant("quantize_layer", ED._quantize_layers, c, (order,), 8),
          got)
    assert got[1][3, 0] == 8 and got[1][4, 0] == 8  # zero; the threshold
    assert got[3][12] == 0.0  # max |c| at a bin edge


@pytest.mark.parametrize("shift", [3, 7, 12])
def test_scans_quantize_exact_kernel_ties(shift):
    """Exact .5 ties at rshift 3, 7 and 12: the byte-exact variant's ints
    and rshifts equal the port's host quantizer (exact/lpc.py) a row, its
    round margin is 0 on the tie row, and it is the plain version's bit
    for bit."""
    _require_card()
    from linne_tpu_torch.exact import lpc as HL
    from linne_tpu_torch.ops import exact_device as ED

    order = 32
    c = _quantize_rows(order, shift, shift)
    got = _quant("quantize_layer", AS.quantize_layers_exact, c, (order,), 8)
    _same(got, ED._quantize_layers_plain(c, (order,), 8))
    for r, row in enumerate(c.cpu().numpy()):
        q, rs = HL.quantize_coefficients(row, order, 8)
        assert np.array_equal(got[0][r].cpu().numpy(), q)
        assert got[1][r, 0] == rs
    assert got[2][6] == 0.0


def test_scans_quantize_main_path_one_launch_a_batch(monkeypatch):
    """TorchEncoder's finish stage quantizes a batch's three layers in one
    launch, and its streams equal those with the plain quantizer forced."""
    _require_card()
    sigs = [_track(9 * 2048 + 300, 3), _track(2 * 2048, 4)]
    param = EncodeParameter(
        num_channels=2, bits_per_sample=16, sampling_rate=44100,
        num_samples_per_block=2048, preset=7, ch_process_method=1)
    chans, lengths = [[s[0], s[1]] for s in sigs], [s.shape[1] for s in sigs]
    real, calls = A.quantize_layers, []

    def counting(coefs, nbits):
        calls.append(len(coefs))
        return real(coefs, nbits)

    monkeypatch.setattr(A, "quantize_layers", counting)
    enc = TorchEncoder(batch_blocks=4, device="cuda")
    enc.set_encode_parameter(param)
    before = AS.KERNEL_LAUNCHES["quantize_coefficients"]
    datas = enc.encode_many(chans, lengths)
    launches = AS.KERNEL_LAUNCHES["quantize_coefficients"] - before
    # the stages run as graphs: the wrapper runs in Python at a shape's
    # eager first batch and at its capture, and the launches count per run
    assert launches == len(enc.batch_widths) >= 3 and set(calls) == {3}
    monkeypatch.setattr(A, "quantize_layers", A._quantize_layers_plain)
    enc = TorchEncoder(batch_blocks=4, device="cuda")
    enc.set_encode_parameter(param)
    assert enc.encode_many(chans, lengths) == datas
    assert AS.KERNEL_LAUNCHES["quantize_coefficients"] == before + launches


@pytest.mark.parametrize("devices", [["cuda:0"], ["cuda:0", "cuda:0"]],
                         ids=["one", "two-shards"])
def test_graph_encode_equals_eager_on_card(monkeypatch, routes, devices):
    """The batched encode replaying its stages as CUDA graphs gives the
    bytes of the same encode run eagerly on the card (the graph lookup
    patched out), on both routes, at a forced 6-bit residual class (every
    live block fetches its residual after later batches were dispatched)
    and with a device-encoded tail (the mixed-unit predict branch)."""
    _require_card()
    from linne_tpu_torch.codec import encoder as E
    from linne_tpu_torch.codec import graphs as G

    monkeypatch.setattr(E, "_res_width_classes", lambda bps: (6,))
    monkeypatch.setattr(G, "CAPTURE_AT", 2)  # the few batches capture
    sigs = [_track(9 * 2048 + 301, 5), _track(5 * 2048 + 301, 6)]
    param = EncodeParameter(
        num_channels=2, bits_per_sample=16, sampling_rate=44100,
        num_samples_per_block=2048, preset=7, ch_process_method=1)
    chans, lengths = [[s[0], s[1]] for s in sigs], [s.shape[1] for s in sigs]
    streams = []
    for eager in (False, True):
        if eager:
            monkeypatch.setattr(TorchEncoder, "_stage_graphs",
                                lambda self, device: None)
        enc = TorchEncoder(batch_blocks=4, devices=devices,
                           tail_mode="device")
        enc.set_encode_parameter(param)
        streams.append(enc.encode_many(chans, lengths))
        assert enc.overflow_rows > 0
        if not eager:
            graphs = enc._graphs[torch.device("cuda", 0)]
            assert graphs.captures > 0
            assert (graphs.eager_runs + graphs.replays
                    >= 2 * len(enc.batch_widths))
    assert streams[0] == streams[1]
    for sig, data in zip(sigs, streams[0]):
        out = Decoder().decode_whole(data)
        assert all(np.array_equal(out[c], sig[c]) for c in range(2))


def _scan_levinson_rows(rows, order, seed):
    """Autocorrelations of seeded segments after a ridge; row 0 silent."""
    seg = _segments(rows, 1, 4 * order + 16, seed)
    return ES.autocorr_serial_ref(seg, order + 1)[:, 0].contiguous() * (
        torch.tensor([1.0 + 1.0 / 512.0] + [1.0] * order, device="cuda"))


def _check_scan_levinson(ac, order, with_parcor, exact_rows=(0,)):
    got = _scan("levinson_durbin", ac, order, with_parcor)
    got = got if with_parcor else (got,)
    want_lpc, want_pc = A._levinson_durbin_plain(ac, order, True)
    det = ((want_pc.abs() < 1).all(-1)
           & (torch.prod(1 - want_pc * want_pc, -1) >= _LEV_DETERMINED))
    for g, w in zip(got, (want_lpc, want_pc)):
        assert torch.equal(g.isnan(), w.isnan())
        inf = w.isinf()
        assert torch.equal(g.isinf(), inf) and torch.equal(g[inf], w[inf])
        fin = torch.isfinite(w)
        scale = torch.where(fin, w.abs(), 0.0).amax(-1)
        diff = torch.where(fin, (g - w).abs(), 0.0).amax(-1)
        assert bool(torch.all(diff[det] <= _LEV_RTOL * scale[det]))
        for r in exact_rows:
            assert torch.equal(_bits(g[r]), _bits(w[r]))
    return got


@pytest.mark.parametrize("with_parcor", [False, True])
@pytest.mark.parametrize("order", [1, 2, 4, 16, 31, 32, 33, 64, 127, 128])
def test_scans_levinson_kernel_matches_plain_version(order, with_parcor):
    """Seeded rows, a silent row, [1, 1, ...] (ek exactly 0 after the first
    step), a pure tone, a NaN lag, +-Inf lags and r0 = +Inf, at orders
    around the lanes-a-row templates."""
    _require_card()
    ac = _scan_levinson_rows(14, order, order)
    lags = torch.arange(order + 1, dtype=torch.float64, device="cuda")
    ac[8] = 1.0
    ac[9] = torch.cos(0.3 * lags)
    ac[10, min(order, 3)] = float("nan")
    ac[11, 1] = float("inf")
    ac[12, order] = -float("inf")
    ac[13, 0] = float("inf")
    got = _check_scan_levinson(ac, order, with_parcor, exact_rows=(0, 8))
    assert not got[0][0].any()
    assert got[0][8, 0] == -1.0 and not got[0][8, 1:].any()


@pytest.mark.parametrize("units,order", _preset7_levinson_calls())
def test_scans_levinson_kernel_preset7_calls(units, order):
    """Every (units, order) of a preset-7 fit, at 8 rows of units
    segments, with and without parcor."""
    _require_card()
    ac = _scan_levinson_rows(8 * units, order, units)
    for with_parcor in (False, True):
        _check_scan_levinson(ac, order, with_parcor)


def _nan_zero(t):
    return torch.where(t.isnan(), 0.0, t)


@pytest.mark.parametrize("order", range(1, 129))
def test_scans_levinson_kernel_every_order(order):
    """Every order 1-128 (each lanes-a-row template and their edges), at a
    row count that is no multiple of a CTA's rows, with a silent row,
    [1, 1, ...], a pure tone, a NaN lag, +-Inf lags and r0 = +Inf: within
    the tolerance of the plain version, and bit for bit the kernel's
    Schur-form model (tests/torch_levinson_model.py), with and without
    parcor."""
    _require_card()
    rows = 3 * (128 // lanes_for(order)) + 5
    ac = _scan_levinson_rows(rows, order, order)
    lags = torch.arange(order + 1, dtype=torch.float64, device="cuda")
    ac[1] = 0.0
    ac[2] = 1.0
    ac[3] = torch.cos(0.3 * lags)
    ac[4, min(order, 3)] = float("nan")
    ac[rows // 2, 1] = float("inf")
    ac[rows - 2, order] = -float("inf")
    ac[rows - 1, 0] = float("inf")
    got = _check_scan_levinson(ac, order, True, exact_rows=(0, 1, 2))
    want = levinson_schur(ac.cpu(), order, True)
    for g, w in zip(got, want):
        # NaN in the same places; the card's and the CPU's NaN bits differ
        g = g.cpu()
        assert torch.equal(g.isnan(), w.isnan())
        assert torch.equal(_bits(_nan_zero(g)), _bits(_nan_zero(w)))
    lpc = _scan("levinson_durbin", ac, order, False)
    assert torch.equal(lpc.isnan(), got[0].isnan())
    assert torch.equal(_bits(_nan_zero(lpc)), _bits(_nan_zero(got[0])))


def _scan_layers():
    """(order, unit choices) of every layer of presets 0-7."""
    return sorted({(o, tuple(A.candidate_units(o, 10240)))
                   for p in PRESETS for o in p.layer_num_params})


def _predict_rows(order, choices, n, seed):
    """Two rows at each log2u of the choices: samples and coefficients over
    the whole int32 range on even rows (the sums wrap), quantizer-range
    coefficients on odd rows; rshift 1..15 with 8 on row 0."""
    rng = np.random.default_rng(seed)
    rows = 2 * len(choices)
    x = rng.integers(-2**31, 2**31, (rows, n), dtype=np.int64)
    x[0, ::7] = -2**31
    x[1, ::5] = 2**31 - 1
    c = rng.integers(-2**31, 2**31, (rows, order), dtype=np.int64)
    c[1::2] = rng.integers(-128, 128, (rows // 2, order))
    log2u = np.repeat([(u - 1).bit_length() for u in choices], 2)
    rsh = rng.integers(1, 16, rows)
    rsh[0] = 8
    return tuple(torch.from_numpy(a.astype(np.int32)).cuda()
                 for a in (x, c, log2u, rsh))


@pytest.mark.parametrize("n", [10240, 384])  # 384: no multiple of the tile
@pytest.mark.parametrize("order,choices", _scan_layers())
def test_scans_predict_kernel_matches_plain_version(order, choices, n):
    _require_card()
    args = _predict_rows(order, choices, n, order + n) + (max(choices),)
    assert torch.equal(_scan("predict_dense", *args),
                       I._predict_dense_plain(*args))


# (order, unit choices, n): n that neither the 2048-sample tile nor the
# 16 outputs a thread divide; n = 1152 and 1056 give units of 9 and 33
# samples (a thread's outputs straddle two units); a row shorter than
# its history; npu 1 and 128 in one call
_PREDICT_EDGES = [(4, (1, 2, 4), 1500), (4, (1, 2, 4), 12),
                  (16, (1, 2), 2050), (128, (1, 2), 1030), (1, (1,), 1001),
                  (128, (1, 2, 4, 8, 16, 32, 64, 128), 1152),
                  (32, (1, 2, 4, 8, 16, 32), 1056)]


@pytest.mark.parametrize("order,choices,n", _PREDICT_EDGES)
def test_scans_predict_kernel_edges(order, choices, n):
    """The register-tiled cascade at its edges, every log2u of the choices
    in one call, with rshift 0, 32 and 40 (no rounding offset; torch's
    shifts out of range) beside 1..15: bit for bit the plain version."""
    _require_card()
    x, c, log2u, rsh = _predict_rows(order, choices, n, order + n)
    rsh[0], rsh[-1] = 0, 32
    if rsh.shape[0] > 2:
        rsh[1] = 40
    args = (x, c, log2u, rsh, max(choices))
    assert torch.equal(_scan("predict_dense", *args),
                       I._predict_dense_plain(*args))


def test_scans_device_list_gives_the_one_device_outputs():
    """Each kernel over ["cuda:0", "cuda:0"] (rows split into contiguous
    shards, one launch a shard) gives the one-call outputs bit for bit: no
    result depends on where a row sits in the batch."""
    _require_card()
    mesh = [torch.device("cuda:0"), torch.device("cuda:0")]

    def split(name, tensors, *rest):
        parts = []
        for dev, a, b in shards(mesh, tensors[0].shape[0]):
            out = getattr(AS, name)(*(t[a:b].contiguous().to(dev)
                                      for t in tensors), *rest)
            parts.append(out if isinstance(out, tuple) else (out,))
        return tuple(torch.cat(p) for p in zip(*parts))

    ac = _scan_levinson_rows(33, 128, 5)
    for order, rows in ((128, ac), (16, ac[:, :17].contiguous())):
        one = AS.levinson_durbin(rows, order, True)
        for g, w in zip(split("levinson_durbin", (rows,), order, True), one):
            assert torch.equal(_bits(g), _bits(w))
    c = _quantize_rows(128, 3).repeat(5, 1)
    one = AS.quantize_coefficients(c, 8)
    assert all(torch.equal(g, w) for g, w in zip(
        split("quantize_coefficients", (c,), 8), one))
    args = _predict_rows(128, (1, 2, 4, 8, 16, 32, 64, 128), 10240, 9)
    one = AS.predict_dense(*args, 128)
    assert torch.equal(split("predict_dense", args, 128)[0], one)


def test_scans_kernels_refuse_more_than_max_order():
    _require_card()
    before = dict(AS.KERNEL_LAUNCHES)
    with pytest.raises(ValueError):
        AS.levinson_durbin(torch.zeros(2, 130, dtype=torch.float64,
                                       device="cuda"), 129)
    with pytest.raises(ValueError):
        AS.quantize_coefficients(torch.zeros(2, 129, dtype=torch.float64,
                                             device="cuda"))
    with pytest.raises(ValueError):
        AS.predict_dense(*(torch.zeros(s, dtype=torch.int32, device="cuda")
                           for s in ((2, 256), (2, 129), 2, 2)), 4)
    assert AS.KERNEL_LAUNCHES == before


# -- the residual pass of a layer's unit sweep (unit_residual_select) --------
#
# The kernel's residuals are the loop route's sums (A._unit_forward_loop)
# bit for bit; its loss adds the same terms in another order, so it is
# held to 1e-12 of the plain version's, and a pick may differ from the
# plain version's only where the two losses of the candidates lie as
# close. The plain version runs on the card on the loop route here.

_UR_RTOL = 1e-12


def _ur_plain_loop(signal, params, units, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(A, "unit_forward", A._unit_forward_loop)
        return A._unit_residual_select_plain(signal, params, units)


def _ur_inputs(ridges, order, n, seed, blocks=4):
    """An expanded [ridges, blocks, 2, n] layer input (a ridge-stride-0
    view, as pre_stage gives the first layer) and each candidate's fitted
    coefficients under ridge terms 0, 2^-11, ...; then, in the rows of
    block 0: channel 0 all zero (silent), channel 1 every candidate's
    coefficients zero (an exact tie of all the candidates); in block 1,
    channel 0: the first candidate NaN; channel 1: the third candidate
    zero (the coefficients a degenerate split gets)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = (rng.normal(0, 0.02, (blocks, 2, n))
         + 0.3 * np.sin(2 * np.pi * rng.uniform(0.005, 0.1, (blocks, 2, 1))
                        * t))
    x[0, 0] = 0.0
    sig = torch.from_numpy(x).cuda()
    sig_r = sig.unsqueeze(0).expand((ridges,) + tuple(sig.shape))
    rv = torch.tensor([0.0, 2.0 ** -11, 2.0 ** -9, 2.0 ** -7][:ridges],
                      dtype=torch.float64, device="cuda").reshape(
        ridges, 1, 1, 1)
    units = A.candidate_units(order, n)
    params = [A.fit_unit_lpc(sig_r, u, order // u, rv) for u in units]
    for p in params:
        p[:, 0, 1] = 0.0
    params[0][:, 1, 0] = float("nan")
    if len(params) > 2:
        params[2][:, 1, 1] = 0.0
    return sig_r, params, units


def _ur_check(got, want, units):
    log2u, flat, res, loss = got
    wl2, wflat, wres, wloss = want
    agree = log2u == wl2
    # a pick differs only on a near-tie of the two candidates' losses
    assert torch.all(agree | ((loss - wloss).abs() <= 1e-12 * wloss.abs()))
    assert torch.equal(_bits(res[agree]), _bits(wres[agree]))
    assert torch.equal(_bits(flat[agree]), _bits(wflat[agree]))
    assert torch.equal(torch.isnan(loss), torch.isnan(wloss))
    fin = ~torch.isnan(wloss)
    torch.testing.assert_close(loss[fin], wloss[fin], rtol=_UR_RTOL, atol=0)
    return agree


@pytest.mark.parametrize("preset", [7, 0])
def test_scans_unit_residual_matches_plain_loop_route(preset, monkeypatch):
    """Every layer of presets 7 and 0 at block 10240 (4 and 1 ridge terms),
    the first layer's input expanded over the ridges: one launch a layer,
    the plain version's picks, residuals and coefficients bit for bit, its
    losses to 1e-12; the silent row's loss 0, the tie row's pick the first
    candidate, the NaN row's pick the NaN first candidate, the degenerate
    candidate's row as the data decide."""
    _require_card()
    ridges = len(PRESETS[preset].ridge_terms)
    x = None
    for li, order in enumerate(PRESETS[preset].layer_num_params):
        sig_r, params, units = _ur_inputs(ridges, order, 10240, preset + li)
        if x is not None:  # a later layer: a contiguous [R, B, C, n] input
            sig_r = x
            params = [A.fit_unit_lpc(sig_r, u, order // u, 0.0)
                      for u in units]
            params[0][:, 1, 0] = float("nan")
            for p in params:
                p[:, 0, 1] = 0.0
        before = AS.KERNEL_LAUNCHES["unit_residual_select"]
        got = A.unit_residual_select(sig_r, params, units)
        torch.cuda.synchronize()
        assert AS.KERNEL_LAUNCHES["unit_residual_select"] == before + 1
        want = _ur_plain_loop(sig_r, params, units, monkeypatch)
        agree = _ur_check(got, want, units)
        log2u, _, res, loss = got
        assert agree[:, :2].all()  # the special rows
        assert torch.all(log2u[:, 0, 1] == 0) and torch.all(log2u[:, 1, 0] == 0)
        assert torch.all(torch.isnan(loss[:, 1, 0]))
        if li == 0:
            assert torch.all(loss[:, 0, 0] == 0) and torch.all(
                res[:, 0, 0] == 0)
        x = res


@pytest.mark.parametrize("n,order,ridges,rows", [
    (64, 128, 1, 3),     # units shorter than their taps: u = 1, 2 degenerate
    (24576, 32, 1, 5),   # longer than a CTA's shared memory: chunks
    (30000, 16, 2, 3),   # chunks that cut units
    (777, 3, 3, 2), (300, 4, 2, 7), (2048, 128, 1, 4)])
def test_scans_unit_residual_edges(n, order, ridges, rows, monkeypatch):
    """Edge shapes of the kernel's plan against the plain loop route, with
    coefficients drawn at random (not fitted): degenerate splits whose
    taps reach back over several units, rows taken in chunks, odd n, an
    order that is not a power of two."""
    _require_card()
    rng = np.random.default_rng(n + order)
    units = [u for u in (1, 2, 4, 8, 16, 32, 64, 128)
             if order % u == 0 and n % u == 0]
    x = torch.from_numpy(rng.normal(0, 0.3, (rows, n))).cuda()
    sig_r = x.unsqueeze(0).expand(ridges, rows, n)
    params = [torch.from_numpy(rng.normal(0, 0.2, (ridges, rows, u,
                                                   order // u))).cuda()
              for u in units]
    before = AS.KERNEL_LAUNCHES["unit_residual_select"]
    got = A.unit_residual_select(sig_r, params, units)
    torch.cuda.synchronize()
    assert AS.KERNEL_LAUNCHES["unit_residual_select"] == before + 1
    _ur_check(got, _ur_plain_loop(sig_r, params, units, monkeypatch), units)


def test_scans_unit_residual_fit_layer_one_launch(monkeypatch):
    """fit_layer on the card launches the kernel once and never takes
    unit_forward (none of its routes); its outputs are the kernel's."""
    _require_card()

    def refused(*args):
        raise AssertionError("unit_forward called on the card's fit_layer")

    sig_r, _, _ = _ur_inputs(4, 128, 10240, 11, blocks=2)
    rv = torch.zeros(4, 1, 1, 1, dtype=torch.float64, device="cuda")
    monkeypatch.setattr(A, "unit_forward", refused)
    before = dict(AS.KERNEL_LAUNCHES)
    got = A.fit_layer(sig_r, 128, rv)
    torch.cuda.synchronize()
    assert AS.KERNEL_LAUNCHES["unit_residual_select"] == (
        before["unit_residual_select"] + 1)
    assert got[2].shape == sig_r.shape and got[1].shape == (4, 2, 2, 128)
    units = A.candidate_units(128, 10240)
    params = [A.fit_unit_lpc(sig_r, u, 128 // u, rv) for u in units]
    again = A.unit_residual_select(sig_r, params, units)
    assert all(torch.equal(_bits(g) if g.is_floating_point() else g,
                           _bits(w) if w.is_floating_point() else w)
               for g, w in zip(got, again))


# -- the layer fits' windowed autocorrelation (lpc_autocorr) -----------------
#
# Each windowed sample is the plain version's `seg * window` bits; each lag
# sums in another order than the plain version's route, so a lag is held
# to 1e-12 of its unit's lag 0 (the largest |value| a unit has), silent
# rows to exact zeros, and two launches to the same bits.

_LA_RTOL = 1e-12


def _la_signal(lead, n, seed):
    """Noise and a tone a row, at the scale of normalized samples; the
    first row all zero (silent)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = (rng.normal(0, 0.02, lead + (n,))
         + 0.3 * np.sin(2 * np.pi * rng.uniform(0.001, 0.1, lead + (1,)) * t))
    x.reshape(-1, n)[0] = 0.0
    return torch.from_numpy(x).cuda()


def _la_launches(preset, blocks, n=10240):
    """(what, signal, splits, window type) of each launch of one batch of
    `blocks` blocks at `preset`: the block-type estimate, then each layer,
    the first one's input expanded over the ridge terms."""
    from linne_tpu_torch.ops.windows import WINDOW_SIN, WINDOW_WELCH

    p = PRESETS[preset]
    ridges = len(p.ridge_terms)
    sig = _la_signal((blocks, 2), n, preset)
    out = [("estimate", sig, [(1, p.layer_num_params[0] + 1)], WINDOW_SIN)]
    for li, order in enumerate(p.layer_num_params):
        x = (sig.unsqueeze(0).expand((ridges,) + tuple(sig.shape)) if li == 0
             else _la_signal((ridges, blocks, 2), n, preset + li))
        out.append((f"layer {li}", x, [(u, order // u + 1) for u in
                                       A.candidate_units(order, n)],
                    WINDOW_WELCH))
    return out


def _la_check(signal, splits, window_type, windows=None):
    """One launch against the plain version: each lag within _LA_RTOL of
    its unit's lag 0, silent units exactly 0, a second launch the same
    bits."""
    windows = {} if windows is None else windows
    before = AS.KERNEL_LAUNCHES["lpc_autocorr"]
    got = A.unit_autocorrelations(signal, splits, window_type, windows)
    torch.cuda.synchronize()
    assert AS.KERNEL_LAUNCHES["lpc_autocorr"] == before + 1
    again = A.unit_autocorrelations(signal, splits, window_type, windows)
    want = A._unit_autocorrelations_plain(signal, splits, window_type,
                                          windows)
    for g, a, w, (u, lags) in zip(got, again, want, splits):
        assert g.shape == w.shape == signal.shape[:-1] + (u, lags)
        assert torch.equal(_bits(g), _bits(a))
        scale = w[..., :1].abs()
        assert torch.all((g - w).abs() <= _LA_RTOL * scale)
        silent = scale[..., 0] == 0
        assert torch.all(g[silent] == 0)
    return got


@pytest.mark.parametrize("preset,blocks", [(7, 128), (0, 64)])
def test_scans_lpc_autocorr_matches_plain_version(preset, blocks):
    """Every launch of a preset-7 batch of 128 blocks and a preset-0 batch
    of 64 (the estimate, then each layer, the first expanded over 4 and 1
    ridge terms): one launch each, the plain version's sums within 1e-12
    of a unit's lag 0, the silent row's zeros, the same bits twice; the
    expanded layer's result the same for every ridge term."""
    _require_card()
    for what, x, splits, wt in _la_launches(preset, blocks):
        got = _la_check(x, splits, wt)
        if x.stride(0) == 0:
            assert all(g.stride(0) == 0 for g in got), what


@pytest.mark.parametrize("n,order,rows,windowed", [
    (64, 128, 3, True),     # units shorter than their lags: u = 1, 2
    (32768, 128, 5, True),  # longer than a CTA keeps: chunks
    (30000, 16, 3, True),   # chunks that cut units
    (777, 4, 7, True),      # odd n: units at odd strides unpadded
    (4096, 128, 9, False),  # no window (autocorrelation on the card)
    (80, 1, 2, True)])      # one lag beyond the first: order 1
def test_scans_lpc_autocorr_edges(n, order, rows, windowed):
    """Edge shapes of the kernel's plan against the plain version: units
    shorter than their lags, rows taken in chunks, odd n, no window; and
    every row's sums the same bits with the rows reversed."""
    _require_card()
    from linne_tpu_torch.ops.windows import WINDOW_RECTANGULAR, WINDOW_WELCH

    x = _la_signal((rows,), n, n + order)
    splits = [(u, order // u + 1) for u in (1, 2, 4, 8, 16, 32, 64, 128)
              if n % u == 0 and u <= order and n // u >= 2]
    wt = WINDOW_WELCH if windowed else WINDOW_RECTANGULAR
    got = _la_check(x, splits, wt)
    flip = A.unit_autocorrelations(x.flip(0), splits, wt, {})
    assert all(torch.equal(_bits(g), _bits(f.flip(0)))
               for g, f in zip(got, flip))
    if not windowed:
        ac = A.autocorrelation(x, order + 1)
        assert torch.equal(_bits(ac), _bits(got[0][:, 0]))


@pytest.mark.parametrize("preset", [7, 0])
def test_scans_lpc_autocorr_fit_layer_one_launch(preset, monkeypatch):
    """fit_layer and estimate_code_length on the card launch the kernel
    once a layer (and once for the estimate), reach neither the plain
    routes nor `_autocorr_matmul`, and run no ATen GEMM."""
    _require_card()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def refused(*args):
        raise AssertionError("an autocorrelation route reached on the card")

    monkeypatch.setattr(A, "_autocorrelation_plain", refused)
    monkeypatch.setattr(A, "_autocorr_matmul", refused)
    p = PRESETS[preset]
    sig = _la_signal((8, 2), 10240, 3)
    rv = torch.tensor(p.ridge_terms, dtype=torch.float64,
                      device="cuda").reshape(-1, 1, 1, 1)
    before = AS.KERNEL_LAUNCHES["lpc_autocorr"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        A.estimate_code_length(sig, p.layer_num_params[0], 16, {})
        x = sig.unsqueeze(0).expand((len(p.ridge_terms),) + tuple(sig.shape))
        for order in p.layer_num_params:
            x = A.fit_layer(x, order, rv, {})[2]
        torch.cuda.synchronize()
    assert AS.KERNEL_LAUNCHES["lpc_autocorr"] == (
        before + 1 + len(p.layer_num_params))
    gemm = [ev.key for ev in prof.key_averages()
            if ev.key in ("aten::mm", "aten::bmm", "aten::matmul",
                          "aten::einsum", "aten::addmm")
            or (ev.device_type == DeviceType.CUDA
                and "gemm" in ev.key.lower())]
    assert not gemm, gemm


@pytest.mark.parametrize("preset", [7, 0])
def test_scans_lpc_autocorr_fit_layer_matches_cpu(preset):
    """fit_layer on the card picks the CPU's unit counts and quantized
    coefficients, layer by layer on the test tracks (each layer's input
    the CPU's residual), over the preset's ridge terms."""
    _require_card()
    p = PRESETS[preset]
    n = 10240
    tracks = [_track(3 * n, seed) for seed in (preset, preset + 1)]
    blocks = np.stack([t[:, b * n:(b + 1) * n] for t in tracks
                       for b in range(3)])
    sig = I.normalize_to_float(torch.from_numpy(blocks), 16, torch.float64)
    rv = torch.tensor(p.ridge_terms, dtype=torch.float64).reshape(-1, 1, 1,
                                                                  1)
    lead = (len(p.ridge_terms),) + tuple(sig.shape)
    x, x_card = sig.unsqueeze(0).expand(lead), sig.cuda().unsqueeze(0).expand(
        lead)
    for order in p.layer_num_params:
        cpu = A.fit_layer(x, order, rv)
        card = A.fit_layer(x_card, order, rv.cuda(), {})
        assert torch.equal(card[0].cpu(), cpu[0])
        for got, want in zip(A.quantize_coefficients(card[1]),
                             A.quantize_coefficients(cpu[1])):
            assert torch.equal(got.cpu(), want)
        x = cpu[2]
        x_card = x.cuda()


# -- the finish stage's Rice parameter search (rice_search) -------------------


def _rice_plane(lead, n, seed):
    """Seeded residual rows on the card: Laplacian noise at a scale drawn
    log-uniformly from 1 to 10^5 a row, a quiet first half on every third
    row, sparse spikes on every fifth."""
    rng = np.random.default_rng(seed)
    rows = int(np.prod(lead))
    scale = np.exp(rng.uniform(0.0, np.log(1e5), (rows, 1)))
    x = np.round(rng.laplace(0.0, 1.0, (rows, n)) * scale)
    x[::3, : n // 2] //= 50
    x[::5] *= (np.arange(n) % 97 == 0) * 30 + 1
    return torch.from_numpy(np.clip(x, -2**31, 2**31 - 1).astype(
        np.int32).reshape(tuple(lead) + (n,))).cuda()


def _rice_check(x):
    """rice_search on the card: one launch, and the plain version's orders
    and every k2 entry (the zeros past 2^best included) bit for bit on the
    same CUDA tensor. Returns the orders."""
    before = AS.KERNEL_LAUNCHES["rice_search"]
    best, k2 = R.rice_search(x)
    torch.cuda.synchronize()
    assert AS.KERNEL_LAUNCHES["rice_search"] == before + 1
    want_best, want_k2 = R._rice_search_plain(x)
    assert best.dtype == k2.dtype == torch.int32
    assert best.shape == want_best.shape and k2.shape == want_k2.shape
    assert torch.equal(best, want_best)
    assert torch.equal(k2, want_k2)
    return best


@pytest.mark.parametrize("blocks", [128, 64])
def test_scans_rice_search_matches_plain_version(blocks):
    """The main path's batches: (128, 2, 10240) and (64, 2, 10240)."""
    _require_card()
    x = _rice_plane((blocks, 2), 10240, blocks)
    best = _rice_check(x)
    assert len(set(best.flatten().tolist())) > 3
    if blocks == 128:
        # a parameter step of -4 decides a row's order here: the card's
        # plain version costs it 5 bits, the CPU's 7 (rs_gamma)
        assert not torch.equal(best.cpu(), R._rice_search_plain(x.cpu())[0])


@pytest.mark.parametrize("n", [1, 3, 4410, 8192, 10239])
def test_scans_rice_search_tails(n):
    """Device tails: every finest partition order 0..10, chunked
    partitions, rows off a 16-byte boundary."""
    _require_card()
    _rice_check(_rice_plane((5, 2), n, n))


@pytest.mark.parametrize("n", [30001, 65536, 1 << 21])
def test_scans_rice_search_rows_past_shared_memory(n):
    """Rows longer than a CTA's shared memory holds, read from device
    memory in each pass, up to the longest row the kernel takes."""
    _require_card()
    _rice_check(_rice_plane((2, 1), n, n))


def _rice_extreme(case, n=10240):
    rng = np.random.default_rng(11)
    if case == "zeros":
        x = np.zeros((4, n))
    elif case == "constant":
        x = np.stack([np.full(n, v) for v in (1, -1, 12345, -2**31)])
    elif case == "int32 extremes":
        x = rng.choice([-2**31, 2**31 - 1, -1, 0, 1], (6, n))
        x[1] = np.where(np.arange(n) % 2, 2**31 - 1, -2**31)
        x[2, : n // 2] = 0
    elif case == "ties":
        x = tie_plane(n)
    else:
        x = edge_plane(n)
    return torch.from_numpy(x.astype(np.int32)).cuda()


@pytest.mark.parametrize("case", ["zeros", "constant", "int32 extremes",
                                  "ties", "fit edges"])
def test_scans_rice_search_extremes(case):
    """All-zero rows, constant rows, INT32_MIN and INT32_MAX mixed (code
    lengths past 2^32, which wrap as the plain version's do), rows whose
    lowest total two orders share (the first minimum: the lower order),
    and finest partitions whose means lie within 0.3 of each edge of the
    parameter fit (the finest order wins, so every fitted parameter is in
    the output)."""
    _require_card()
    best = _rice_check(_rice_extreme(case))
    if case == "zeros":
        assert not torch.any(best)
    if case == "fit edges":
        assert torch.all(best == 10)


def test_scans_rice_search_partition_means_are_reciprocal_products():
    """The kernel takes a partition's mean as its sum times the reciprocal
    of its length, as torch divides a CUDA tensor by a Python int; were
    torch to divide instead, this fails before any parameter could."""
    _require_card()
    rng = np.random.default_rng(5)
    s = torch.from_numpy(rng.integers(0, 1 << 45, 1 << 16).astype(
        np.float64)).cuda()
    for n in (10, 20, 40, 80, 160, 320, 640, 1280, 2560, 5120, 10240, 2205):
        assert torch.equal(s / n, s * (1.0 / n))


def test_scans_rice_search_in_a_cuda_graph():
    """Captured once and replayed on new residuals, the kernel gives the
    plain version's outputs on them."""
    _require_card()
    x = _rice_plane((64, 2), 10240, 1)
    R.rice_search(x)  # load the library and set the kernel up, outside
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        best, k2 = R.rice_search(x)
    for seed in (2, 3):
        x.copy_(_rice_plane((64, 2), 10240, seed))
        graph.replay()
        torch.cuda.synchronize()
        want_best, want_k2 = R._rice_search_plain(x)
        assert torch.equal(best, want_best) and torch.equal(k2, want_k2)
