"""The port's IRLS refinement (`-a N`, linne_tpu_torch/ops/afmethod.py)
against the JAX package's, float64 on the CPU, and TorchEncoder's `-a`
streams against TpuEncoder's.

IRLS reweights by 1/|residual|, so it amplifies the last-bit differences of
two implementations that sum in another order (the Gram products, the
Cholesky). The refinement inputs here are AR(1) noise, whose normal
matrices are well conditioned, so three iterations stay inside rtol 1e-9;
longer rows (10240 samples at order 32) drift past it. The all-zero row
has a singular normal matrix: both give it zero coefficients.
"""

import numpy as np
import pytest
import torch
from scipy.signal import lfilter

import jax.numpy as jnp
from linne_tpu import ops as _jax_ops  # noqa: F401  (enables x64)
from linne_tpu.codec import params as jax_params
from linne_tpu.codec.encoder import TpuEncoder
from linne_tpu.ops import afmethod as jax_af
from linne_tpu.ops.analysis import candidate_units
from linne_tpu_torch import cli
from linne_tpu_torch.codec.decoder import Decoder
from linne_tpu_torch.codec.encoder import TorchEncoder
from linne_tpu_torch.codec.torch_decoder import TorchDecoder
from linne_tpu_torch.exact.lpc import WINDOW_WELCH, LpcState
from linne_tpu_torch.io.wav import write_wav
from linne_tpu_torch.ops import afmethod

from test_torch_codec import _param, _signal


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the trainer and the refit dispatch
    many small ops, which slow down by an order of magnitude when the
    threads of several test workers oversubscribe the cores. One thread
    also makes the float sums independent of the machine's core count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ar_rows(rows, ns, seed):
    rng = np.random.default_rng(seed)
    data = lfilter([1.0], [1.0, -0.5], rng.normal(0, 0.1, (rows, ns)),
                   axis=1)
    data[2] = 0.0  # singular normal matrix
    return data


@pytest.mark.parametrize("iterations", [0, 1, 3])
@pytest.mark.parametrize("order,ns", [(16, 5000), (32, 2048), (8, 20)])
def test_af_refine_matches_jax(order, ns, iterations):
    data = _ar_rows(6, ns, order + ns)
    a0 = np.random.default_rng(order).normal(0, 0.1, (6, order))
    want = np.asarray(jax_af.af_refine(jnp.asarray(data), jnp.asarray(a0),
                                       iterations))
    refit = afmethod.make_af_refit_fn(order, iterations)
    got = refit(torch.from_numpy(data), torch.from_numpy(a0)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    if iterations:
        assert not np.any(want[2]) and not np.any(got[2])


def test_af_refine_short_rows_keep_a0():
    """ns <= order leaves no residual to weight: a0 comes back."""
    rng = np.random.default_rng(2)
    data, a0 = rng.normal(0, 1, (3, 16)), rng.normal(0, 0.1, (3, 16))
    want = np.asarray(jax_af.af_refine(jnp.asarray(data), jnp.asarray(a0), 2))
    got = afmethod.af_refine(torch.from_numpy(data), torch.from_numpy(a0), 2)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, a0)


def test_af_refine_matches_exact_oracle():
    """Against the port's byte-exact host fit (LpcState.calculate_coef_af),
    at the tolerance of tests/test_afmethod.py: the oracle early-stops and
    solves row by row."""
    rng = np.random.default_rng(3)
    ns, order, rows = 2048, 16, 4
    data = np.cumsum(rng.normal(0, 0.05, (rows, ns)), axis=1)
    data = data / np.abs(data).max()
    init = np.stack([LpcState(order, ns).calculate_coef_af(
        data[r], ns, order, 0, WINDOW_WELCH, 0.0) for r in range(rows)])
    want = np.stack([LpcState(order, ns).calculate_coef_af(
        data[r], ns, order, 3, WINDOW_WELCH, 0.0) for r in range(rows)])
    got = afmethod.af_refine(torch.from_numpy(data), torch.from_numpy(init),
                             3).numpy()
    assert np.allclose(got, want, atol=1e-6), np.abs(got - want).max()


@pytest.mark.parametrize("order", [4, 32])
def test_af_layer_stage_matches_jax(order):
    """Every unit-split candidate refit, the winner gathered through the
    log2u table; a silent (block, channel) row included."""
    n = 2560
    rng = np.random.default_rng(order)
    x = lfilter([1.0], [1.0, -0.6], rng.normal(0, 0.2, (3, 2, n)), axis=-1)
    x[1, 0] = 0.0
    units = candidate_units(order, n)
    log2u = rng.choice([int(np.log2(u)) for u in units], (3, 2))
    log2u = log2u.astype(np.int32)
    ridge = np.where(rng.random((3, 2)) < 0.5, 0.0, 1.0 / 512.0)
    jflat, jres = jax_af.make_af_layer_stage(order, units, 2)(
        jnp.asarray(x), jnp.asarray(log2u), jnp.asarray(ridge))
    flat, res = afmethod.make_af_layer_stage(order, units, 2)(
        torch.from_numpy(x), torch.from_numpy(log2u), torch.from_numpy(ridge))
    np.testing.assert_allclose(flat.numpy(), np.asarray(jflat), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(res.numpy(), np.asarray(jres), rtol=1e-9,
                               atol=1e-12)
    assert not np.any(flat.numpy()[1, 0])


def _af_param(preset, spb, af, *cls):
    p = _param(preset, spb, *cls)
    p.num_afmethod_iterations = af
    return p


@pytest.fixture(scope="module")
def jax_af_streams():
    """TpuEncoder `-a 2` bytes per (preset, tail_mode); one encoder per
    preset, so the host-tail encode reuses the full-block build."""
    out = {}
    for preset, spb in [(0, 2048), (4, 2560)]:
        n = 3 * spb + 700
        sig = _signal(n, preset)
        enc = TpuEncoder(batch_blocks=4, tail_mode="device")
        enc.set_encode_parameter(
            _af_param(preset, spb, 2, jax_params.EncodeParameter))
        for mode in ("device", "host"):
            enc.tail_mode = mode
            out[(preset, mode)] = enc.encode_whole([sig[0], sig[1]], n)
    return out


@pytest.mark.parametrize("tail_mode", ["device", "host"])
@pytest.mark.parametrize("preset,spb", [(0, 2048), (4, 2560)])
def test_af_bytes_equal_tpu_encoder(jax_af_streams, preset, spb, tail_mode):
    n = 3 * spb + 700
    sig = _signal(n, preset)
    enc = TorchEncoder(batch_blocks=4, tail_mode=tail_mode, device="cpu")
    enc.set_encode_parameter(_af_param(preset, spb, 2))
    data = enc.encode_whole([sig[0], sig[1]], n)
    assert data == jax_af_streams[(preset, tail_mode)]
    assert np.array_equal(np.stack(Decoder().decode_whole(data)), sig)
    out = TorchDecoder(device="cpu").decode_whole(data)
    assert np.array_equal(np.stack(out), sig)


def test_cli_af_bytes_equal_jax_cli(tmp_path):
    from linne_tpu import cli as jax_cli

    sig = _signal(2 * 10240 + 900, 9)
    wav = tmp_path / "in.wav"
    write_wav(str(wav), sig, 44100, 16)
    ours, theirs = tmp_path / "ours.lnn", tmp_path / "theirs.lnn"
    flags = ["-e", "-m", "1", "-a", "2"]
    assert cli.main([*flags, "--device", "cpu", str(wav), str(ours)]) == 0
    assert jax_cli.main([*flags, str(wav), str(theirs)]) == 0
    assert ours.read_bytes() == theirs.read_bytes()
    assert np.array_equal(np.stack(Decoder().decode_whole(ours.read_bytes())),
                          sig)
