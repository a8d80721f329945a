"""The port's population trainer (`-l`, linne_tpu_torch/ops/training.py)
against the JAX package's, float64 on the CPU, and TorchEncoder's `-l`
streams against TpuEncoder's.

The two sum the L1 loss and the gradients in other orders, so they differ
in the last bits; momentum descent on an L1 loss amplifies that slowly
(on a 704-sample tail at preset 1 the gap grew from 1e-18 at iteration 5
to 1e-5 at iteration 800). The encoder cases here stop within ~250
iterations, where the streams are byte-equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from linne_tpu import ops as _jax_ops  # noqa: F401  (enables x64)
from linne_tpu.codec import params as jax_params
from linne_tpu.codec.encoder import TpuEncoder
from linne_tpu.ops import training as jax_training
from linne_tpu.ops.analysis import candidate_units
from linne_tpu_torch import cli
from linne_tpu_torch.codec.decoder import Decoder
from linne_tpu_torch.codec.encoder import TorchEncoder
from linne_tpu_torch.codec.torch_decoder import TorchDecoder
from linne_tpu_torch.constants import (
    TRAINING_LEARNING_RATE,
    TRAINING_LOSS_EPSILON,
    TRAINING_MAX_NUM_ITERATIONS,
)
from linne_tpu_torch.io.wav import write_wav
from linne_tpu_torch.ops import training

from test_torch_codec import _param, _signal

_ORDERS = [2, 32]
_N = 1280


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


def _population(seed, silent=True):
    """5 blocks x 2 channels at orders (2, 32): signal, params, log2u."""
    rng = np.random.default_rng(seed)
    units = [candidate_units(o, _N) for o in _ORDERS]
    sig = rng.normal(0, 0.1, (5, 2, _N))
    if silent:
        sig[1, 0] = 0.0  # a silent row: every residual exactly zero
    params = [rng.normal(0, 0.1, (5, 2, o)) for o in _ORDERS]
    log2u = [rng.choice([int(np.log2(u)) for u in c], (5, 2)).astype(np.int32)
             for c in units]
    return units, sig, params, log2u


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_dense_layouts_bit_equal():
    units, _sig, _params, log2u = _population(1)
    want = jax_training._dense_layouts(_ORDERS, units, _jax(*log2u))
    got = training._dense_layouts(_ORDERS, units, _torch(*log2u))
    for (jsrc, jvalid, ju), (src, valid, u) in zip(want, got):
        assert src.dtype == torch.int32
        assert np.array_equal(src.numpy(), np.asarray(jsrc))
        assert np.array_equal(valid.numpy(), np.asarray(jvalid))
        assert u == ju


def test_dense_forward_loss_matches_jax_and_variant_forward():
    units, sig, params, log2u = _population(2)
    want = jax_training._dense_forward_loss(
        _jax(*params), jax_training._dense_layouts(_ORDERS, units,
                                                   _jax(*log2u)),
        jnp.asarray(sig))
    got = training._dense_forward_loss(
        _torch(*params), training._dense_layouts(_ORDERS, units,
                                                 _torch(*log2u)),
        torch.from_numpy(sig))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-15)
    variants = training._forward_loss(_torch(*params), _torch(*log2u),
                                      torch.from_numpy(sig), _ORDERS, units)
    np.testing.assert_allclose(got.numpy(), variants.numpy(), rtol=1e-12,
                               atol=1e-15)


def test_loss_gradient_at_zero_residuals_matches_jax():
    """A silent row and silent stretches give exactly zero residuals;
    JAX's derivative of |x| there is +1 (at +0.0 and -0.0 alike), that of
    torch.abs is 0."""
    units, sig, params, log2u = _population(3)
    sig[:, :, 400:700] = 0.0
    layouts = jax_training._dense_layouts(_ORDERS, units, _jax(*log2u))

    def total(ps):
        return jnp.sum(jax_training._dense_forward_loss(ps, layouts,
                                                        jnp.asarray(sig)))

    want = jax.grad(total)(_jax(*params))
    leaves = [t.requires_grad_() for t in _torch(*params)]
    per = training._dense_forward_loss(
        leaves, training._dense_layouts(_ORDERS, units, _torch(*log2u)),
        torch.from_numpy(sig))
    got = torch.autograd.grad(per.sum(), leaves)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-15)
    assert per[1, 0] == 0  # the silent row: every residual exactly zero
    x = torch.tensor([0.0, -0.0, 2.0, -3.0], requires_grad=True)
    (g,) = torch.autograd.grad(training._abs(x).sum(), x)
    assert g.tolist() == [1.0, 1.0, 1.0, -1.0]
    assert g.tolist() == np.asarray(jax.grad(
        lambda v: jnp.sum(jnp.abs(v)))(jnp.asarray(x.detach().numpy()))
    ).tolist()


def test_train_fn_matches_jax():
    """Params allclose, and JAX's loop ran as many iterations: capped one
    short it ends elsewhere, capped at the port's count it ends where it
    ends uncapped. The stopping threshold is 100x the encoder's, which
    stops this random population after ~130 iterations, not ~1400."""
    units, sig, params, log2u = _population(4)
    args = (_ORDERS, units)
    hyper = (TRAINING_LEARNING_RATE, 100 * TRAINING_LOSS_EPSILON)
    got, iterations = training.make_train_fn(
        *args, TRAINING_MAX_NUM_ITERATIONS, *hyper)(
        torch.from_numpy(sig), _torch(*params), _torch(*log2u))
    assert 2 < iterations < TRAINING_MAX_NUM_ITERATIONS

    def jax_train(cap):
        return [np.asarray(p) for p in jax_training.make_train_fn(
            *args, cap, *hyper)(jnp.asarray(sig), _jax(*params),
                                _jax(*log2u))]

    want = jax_train(TRAINING_MAX_NUM_ITERATIONS)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-8, atol=1e-15)
    assert all(np.array_equal(a, b)
               for a, b in zip(jax_train(iterations), want))
    assert not all(np.array_equal(a, b)
                   for a, b in zip(jax_train(iterations - 1), want))


def _learn_param(preset, spb, af, *cls):
    p = _param(preset, spb, *cls)
    p.enable_learning = True
    p.num_afmethod_iterations = af
    return p


# (preset, -a N); block 2048 and a 1500-sample tail keep training short
_CASES = [(0, 0), (1, 0), (1, 1)]
_SPB = 2048
_LEN = 3 * _SPB + 1500


@pytest.fixture(scope="module")
def jax_learn_streams():
    """TpuEncoder `-l` bytes per (preset, -a, tail_mode); one encoder per
    case, so the host-tail encode reuses the full-block build."""
    out = {}
    for preset, af in _CASES:
        sig = _signal(_LEN, preset)
        enc = TpuEncoder(batch_blocks=4, tail_mode="device")
        enc.set_encode_parameter(
            _learn_param(preset, _SPB, af, jax_params.EncodeParameter))
        for mode in ("device", "host"):
            enc.tail_mode = mode
            out[(preset, af, mode)] = enc.encode_whole([sig[0], sig[1]],
                                                       _LEN)
    return out


@pytest.mark.parametrize("tail_mode", ["device", "host"])
@pytest.mark.parametrize("preset,af", _CASES)
def test_learning_bytes_equal_tpu_encoder(jax_learn_streams, preset, af,
                                          tail_mode):
    sig = _signal(_LEN, preset)
    enc = TorchEncoder(batch_blocks=4, tail_mode=tail_mode, device="cpu")
    enc.set_encode_parameter(_learn_param(preset, _SPB, af))
    data = enc.encode_whole([sig[0], sig[1]], _LEN)
    assert data == jax_learn_streams[(preset, af, tail_mode)]
    assert np.array_equal(np.stack(Decoder().decode_whole(data)), sig)
    out = TorchDecoder(device="cpu").decode_whole(data)
    assert np.array_equal(np.stack(out), sig)


def test_learning_encode_many_equals_encode_whole():
    """Five full blocks of three tracks in batches of four: the second
    batch is partial and padded, and mixes tracks."""
    lengths = [2 * _SPB + 100, 2 * _SPB, _SPB + 700]
    tracks = [_signal(n, 20 + i) for i, n in enumerate(lengths)]
    enc = TorchEncoder(batch_blocks=4, device="cpu")
    enc.set_encode_parameter(_learn_param(0, _SPB, 0))
    many = enc.encode_many([[t[0], t[1]] for t in tracks], lengths)
    for t, n, data in zip(tracks, lengths, many):
        solo = TorchEncoder(batch_blocks=4, device="cpu")
        solo.set_encode_parameter(_learn_param(0, _SPB, 0))
        assert data == solo.encode_whole([t[0], t[1]], n)
        assert np.array_equal(np.stack(Decoder().decode_whole(data)), t)


def test_cli_learning_bytes_equal_jax_cli(tmp_path):
    from linne_tpu import cli as jax_cli

    sig = _signal(2 * 10240 + 900, 8)
    wav = tmp_path / "in.wav"
    write_wav(str(wav), sig, 44100, 16)
    ours, theirs = tmp_path / "ours.lnn", tmp_path / "theirs.lnn"
    assert cli.main(["-e", "-l", "--device", "cpu", str(wav),
                     str(ours)]) == 0
    assert jax_cli.main(["-e", "-l", str(wav), str(theirs)]) == 0
    assert ours.read_bytes() == theirs.read_bytes()
    assert np.array_equal(np.stack(Decoder().decode_whole(ours.read_bytes())),
                          sig)
