"""The port's integer ops (linne_tpu_torch.ops.intops) against the JAX
reference on the CPU: bit-equal int32 results on seeded numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linne_tpu.ops import intops as J
from linne_tpu_torch.ops import intops as T


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(torch_out, jax_out):
    got = torch_out.numpy()
    want = np.asarray(jax_out)
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)


@pytest.mark.parametrize("nch", [2, 3])
def test_ms_transform(nch):
    rng = np.random.default_rng(0)
    # full int32 range: the side channel wraps like the reference
    x = rng.integers(-2**31, 2**31, (4, nch, 257)).astype(np.int32)
    _eq(T.ms_transform(_t(x)), J.ms_transform(jnp.asarray(x)))


def test_preemphasis_coefficient_and_apply():
    rng = np.random.default_rng(1)
    n = 300
    t = np.arange(n)
    x = np.stack([
        np.round(9000 * np.sin(2 * np.pi * 300 * t / 44100 * (k + 1))
                 + rng.normal(0, 50 * k + 1, n))
        for k in range(6)]).astype(np.int32).reshape(3, 2, n)
    x[0, 0] = 0                        # silent row: corr0 < 1e-6
    x[0, 1] = np.where(t % 2, 3000, -3000)  # negative ratio
    coef_t = T.preemphasis_coefficient(_t(x))
    coef_j = J.preemphasis_coefficient(jnp.asarray(x))
    _eq(coef_t, coef_j)
    assert coef_t.numpy().max() > 0
    _eq(T.preemphasis_apply(_t(x), coef_t),
        J.preemphasis_apply(jnp.asarray(x), coef_j))


def _cascade_inputs(seed, shape, order, choices):
    rng = np.random.default_rng(seed)
    x = rng.integers(-(1 << 27), 1 << 27, shape).astype(np.int32)
    coefs = rng.integers(-128, 128, shape[:-1] + (order,)).astype(np.int32)
    log2u = rng.choice([(u - 1).bit_length() for u in choices],
                       size=shape[:-1]).astype(np.int32)
    rsh = rng.integers(1, 16, shape[:-1]).astype(np.int32)
    return x, coefs, log2u, rsh


@pytest.mark.parametrize("order,n,choices", [
    (4, 64, [1, 2, 4]),                      # dense route
    (16, 128, [1, 2, 4, 8, 16]),             # dense route
    (32, 96, [1, 2, 4, 8, 16]),              # dense route, u_max < order
    (16, 100, [1, 2, 4]),                    # ragged: 8 does not divide 100
    (8, 64, [2]),                            # single choice: fixed units
])
def test_predict_cascade_layer(order, n, choices):
    x, coefs, log2u, rsh = _cascade_inputs(order + n, (3, 2, n), order,
                                           choices)
    got = T.predict_cascade_layer(_t(x), _t(coefs), _t(log2u), _t(rsh),
                                  choices)
    want = J.predict_cascade_layer(jnp.asarray(x), jnp.asarray(coefs),
                                   jnp.asarray(log2u), jnp.asarray(rsh),
                                   choices)
    _eq(got, want)


@pytest.mark.parametrize("u", [1, 2, 4, 8])
def test_predict_fixed_units(u):
    x, coefs, _l, rsh = _cascade_inputs(u, (2, 3, 70), 16, [u])
    _eq(T._predict_fixed_units(_t(x), _t(coefs), u, _t(rsh)),
        J._predict_fixed_units(jnp.asarray(x), jnp.asarray(coefs), u,
                               jnp.asarray(rsh)))


def test_normalize_to_float():
    rng = np.random.default_rng(3)
    x = rng.integers(-2**23, 2**23, (2, 50)).astype(np.int32)
    got = T.normalize_to_float(_t(x), 24, torch.float64)
    want = J.normalize_to_float(jnp.asarray(x), 24, jnp.float64)
    _eq(got, want)
