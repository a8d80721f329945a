"""The port's float analysis (linne_tpu_torch.ops.analysis) against the JAX
reference on the CPU, in float64.

Float outputs: allclose(rtol=1e-9, atol=1e-12) — both sides compute the
same formulas in float64, differing only in summation order and FFT
implementation, i.e. by a few ulps of the largest partial sum. Selections
(unit counts, quantized integers, rshifts) must be equal. Where stages
chain, the JAX stage's output is fed (via convert.to_torch) into the port's
next stage, so a rounding difference upstream cannot hide a fault
downstream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linne_tpu.ops import analysis as J
from linne_tpu_torch.convert import to_numpy, to_torch
from linne_tpu_torch.ops import analysis as T

RTOL, ATOL = 1e-9, 1e-12


def _close(torch_out, jax_out):
    got = to_numpy(torch_out)
    want = np.asarray(jax_out)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _eq(torch_out, jax_out):
    got = to_numpy(torch_out)
    want = np.asarray(jax_out)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert np.array_equal(got, want)


def _audio(seed, shape, n):
    """Audio-like normalized float signals [*shape, n]: partials plus
    noise, one row silent."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    rows = int(np.prod(shape))
    out = np.empty((rows, n))
    for r in range(rows):
        f = 200.0 * (r + 1)
        out[r] = (0.3 * np.sin(2 * np.pi * f * t / 44100)
                  + 0.1 * np.sin(2 * np.pi * 3.1 * f * t / 44100)
                  + rng.normal(0, 0.01 * (r + 1), n))
    out[0] = 0.0
    return out.reshape(tuple(shape) + (n,))


@pytest.mark.parametrize("num_lags", [3, 17, 33, 129])
def test_autocorrelation_routes(num_lags):
    x = _audio(num_lags, (2, 3), 512)
    _close(T.autocorrelation(torch.from_numpy(x), num_lags),
           J.autocorrelation(jnp.asarray(x), num_lags))


@pytest.mark.parametrize("order", [4, 32])
def test_levinson_durbin_with_parcor(order):
    x = _audio(order, (2, 2), 400)
    ac = np.asarray(J.autocorrelation(jnp.asarray(x), order + 1))
    ac_t = to_torch(ac)
    before = ac_t.clone()
    lpc_t, parcor_t = T.levinson_durbin(ac_t, order, with_parcor=True)
    lpc_j, parcor_j = J.levinson_durbin(jnp.asarray(ac), order,
                                        with_parcor=True)
    _close(lpc_t, lpc_j)
    _close(parcor_t, parcor_j)
    assert torch.equal(ac_t, before)  # the caller's tensor is not written
    assert np.all(lpc_t.numpy()[0, 0] == 0)  # silent row


@pytest.mark.parametrize("num_units,npu", [(1, 4), (4, 8), (2, 32),
                                           (64, 4)])
def test_fit_unit_lpc_and_unit_forward(num_units, npu):
    n = 256
    x = _audio(npu, (2, 2), n)
    ridge = np.asarray([0.0, 1.0 / 512.0]).reshape(2, 1, 1, 1)
    xr = np.broadcast_to(x[None], (2,) + x.shape).copy()
    params_j = J.fit_unit_lpc(jnp.asarray(xr), num_units, npu,
                              jnp.asarray(ridge))
    params_t = T.fit_unit_lpc(torch.from_numpy(xr), num_units, npu,
                              torch.from_numpy(ridge))
    _close(params_t, params_j)
    # unit_forward on the JAX coefficients (scan below 32 taps, FFT above)
    res_j = J.unit_forward(jnp.asarray(xr), params_j, num_units)
    res_t = T.unit_forward(torch.from_numpy(xr),
                           to_torch(np.asarray(params_j)), num_units)
    _close(res_t, res_j)


def test_fit_unit_lpc_degenerate_split_is_zero():
    x = torch.from_numpy(_audio(9, (1,), 64))
    out = T.fit_unit_lpc(x, 32, 4, 0.0)  # ns = 2 < npu = 4
    assert out.shape == (1, 32, 4) and not out.any()
    _eq(out, J.fit_unit_lpc(jnp.asarray(x.numpy()), 32, 4, 0.0))


@pytest.mark.parametrize("order,n", [(2, 2048), (128, 2560), (16, 100),
                                     (64, 96)])
def test_candidate_units(order, n):
    assert T.candidate_units(order, n) == J.candidate_units(order, n)


_CHAIN_ORDERS = (4, 128, 16)  # preset 7's layers


@pytest.fixture(scope="module")
def jax_chain():
    """Three layers of a preset-7 network fitted by the (jitted) JAX
    reference: [(input [R, B, C, n], (log2u, params, residual, loss))]."""
    fit = jax.jit(J.fit_layer, static_argnums=1)
    x = _audio(5, (3, 2), 512)
    ridge = jnp.asarray(np.asarray([0.0, 1.0 / 2048.0]).reshape(2, 1, 1, 1))
    xr = np.broadcast_to(x[None], (2,) + x.shape).copy()
    chain = []
    for order in _CHAIN_ORDERS:
        out = tuple(np.asarray(a) for a in fit(jnp.asarray(xr), order, ridge))
        chain.append((xr, out))
        xr = out[2]
    return chain


@pytest.mark.parametrize("layer", range(len(_CHAIN_ORDERS)))
def test_fit_layer_chain(jax_chain, layer):
    """Each port layer takes the JAX layer's input (the previous JAX
    layer's residual). Unit choices equal, floats close."""
    xr, out_j = jax_chain[layer]
    ridge = torch.tensor([0.0, 1.0 / 2048.0],
                         dtype=torch.float64).reshape(2, 1, 1, 1)
    out_t = T.fit_layer(to_torch(xr), _CHAIN_ORDERS[layer], ridge)
    _eq(out_t[0], out_j[0])                      # log2 units
    for got, want in zip(out_t[1:], out_j[1:]):  # params, res, loss
        _close(got, want)


@pytest.mark.parametrize("layer", range(len(_CHAIN_ORDERS)))
def test_quantize_chained_from_fit(jax_chain, layer):
    """Quantizer on the JAX fit's coefficients: equal ints and rshifts."""
    params = jax_chain[layer][1][1]
    q_t, rs_t = T.quantize_coefficients(to_torch(params))
    q_j, rs_j = jax.jit(J.quantize_coefficients)(jnp.asarray(params))
    _eq(q_t, q_j)
    _eq(rs_t, rs_j)


def test_fit_network():
    x = _audio(6, (2, 2), 256)
    orders, ridges = (4, 32, 8), (0.0, 1.0 / 512.0)
    log2u_j, params_j = jax.jit(J.fit_network, static_argnums=(1, 2))(
        jnp.asarray(x), orders, ridges)
    log2u_t, params_t = T.fit_network(torch.from_numpy(x), orders, ridges)
    for lt, lj in zip(log2u_t, log2u_j):
        _eq(lt, lj)
    for pt, pj in zip(params_t, params_j):
        _close(pt, pj)


def test_quantize_coefficients():
    rng = np.random.default_rng(11)
    coefs = rng.normal(0, 0.7, (4, 3, 20))
    coefs[0, 0] = 0.0                     # is_zero row -> rshift = nbits
    coefs[0, 1] = 1e-4
    coefs[1, 0] *= 40.0                   # clipped to rshift 1
    coefs[1, 1, :] = 0.5                  # exact halves: away from zero
    coefs[1, 2, :] = -0.375
    q_t, rs_t = T.quantize_coefficients(torch.from_numpy(coefs), 8)
    q_j, rs_j = J.quantize_coefficients(jnp.asarray(coefs), 8)
    _eq(q_t, q_j)
    _eq(rs_t, rs_j)


@pytest.mark.parametrize("bps", [16, 24])
def test_estimate_code_length(bps):
    x = _audio(bps, (3, 2), 640)
    want = jax.jit(J.estimate_code_length, static_argnums=(1, 2))(
        jnp.asarray(x), 4, bps)
    _close(T.estimate_code_length(torch.from_numpy(x), 4, bps), want)


def test_frexp_matches_jnp():
    v = np.asarray([1.0, 0.75, 0.5, 3.0, 1e-3, 127.9, 2.0 ** -7])
    m_t, e_t = torch.frexp(torch.from_numpy(v))
    m_j, e_j = jnp.frexp(jnp.asarray(v))
    _eq(m_t, m_j)
    _eq(e_t, e_j)


def test_argmin_takes_first_minimum():
    """Ridge and Rice-order selection rely on first-index ties."""
    loss = torch.tensor([[3.0, 1.0], [1.0, 1.0], [1.0, 0.5], [2.0, 0.5]])
    assert torch.argmin(loss, dim=0).tolist() == [1, 2]
    ints = torch.tensor([7, 2, 2, 9, 2], dtype=torch.int64)
    assert int(torch.argmin(ints)) == 1
