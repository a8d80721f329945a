"""The matrix-unit routes of the port's analysis (linne_tpu_torch/ops/
analysis.py: `_autocorr_matmul`, `_unit_forward_matmul` and their gates)
against the JAX package's on the CPU, in float64.

The products sum in another order than the lag/FFT routes and than XLA,
so floats are held with a tolerance (the reference's own in
tests/test_analysis_routes.py); which route a call takes is held exactly,
at every shape of a preset-7 encode and at the byte-budget cut-offs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linne_tpu import ops as _jax_ops  # noqa: F401  (enables x64)
from linne_tpu.ops import analysis as J
from linne_tpu_torch.ops import analysis as T
from linne_tpu_torch.presets import PRESETS


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def routes(monkeypatch):
    """Force both packages onto the matmul routes (or off them)."""
    def force(value):
        monkeypatch.setattr(J, "_MATMUL_ROUTES_OVERRIDE", value)
        monkeypatch.setattr(T, "_MATMUL_ROUTES_OVERRIDE", value)
    return force


def _sig(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape)


@pytest.mark.parametrize("shape,num_lags", [
    ((2, 3, 2, 10240), 129), ((2, 3, 2, 10240), 65), ((2, 3, 2, 10240), 33),
    ((2, 3, 2, 10240), 9), ((2, 2, 6000), 129), ((2, 2, 5096), 129)])
def test_autocorr_matmul_matches_jax(shape, num_lags):
    x = _sig(shape, num_lags)
    got = T._autocorr_matmul(torch.from_numpy(x), num_lags).numpy()
    want = np.asarray(jax.jit(J._autocorr_matmul, static_argnums=1)(
        jnp.asarray(x), num_lags))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-8)


@pytest.mark.parametrize("u,npu", [(1, 128), (2, 64), (4, 32), (1, 64),
                                   (8, 16), (16, 8)])
def test_unit_forward_matmul_matches_jax(u, npu):
    x = _sig((2, 3, 2, 10240), 0)
    p = np.random.default_rng(1).normal(0, 0.05, x.shape[:-1] + (u, npu))
    got = T._unit_forward_matmul(torch.from_numpy(x), torch.from_numpy(p),
                                 u).numpy()
    want = np.asarray(jax.jit(J._unit_forward_matmul, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(p), u))
    np.testing.assert_allclose(got, want, atol=1e-11)
    fft = T._unit_forward_fft(torch.from_numpy(x), torch.from_numpy(p), u)
    np.testing.assert_allclose(got, fft.numpy(), atol=1e-11)


def _preset7_shapes():
    """(kind, signal shape, lags or (units, taps)) of every autocorrelation
    and unit_forward call of a preset-7 encode at block 10240: the
    estimator, the ridge sweep of each layer at each batch cover, the -a
    refits and the -l trainer's dense cascade."""
    preset = PRESETS[7]
    n, ridges, C = 10240, len(preset.ridge_terms), 2
    out = []
    for B in (8, 16, 32, 64):
        out.append(("ac", (B, C, n), preset.layer_num_params[0] + 1))
        for order in preset.layer_num_params:
            units = T.candidate_units(order, n)
            for lead in ((ridges, B, C), (B, C)):
                for u in units:
                    out.append(("ac", lead + (u, n // u), order // u + 1))
                    out.append(("fwd", lead + (n,), (u, order // u)))
            out.append(("fwd", (B, C, n), (max(units), order)))
    return out


def _cutoff_shapes():
    """Shapes on both sides of the byte budget: the largest row count whose
    G (or H) tensor fits, and one row more."""
    out = []
    budget = T._MATMUL_BYTES_BUDGET
    for lags in (9, 17, 129):
        rows = budget // (T._CHUNK * (T._CHUNK + lags - 1) * 4)
        out += [("ac", (rows, 256), lags), ("ac", (rows + 1, 256), lags)]
    for u, npu in ((1, 128), (16, 8), (8, 16)):
        rows = budget // (u * (T._CHUNK + npu - 1) * T._CHUNK * 4)
        out += [("fwd", (rows, 256), (u, npu)),
                ("fwd", (rows + 1, 256), (u, npu))]
    return out


def _route_of(mod, kind, shape, arg, run):
    """The route `mod` takes for the call: spies on its matmul and FFT
    functions see which one is entered."""
    seen = []
    names = (["_autocorr_matmul"] if kind == "ac"
             else ["_unit_forward_matmul", "_unit_forward_fft"])
    real = {name: getattr(mod, name) for name in names}

    def spy(name):
        def call(*args):
            seen.append(name)
            return real[name](*args)
        return call

    for name in names:
        setattr(mod, name, spy(name))
    try:
        run(kind, shape, arg)
    finally:
        for name in names:
            setattr(mod, name, real[name])
    if seen:
        return seen[0]
    if kind == "ac":
        return "fft" if arg >= T._FFT_AUTOCORR_MIN_LAGS else "lag"
    return "lag"


def _run_jax(kind, shape, arg):
    spec = jax.ShapeDtypeStruct(shape, jnp.float64)
    if kind == "ac":
        jax.eval_shape(lambda x: J.autocorrelation(x, arg), spec)
    else:
        u, npu = arg
        pspec = jax.ShapeDtypeStruct(shape[:-1] + (u, npu), jnp.float64)
        jax.eval_shape(lambda x, p: J.unit_forward(x, p, u), spec, pspec)


def _run_torch(kind, shape, arg):
    x = torch.empty(shape, dtype=torch.float64, device="meta")
    if kind == "ac":
        T.autocorrelation(x, arg)
    else:
        u, npu = arg
        p = torch.empty(shape[:-1] + (u, npu), dtype=torch.float64,
                        device="meta")
        T.unit_forward(x, p, u)


@pytest.mark.parametrize("override", [True, False])
def test_routes_match_jax_at_every_preset7_shape(routes, override):
    """Under the override, each call takes JAX's route (meta tensors and
    jax.eval_shape: only the gates run); with the override True the matmul
    routes are taken where JAX takes them, budget cut-offs included."""
    routes(override)
    seen = set()
    for kind, shape, arg in _preset7_shapes() + _cutoff_shapes():
        want = _route_of(J, kind, shape, arg, _run_jax)
        got = _route_of(T, kind, shape, arg, _run_torch)
        assert got == want, (kind, shape, arg)
        seen.add(got)
    if override:
        assert {"_autocorr_matmul", "_unit_forward_matmul", "lag",
                "fft", "_unit_forward_fft"} <= seen
    else:
        assert not any(s.endswith("matmul") for s in seen)


def test_default_route_follows_the_device(routes):
    """Without the override the CPU keeps the lag/FFT routes (the card's
    default is held in tests/test_torch_cuda.py); the override wins."""
    x = torch.zeros(4, 64)
    routes(None)
    assert not T._use_matmul_routes(x)
    routes(True)
    assert T._use_matmul_routes(x)
    routes(False)
    assert not T._use_matmul_routes(x)


def test_fit_layer_matmul_routes_match_jax(routes):
    """fit_layer at order 128 under the override: JAX's unit-count
    selections exactly, its coefficients within 1e-10; the lag/FFT routes
    select the same units."""
    routes(True)
    x = _sig((2, 4, 2, 10240), 5)
    got = T.fit_layer(torch.from_numpy(x), 128, 0.0)
    # a fresh function: the override is read while tracing, so no trace
    # cached under the other route may be reused
    want = jax.jit(lambda v: J.fit_layer(v, 128, 0.0))(jnp.asarray(x))
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-10)
    routes(False)
    plain = T.fit_layer(torch.from_numpy(x), 128, 0.0)
    assert np.array_equal(plain[0].numpy(), got[0].numpy())
    np.testing.assert_allclose(plain[1].numpy(), got[1].numpy(), atol=1e-10)


def test_train_fn_matmul_route_matches_lag_fft(routes):
    """The -l trainer differentiates through the routes: on the matrix-unit
    route (the order-32 layer's dense cascade takes it) 20 iterations give
    the lag/FFT route's coefficients."""
    from linne_tpu_torch.constants import (
        TRAINING_LEARNING_RATE,
        TRAINING_LOSS_EPSILON,
    )
    from linne_tpu_torch.ops import training

    orders, n = [2, 32], 1280
    units = [T.candidate_units(o, n) for o in orders]
    rng = np.random.default_rng(4)
    sig = torch.from_numpy(rng.normal(0, 0.1, (5, 2, n)))
    params = [torch.from_numpy(rng.normal(0, 0.1, (5, 2, o))) for o in orders]
    log2u = [torch.from_numpy(rng.choice([int(np.log2(u)) for u in c],
                                         (5, 2)).astype(np.int32))
             for c in units]
    # the first 20 iterations of the encoder's trainer
    train = training.make_train_fn(
        orders, units, 20, TRAINING_LEARNING_RATE, TRAINING_LOSS_EPSILON)
    out = {}
    for route in (True, False):
        routes(route)
        out[route] = train(sig, params, log2u)
    assert out[True][1] == out[False][1]
    for a, b in zip(out[True][0], out[False][0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-8,
                                   atol=1e-15)
