"""The plain versions of the encode's three serial loops against the JAX
package on the CPU, at the edge shapes of their CUDA kernels
(linne_tpu_torch/ops/analysis_scans.py, csrc/analysis_scans.cu), and the
kernels' wrappers: their argument checks, and that a CPU tensor through
the public function takes the plain version. The kernels themselves run
only on a card (tests/test_torch_cuda.py, `-k scans`).

Tolerances. The quantizer and the predict cascade are bit-equal (the
quantizer's float steps are elementwise, each rounded on its own; the
cascade is int32 arithmetic). The recursion sums a . s in another order
than XLA does, so its floats are allclose at rtol 1e-9, atol 1e-12 (a few
ulps of the largest partial sum, as tests/test_torch_analysis.py holds
it) on rows that the data determine: the rows here carry a ridge, so the
prediction error never falls below ~1/513 of lag 0. Silent and guard rows
are equal exactly, NaN and +-Inf in the same places.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import REPO_ROOT
from linne_tpu.exact import lpc as JL
from linne_tpu.ops import analysis as JA
from linne_tpu.ops import intops as JI
from linne_tpu_torch.ops import analysis as A
from linne_tpu_torch.ops import analysis_scans as AS
from linne_tpu_torch.ops import intops as I
from linne_tpu_torch.ops import rice_search as R
from linne_tpu_torch.ops.windows import (WINDOW_RECTANGULAR, WINDOW_SIN,
                                         WINDOW_WELCH, window_weights)
from linne_tpu_torch.presets import PRESETS
from torch_levinson_model import lanes_for, levinson_schur

RTOL, ATOL = 1e-9, 1e-12


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int64) if a.dtype == np.float64 else a


# -- levinson_durbin ---------------------------------------------------------


def levinson_rows(order, seed):
    """[10, order + 1] autocorrelations with a ridge: rows 0-4 noise and a
    tone; row 5 silent (|ac0| < FLT_EPSILON); row 6 [1, 1, ...] (ek exactly
    0 after the first step: the guard); row 7 a NaN lag; row 8 +Inf lag 1;
    row 9 -Inf at the last lag."""
    rng = np.random.default_rng(seed)
    n = 4 * order + 16
    t = np.arange(n)
    x = (rng.normal(0, 0.05, (10, n))
         + 0.4 * np.sin(2 * np.pi * rng.uniform(0.01, 0.2, (10, 1)) * t))
    ac = np.stack([np.sum(x[:, : n - lag] * x[:, lag:], axis=-1)
                   for lag in range(order + 1)], axis=-1)
    ac[:, 0] *= 1.0 + 1.0 / 512.0
    ac[5] *= 1e-12
    ac[6] = 1.0
    ac[7, min(order, 3)] = np.nan
    ac[8, 1] = np.inf
    ac[9, order] = -np.inf
    return ac


def check_levinson(got, want):
    """got, want: (lpc, parcor) as numpy arrays of rows from
    levinson_rows."""
    for g, w in zip(got, want):
        assert np.array_equal(np.isnan(g), np.isnan(w))
        assert np.array_equal(np.isinf(g), np.isinf(w))
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        assert np.array_equal(_bits(g[5:7]), _bits(w[5:7]))
        assert not np.any(g[5])


@pytest.mark.parametrize("order", [1, 2, 31, 32, 33, 64, 127, 128])
def test_levinson_plain_matches_jax(order):
    ac = levinson_rows(order, order)
    got = A._levinson_durbin_plain(_t(ac), order, with_parcor=True)
    want = jax.jit(JA.levinson_durbin, static_argnums=(1, 2))(
        jnp.asarray(ac), order, True)
    check_levinson([t.numpy() for t in got], [np.asarray(w) for w in want])


@pytest.mark.parametrize("order", [1, 32, 33, 64, 128])
def test_levinson_schur_model_matches_jax(order):
    """The kernel's order of operations (tests/torch_levinson_model.py: the
    numerator in Schur form, F_k[k+2] + gamma_k B_k[k+1], with the NaN rule
    in place of the tail) against the JAX package: the same tolerance and
    special rows as the plain version, and r0 = +Inf appended (every lpc
    value NaN)."""
    ac = np.concatenate([levinson_rows(order, order),
                         np.full((1, order + 1), 0.5)])
    ac[10, 0] = np.inf
    got = levinson_schur(_t(ac), order, with_parcor=True)
    want = jax.jit(JA.levinson_durbin, static_argnums=(1, 2))(
        jnp.asarray(ac), order, True)
    check_levinson([t.numpy() for t in got], [np.asarray(w) for w in want])
    assert np.isnan(got[0][10].numpy()).all() and np.isnan(got[1][10, 0])
    assert lanes_for(order) == AS.levinson_lanes(order)


# -- quantize_coefficients ---------------------------------------------------


def quantize_rows(order, seed, tie_shift=5):
    """[8, order] float64 coefficients: seeded rows at several scales; an
    all-zero row; rows at and just above the 2^-(nbits-1) threshold; exact
    .5 ties after scaling by 2^tie_shift; rows whose error feedback clamps
    at -128 and 127 at the same shift.

    Against the JAX package the shift is 5: XLA's float64 exp2 on the CPU
    misses 2^k by an ulp or a few at k = 3, 4, 6-9 and 12-15 (2^7 comes out
    as 127.99999999999997), which turns a tie there into a rounding below
    it, where torch.exp2 gives 2^k exactly. At k = 1, 2, 5, 10, 11 both are
    exact."""
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 0.3, (8, order)) * np.array(
        [1e-2, 1.0, 4.0, 0.0, 1.0, 1.0, 1.0, 1.0])[:, None]
    c[4] = 2.0 ** -7                               # max |c| == threshold
    c[5] = np.where(np.arange(order) % 2, -1, 1) * 2.0 ** -7 * (1 + 2e-16)
    # max |c| = 3 * 2^-(tie_shift - 5) sets the shift; whole and half
    # steps of 2^-tie_shift make the error feedback meet exact .5 ties
    step = 2.0 ** -tie_shift
    c[6] = (rng.integers(-64, 64, order)
            + 0.5 * rng.integers(0, 2, order)) * step
    c[6, 0] = 96 * step
    c[7] = np.where(np.arange(order) % 3, 127.49, -127.87) * step
    return c


@pytest.mark.parametrize("order", [1, 2, 4, 16, 31, 32, 33, 64, 128])
def test_quantize_plain_matches_jax(order):
    c = quantize_rows(order, order)
    q, rs = A._quantize_coefficients_plain(_t(c), 8)
    qj, rsj = jax.jit(JA.quantize_coefficients, static_argnums=1)(
        jnp.asarray(c), 8)
    assert np.array_equal(q.numpy(), np.asarray(qj))
    assert np.array_equal(rs.numpy(), np.asarray(rsj))
    assert rs[3] == 8 and not q[3].any()           # the all-zero row
    assert rs[4] == 8 and not q[4].any()           # at the threshold
    assert rs[5] != 8 and q[5].any()               # just above it
    assert rs[6] == rs[7] == 5 and q[7].abs().min() >= 126  # near the cap


@pytest.mark.parametrize("shift", [3, 7, 12])
def test_quantize_plain_ties_match_host_oracle(shift):
    """Exact .5 ties at rshift 3, 7 and 12, where XLA's CPU exp2 is
    inexact, held bit for bit to the JAX package's host quantizer
    (linne_tpu/exact/lpc.py), which scales by math.pow(2.0, rshift)."""
    order = 32
    c = quantize_rows(order, shift, tie_shift=shift)
    q, rs = A._quantize_coefficients_plain(_t(c), 8)
    for r in range(c.shape[0]):
        want_q, want_rs = JL.quantize_coefficients(c[r], order, 8)
        assert np.array_equal(q[r].numpy(), want_q), r
        assert int(rs[r]) == want_rs, r
    assert rs[6] == rs[7] == shift and q[7].abs().min() >= 126
    ties = c[6] * 2.0 ** shift
    assert np.any(ties != np.round(ties))  # the row holds .5 steps


def grouped_rows(order, rows, seed, tie_shift):
    """[rows, order] coefficients: quantize_rows blocks of 8 (seeds seed,
    seed + 1, ...) cut to `rows`; with rows = 1 the tie row alone."""
    if rows == 1:
        return quantize_rows(order, seed, tie_shift)[6:7]
    blocks = [quantize_rows(order, seed + b, tie_shift)
              for b in range(-(-rows // 8))]
    return np.concatenate(blocks)[:rows]


_GROUP_ORDERS = (4, 128, 16)  # preset 7's layers, in its order


@pytest.mark.parametrize("tie_shift", [1, 2, 5, 10, 11])
@pytest.mark.parametrize("rows", [1, 37, 128])
def test_quantize_layers_plain_matches_jax(rows, tie_shift):
    """The grouped plain version (the grouped kernel's) over preset 7's
    layers, bit for bit the JAX package's quantize_coefficients run a
    layer, with .5 ties at shifts where XLA's CPU exp2 is exact."""
    coefs = [grouped_rows(o, rows, 10 * o + tie_shift, tie_shift)
             for o in _GROUP_ORDERS]
    q, rs = A._quantize_layers_plain([_t(c) for c in coefs], 8)
    assert q.shape == (rows, sum(_GROUP_ORDERS)) and rs.shape == (3, rows)
    col = 0
    for li, c in enumerate(coefs):
        qj, rsj = jax.jit(JA.quantize_coefficients, static_argnums=1)(
            jnp.asarray(c), 8)
        o = c.shape[1]
        assert np.array_equal(q[:, col:col + o].numpy(), np.asarray(qj))
        assert np.array_equal(rs[li].numpy(), np.asarray(rsj))
        col += o
    tie_row = 0 if rows == 1 else 6
    assert (rs[:, tie_row] == tie_shift).all()


@pytest.mark.parametrize("shift", [3, 7, 12])
def test_quantize_layers_plain_ties_match_host_oracle(shift):
    """The grouped plain version at .5 ties at rshift 3, 7 and 12 (where
    XLA's CPU exp2 is not exact), bit for bit the JAX package's host
    quantizer a row and a layer."""
    coefs = [grouped_rows(o, 37, o + shift, shift) for o in _GROUP_ORDERS]
    q, rs = A._quantize_layers_plain([_t(c) for c in coefs], 8)
    col = 0
    for li, c in enumerate(coefs):
        o = c.shape[1]
        for r in range(c.shape[0]):
            want_q, want_rs = JL.quantize_coefficients(c[r], o, 8)
            assert np.array_equal(q[r, col:col + o].numpy(), want_q), (li, r)
            assert int(rs[li, r]) == want_rs, (li, r)
        col += o
    assert (rs[:, 6] == shift).all()


def _kernel_form(coefs, nbits, exact):
    """csrc/analysis_scans.cu:quantize_kernel's arithmetic, as torch ops on
    the CPU: the chain keeps only s and the error fed back (y = |s| + 0.5
    for both signs of s, the clamp decided by comparing y with qmax for s
    >= 0 or qmax + 1 for s < 0, qerr from the held or the fed-back value);
    the ints and the round margin come from the stored sums afterwards
    (fmin dropping nothing there: no NaN reaches it), the NaN of s kept.
    Returns (q [rows, order] float64, rshift; round_margin, scale_margin
    when exact)."""
    qmax = float(1 << (nbits - 1))
    lowthr = 2.0 ** -(nbits - 1)
    a = coefs.abs()
    if exact:
        max_abs = torch.where(a == a, a, 0.0).amax(-1)
    else:
        max_abs = a.amax(-1)
    low = max_abs <= lowthr
    if exact:
        e = torch.frexp(max_abs)[1].long()
        rs = (nbits - 1) - e
        em1 = e - 1
    else:
        e = torch.frexp(torch.where(low, 1.0, max_abs))[1].long()
        rs = torch.clamp((nbits - 1) - e, 1, 15)
    scale = torch.tensor([2.0 ** int(v) for v in rs.clamp(-1074, 1023)],
                         dtype=torch.float64)
    p = coefs * scale[:, None]
    if exact:
        p = torch.where(p == p, p, 0.0)
        e2 = [torch.tensor([2.0 ** int(v) for v in x.clamp(-1074, 1023)],
                           dtype=torch.float64) for x in (em1, e)]
        fm = torch.minimum(max_abs - e2[0], e2[1] - max_abs)
        fm = fm / torch.clamp(max_abs, min=1e-300)
        lm = (max_abs - lowthr).abs() / lowthr
        scale_m = torch.minimum(torch.where(low, np.inf, fm), lm)
    qerr = torch.zeros_like(max_abs)
    sums = torch.empty_like(coefs)
    for t in range(coefs.shape[1] - 1, -1, -1):
        s = qerr + p[:, t]
        sums[:, t] = s
        pos = s >= 0.0
        y = s.abs() + 0.5
        f = torch.floor(y)
        binds = y >= torch.where(pos, qmax, qmax + 1.0)
        held = torch.where(pos, s - (qmax - 1.0), s + qmax)
        qerr = torch.where(binds, held, torch.where(pos, s - f, s + f))
    y = sums.abs() + 0.5
    f = torch.floor(y)
    d = (y - torch.round(y)).abs()
    rmin = torch.where(d.isnan().any(-1), np.nan, d.nan_to_num(np.inf)
                       .amin(-1))
    v = torch.where(sums >= 0.0, torch.fmin(f, torch.tensor(qmax - 1.0)),
                    -torch.fmin(f, torch.tensor(qmax)))
    q = torch.where(sums == sums, v, sums)
    q = torch.where(low[:, None], 0.0, q)
    rs = torch.where(low, nbits, rs).to(torch.int32)
    if not exact:
        return q, rs
    return q, rs, torch.where(low, np.inf, rmin), scale_m


@pytest.mark.parametrize("order", [1, 5, 32, 128])
def test_quantize_kernel_form_matches_plain_versions(order):
    """The kernel's form of a tap gives both plain versions' bits (ints,
    rshift, both margins) on the edge rows: thresholds, exact .5 ties at
    shifts 3, 7, 12, the +-128 clamp, -0.0 taps, and on the exact
    variant NaN coefficients and +-Inf of one sign in a row."""
    from linne_tpu_torch.ops import exact_device as ED

    for shift in (3, 7, 12):
        c = _t(quantize_rows(order, order + shift, tie_shift=shift))
        c[0, ::2] = -0.0
        q, rs = _kernel_form(c, 8, exact=False)
        want_q, want_rs = A._quantize_coefficients_plain(c, 8)
        assert torch.equal(q.to(torch.int32), want_q)
        assert torch.equal(rs, want_rs)
        extra = c[:4].clone()
        extra[0, order // 2] = np.nan
        extra[1, 0] = np.inf
        extra[2, -1] = -np.inf
        extra[3] = 2.0 ** (shift - 9)  # max |c| at a power of two
        cx = torch.cat([c, extra])
        got = _kernel_form(cx, 8, exact=True)
        want = ED._quantize_layer_plain(cx, 8)
        assert torch.equal(got[0].to(torch.int32), want[0])
        for g, w in zip(got[1:], want[1:]):
            assert torch.equal(g.view(torch.int64) if g.is_floating_point()
                               else g,
                               w.view(torch.int64) if w.is_floating_point()
                               else w)


# -- _predict_dense ----------------------------------------------------------


def _layer_choices():
    """(order, unit choices) of every layer of presets 0-7 at a length
    that every choice divides."""
    seen = []
    for p in PRESETS:
        for order in p.layer_num_params:
            entry = (order, A.candidate_units(order, 256))
            if entry not in seen:
                seen.append(entry)
    return seen


def predict_inputs(order, choices, n, seed):
    """[len(choices) * 2, n] rows: two rows at each log2u of the choices,
    samples and coefficients over the whole int32 range (the sums wrap),
    rshift 1..15 with 8 among them."""
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
    return (x.astype(np.int32), c.astype(np.int32), log2u.astype(np.int32),
            rsh.astype(np.int32))


@pytest.mark.parametrize("order,choices", _layer_choices())
def test_predict_dense_plain_matches_jax(order, choices):
    x, c, log2u, rsh = predict_inputs(order, choices, 256, order)
    got = I._predict_dense_plain(_t(x), _t(c), _t(log2u), _t(rsh),
                                 max(choices))
    want = jax.jit(JI._predict_dense, static_argnums=4)(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(log2u), jnp.asarray(rsh),
        max(choices))
    assert np.array_equal(got.numpy(), np.asarray(want))


# -- unit_residual_select: the residual pass of a layer's unit sweep --------


def _old_fit_unit_lpc(signal, num_units, order_per_unit, regular_term):
    """fit_unit_lpc as it was before its autocorrelation had a kernel: the
    Welch window a unit, `autocorrelation`, the ridge, the recursion."""
    n = signal.shape[-1]
    ns = n // num_units
    seg = signal.reshape(tuple(signal.shape[:-1]) + (num_units, ns))
    windowed = seg * _t(window_weights(WINDOW_WELCH, ns))
    ac = A.autocorrelation(windowed, order_per_unit + 1)
    ridge = 1.0 + torch.as_tensor(regular_term, dtype=signal.dtype)
    ac = torch.cat([(ac[..., 0] * ridge).unsqueeze(-1), ac[..., 1:]], dim=-1)
    lpc = A.levinson_durbin(ac, order_per_unit)
    if ns < order_per_unit:
        lpc = torch.zeros_like(lpc)
    return torch.flip(lpc, [-1])


def _old_fit_layer(signal, order, regular_term):
    """fit_layer as it was before its residual pass and its
    autocorrelation had kernels: each candidate fitted, run and folded in
    one loop."""
    n = signal.shape[-1]
    best_loss = best_flat = best_res = best_log2u = None
    for u in A.candidate_units(order, n):
        params = _old_fit_unit_lpc(signal, u, order // u, regular_term)
        res = A.unit_forward(signal, params, u)
        loss = torch.sum(torch.abs(res[..., 1:]), dim=-1) / n
        flat = params.reshape(tuple(params.shape[:-2]) + (order,))
        log2u = torch.full(loss.shape, (u - 1).bit_length(),
                           dtype=torch.int32, device=signal.device)
        if best_loss is None:
            best_loss, best_flat, best_res, best_log2u = (
                loss, flat, res, log2u)
        else:
            better = loss < best_loss
            best_loss = torch.where(better, loss, best_loss)
            best_flat = torch.where(better.unsqueeze(-1), flat, best_flat)
            best_res = torch.where(better.unsqueeze(-1), res, best_res)
            best_log2u = torch.where(better, log2u, best_log2u)
    return best_log2u, best_flat, best_res, best_loss


def _ridge_signal(ridges, n, seed):
    """[ridges, 2, 2, n] expanded over the ridges (as pre_stage gives the
    first layer), noise and a tone, and its ridge terms [ridges, 1, 1, 1];
    block 0 channel 0 all zero."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = (rng.normal(0, 0.02, (2, 2, n))
         + 0.3 * np.sin(2 * np.pi * rng.uniform(0.005, 0.1, (2, 2, 1)) * t))
    x[0, 0] = 0.0
    sig = _t(x).unsqueeze(0).expand((ridges, 2, 2, n))
    rv = _t(np.array([0.0, 2.0 ** -11, 2.0 ** -9, 2.0 ** -7][:ridges])
            ).reshape(ridges, 1, 1, 1)
    return sig, rv


@pytest.mark.parametrize("order", [2, 4, 16, 32, 128])
def test_unit_residual_plain_gives_old_fit_layer(order):
    """fit_layer on the CPU (every candidate fitted, then
    `_unit_residual_select_plain`) gives the outputs of the loop it
    replaced, bit for bit, over a ridge axis."""
    sig, rv = _ridge_signal(4, 2048, order)
    got = A.fit_layer(sig, order, rv)
    want = _old_fit_layer(sig, order, rv)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(_bits(g.numpy()), _bits(w.numpy()))
    assert torch.all(got[3][:, 0, 0] == 0) and torch.all(got[0][:, 0, 0] == 0)


def _candidates(order, n, rows, seed):
    rng = np.random.default_rng(seed)
    units = A.candidate_units(order, n)
    x = _t(rng.normal(0, 0.3, (rows, n)))
    params = [_t(rng.normal(0, 0.05, (rows, u, order // u))) for u in units]
    return x, params, units


def test_unit_residual_plain_first_minimum_on_ties():
    """Candidates with equal residuals have equal losses: the first of
    them wins, in the order given, ahead of every later candidate."""
    x, params, units = _candidates(32, 512, 3, 1)
    for p in params:
        p[0] = 0.0  # row 0: every candidate's residual is the signal
    params[1][1] = 0.0
    params[3][1] = 0.0  # row 1: candidates 1 and 3 tie
    params[0][1] = 1.0  # and candidate 0 is far worse
    log2u, flat, res, loss = A.unit_residual_select(x, params, units)
    assert log2u[0] == 0 and log2u[1] == 1
    assert torch.equal(res[:2], x[:2])
    assert torch.equal(flat[1], params[1][1].reshape(-1))
    assert torch.equal(loss[:2], torch.sum(torch.abs(x[:2, 1:]), -1) / 512)


def test_unit_residual_plain_nan_first_candidate():
    """A NaN loss never wins and, first, is never replaced: row 0's first
    candidate is NaN (the pick stays on it), row 1's second (the first
    finite one wins over it)."""
    x, params, units = _candidates(16, 256, 2, 2)
    params[0][0, 0, 3] = float("nan")
    params[1][1, 1, 0] = float("nan")
    params[0][1] = 1.0  # the first candidate loses to all but the NaN one
    log2u, flat, res, loss = A.unit_residual_select(x, params, units)
    assert log2u[0] == 0 and torch.isnan(loss[0])
    assert torch.isnan(flat[0, 3]) and torch.isnan(res[0, -1])
    assert log2u[1] not in (0, 1) and torch.isfinite(loss[1])


def test_unit_residual_plain_silent_row():
    """An all-zero row: every residual 0, loss 0, the first candidate."""
    x, params, units = _candidates(128, 1024, 2, 3)
    x[1] = 0.0
    log2u, _, res, loss = A.unit_residual_select(x, params, units)
    assert log2u[1] == 0 and loss[1] == 0 and not torch.any(res[1])
    assert np.array_equal(_bits(res[1].numpy()), np.zeros(1024, np.int64))


def test_unit_residual_plain_degenerate_split():
    """A split with fewer samples a unit than taps: fit_unit_lpc gives it
    zero coefficients, its residual is the signal, and its loss competes
    as any other's."""
    rng = np.random.default_rng(4)
    n, order = 64, 128
    x = _t(rng.normal(0, 0.3, (2, n)))
    units = [1, 2]
    params = [A.fit_unit_lpc(x, u, order // u, 0.0) for u in units]
    assert not any(torch.any(p) for p in params)
    # row 0 a signal the smooth candidate fits better, row 1 noise
    x[0] = torch.cumsum(x[0], 0) / 8
    smooth = torch.zeros(2, 4, 32, dtype=torch.float64)
    smooth[..., -1] = -1.0  # each unit predicts its last sample
    log2u, flat, res, loss = A.unit_residual_select(
        x, params + [smooth], units + [4])
    own = torch.sum(torch.abs(x[:, 1:]), -1) / n
    other = A._unit_residual_select_plain(x, [smooth], [4])
    assert log2u.tolist() == [2, 0]
    assert loss[0] == other[3][0] < own[0] and loss[1] == own[1]
    assert torch.equal(res[1], x[1]) and not torch.any(flat[1])


# -- unit_autocorrelations: the layer fits' windowed autocorrelation ---------


def _autocorr_signal(lead, n, seed):
    """Noise and a tone a row at the scale of normalized samples; the first
    row all zero (silent)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = (rng.normal(0, 0.02, lead + (n,))
         + 0.3 * np.sin(2 * np.pi * rng.uniform(0.001, 0.1, lead + (1,))
                        * t))
    x.reshape(-1, n)[0] = 0.0
    return _t(x)


def _old_unit_ac(signal, units, lags, window_type):
    """A candidate's ac as fit_unit_lpc and estimate_code_length formed it
    before the kernel: the units times the window, then
    `autocorrelation`."""
    n = signal.shape[-1]
    if window_type == WINDOW_SIN:  # the estimate windowed the whole row
        return A.autocorrelation(signal * _t(window_weights(WINDOW_SIN, n)),
                                 lags).unsqueeze(-2)
    ns = n // units
    seg = signal.reshape(tuple(signal.shape[:-1]) + (units, ns))
    return A.autocorrelation(seg * _t(window_weights(window_type, ns)), lags)


@pytest.mark.parametrize("order", [2, 4, 16, 32, 128])
def test_unit_autocorrelations_plain_gives_old_ac(order):
    """On the CPU, every candidate split's ac at n = 10240 (over an
    expanded ridge axis, as pre_stage gives the first layer, with a silent
    row) and the block-type estimate's are the bits fit_unit_lpc and
    estimate_code_length formed before, and launch nothing."""
    before = dict(AS.KERNEL_LAUNCHES)
    sig = _autocorr_signal((2, 2), 10240, order)
    x = sig.unsqueeze(0).expand((4,) + tuple(sig.shape))
    splits = [(u, order // u + 1) for u in A.candidate_units(order, 10240)]
    got = A.unit_autocorrelations(x, splits, WINDOW_WELCH)
    for (u, lags), g in zip(splits, got):
        want = _old_unit_ac(x, u, lags, WINDOW_WELCH)
        assert g.shape == x.shape[:-1] + (u, lags)
        assert np.array_equal(_bits(g.numpy()), _bits(want.numpy()))
        assert not torch.any(g[:, 0, 0])
    est, = A.unit_autocorrelations(sig, [(1, order + 1)], WINDOW_SIN)
    want = _old_unit_ac(sig, 1, order + 1, WINDOW_SIN)
    assert np.array_equal(_bits(est.numpy()), _bits(want.numpy()))
    assert AS.KERNEL_LAUNCHES == before


def test_unit_autocorrelations_plain_degenerate_split():
    """Units shorter than their lags (n = 64 at order 128): the bits
    fit_unit_lpc formed before; the lags past a unit zero up to the FFT
    route's rounding."""
    sig = _autocorr_signal((3,), 64, 5)
    splits = [(1, 129), (2, 65), (4, 33)]
    for (u, lags), g in zip(splits, A.unit_autocorrelations(
            sig, splits, WINDOW_WELCH)):
        assert np.array_equal(_bits(g.numpy()), _bits(_old_unit_ac(
            sig, u, lags, WINDOW_WELCH).numpy()))
        assert torch.all(g[..., 64 // u:].abs() <= 1e-12 * g[..., :1].abs())


@pytest.mark.parametrize("order", [4, 128])
def test_fit_unit_lpc_and_estimate_give_old_outputs(order):
    """fit_unit_lpc (the -a path's one candidate a call) and
    estimate_code_length give their old bits on the CPU."""
    sig = _autocorr_signal((2, 2), 10240, order + 1)
    rv = _t(np.array([2.0 ** -9, 0.0])).reshape(2, 1, 1)
    for u in A.candidate_units(order, 10240)[::3]:
        got = A.fit_unit_lpc(sig, u, order // u, rv, {})
        want = _old_fit_unit_lpc(sig, u, order // u, rv)
        assert np.array_equal(_bits(got.numpy()), _bits(want.numpy()))
    got = A.estimate_code_length(sig, order, 16, {})
    windowed = sig * _t(window_weights(WINDOW_SIN, 10240))
    ac = A.autocorrelation(windowed, order + 1)
    _, parcor = A.levinson_durbin(ac, order, with_parcor=True)
    power = ac[..., 0] * 2.0 ** 30
    log2_var = torch.sum(torch.log2(torch.clamp(
        1.0 - parcor[..., 1:] ** 2, min=1e-30)), dim=-1)
    est = 1.9426950408889634 + 0.5 * (
        torch.log2(torch.clamp(power, min=1e-300)) - np.log2(10240)
        + log2_var)
    want = torch.where(power == 0.0, 0.0, torch.where(est <= 0, 1.0, est))
    assert np.array_equal(_bits(got.numpy()), _bits(want.numpy()))


@pytest.mark.parametrize("expanded", [True, False])
def test_unit_autocorrelations_launch_reads_each_row_once(expanded,
                                                          monkeypatch):
    """The launch side's shapes on the CPU, with the kernel's wrapper
    replaced by the plain sums: an expanded ridge axis goes to the wrapper
    once (B x C rows, not R x B x C) and comes back expanded over it;
    each candidate's window is the table `_window` keeps, of n / u taps;
    the results are the plain version's."""
    seen = []

    def fake(x, splits):
        seen.append((tuple(x.shape), [(l2, lags, tuple(w.shape))
                                      for l2, lags, w in splits]))
        n = x.shape[-1]
        out = []
        for l2, lags, w in splits:
            seg = x.reshape(x.shape[0], 1 << l2, n >> l2) * w
            out.append(A._autocorrelation_plain(seg, lags))
        return out

    monkeypatch.setattr(AS, "lpc_autocorr", fake)
    sig = _autocorr_signal((3, 2), 2048, 7)
    x = (sig.unsqueeze(0).expand((4,) + tuple(sig.shape)) if expanded
         else _autocorr_signal((4, 3, 2), 2048, 8))
    splits = [(u, 32 // u + 1) for u in A.candidate_units(32, 2048)]
    windows = {}
    got = A._unit_autocorrelations_launch(x, splits, WINDOW_WELCH, windows)
    rows = 6 if expanded else 24
    assert seen == [((rows, 2048), [((u - 1).bit_length(), lags,
                                     (2048 // u,)) for u, lags in splits])]
    assert len(windows) == len(splits)
    want = A._unit_autocorrelations_plain(x, splits, WINDOW_WELCH)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g.stride(0) == 0) == expanded
        assert np.array_equal(_bits(g.contiguous().numpy()),
                              _bits(w.numpy()))


def test_autocorrelation_routes_stay_on_the_cpu():
    """`autocorrelation` on a CPU tensor is its plain routes' bits and
    launches nothing (the card launches the kernel with no window)."""
    before = dict(AS.KERNEL_LAUNCHES)
    x = _autocorr_signal((2, 3), 4096, 9)
    for lags in (5, 17, 129):
        assert np.array_equal(_bits(A.autocorrelation(x, lags).numpy()),
                              _bits(A._autocorrelation_plain(x, lags).numpy()))
    assert AS.KERNEL_LAUNCHES == before


# -- dispatch and the wrappers -------------------------------------------------


def test_cpu_tensors_take_the_plain_versions():
    """The public functions give the plain versions' bits on the CPU and
    launch nothing."""
    before = dict(AS.KERNEL_LAUNCHES)
    ac = _t(levinson_rows(33, 1)).reshape(2, 5, 34)
    got = A.levinson_durbin(ac, 33, with_parcor=True)
    want = A._levinson_durbin_plain(ac, 33, with_parcor=True)
    assert all(np.array_equal(_bits(g.numpy()), _bits(w.numpy()))
               for g, w in zip(got, want))
    c = _t(quantize_rows(16, 2)).reshape(2, 4, 16)
    assert all(torch.equal(g, w) for g, w in zip(
        A.quantize_coefficients(c, 8), A._quantize_coefficients_plain(c, 8)))
    x, cc, log2u, rsh = (_t(a).reshape((2, 3) + a.shape[1:])
                         for a in predict_inputs(16, [1, 2, 4], 64, 3))
    assert torch.equal(I._predict_dense(x, cc, log2u, rsh, 4),
                       I._predict_dense_plain(x, cc, log2u, rsh, 4))
    assert AS.KERNEL_LAUNCHES == before


def test_cpu_tensors_take_the_plain_residual_pass():
    """unit_residual_select on CPU tensors (an expanded ridge axis, fitted
    coefficients) gives its plain version's bits and launches nothing."""
    before = dict(AS.KERNEL_LAUNCHES)
    sig, rv = _ridge_signal(2, 1024, 5)
    units = A.candidate_units(16, 1024)
    params = [A.fit_unit_lpc(sig, u, 16 // u, rv) for u in units]
    got = A.unit_residual_select(sig, params, units)
    want = A._unit_residual_select_plain(sig, params, units)
    assert all(np.array_equal(_bits(g.numpy()), _bits(w.numpy()))
               for g, w in zip(got, want))
    assert AS.KERNEL_LAUNCHES == before


def test_cpu_tensors_take_the_grouped_plain_versions():
    """The grouped quantizers give their plain versions' bits on the CPU
    and launch nothing: the encoder's (quantize_layers) over [B, C, order]
    layers, and the byte-exact fit's (exact_device._quantize_layers) over
    an arena's columns."""
    from linne_tpu_torch.ops import exact_device as ED

    before = dict(AS.KERNEL_LAUNCHES)
    coefs = [_t(quantize_rows(o, o)).reshape(2, 4, o) for o in (4, 32, 16)]
    got = A.quantize_layers(coefs, 8)
    want = A._quantize_layers_plain(coefs, 8)
    assert got[0].shape == (2, 4, 52) and got[1].shape == (3, 2, 4)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    arena = torch.cat([c.reshape(8, -1) for c in coefs], dim=1)
    got = ED._quantize_layers(arena, (4, 32, 16), 8)
    want = ED._quantize_layers_plain(arena, (4, 32, 16), 8)
    assert all(np.array_equal(_bits(g.numpy()), _bits(w.numpy()))
               for g, w in zip(got, want))
    assert AS.KERNEL_LAUNCHES == before


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


_ARG_CASES = {  # case: the check's words in its message
    "levinson dtype": "must be torch.float64",
    "levinson shape": "ac must be",
    "levinson order": "order 129",
    "levinson device": "unsupported device cpu",
    "quantize dtype": "must be torch.float64",
    "quantize shape": "coefs must be",
    "quantize order": "order 129",
    "quantize nbits": "nbits 32",
    "quantize device": "unsupported device cpu",
    "predict dtype": "must be torch.int32",
    "predict rows": "row counts differ",
    "predict order": "order 129",
    "predict u_max": "u_max 8",
    "predict device": "unsupported device cpu",
    "public meta tensor": "unsupported device meta",
    "group count 0": "0 layers",
    "group count 5": "5 layers",
    "group order": "order 129",
    "group order 0": "order 0",
    "group dtype": "must be torch.float64",
    "group rows": "row counts differ",
    "group nbits": "nbits 0",
    "group taps": "taps must be contiguous",
    "group device": "unsupported device cpu",
    "exact count": "5 layers",
    "exact order": "order 129",
    "exact dtype": "must be torch.float64",
    "exact width": "params must be",
    "exact nbits": "nbits 32",
    "exact device": "unsupported device cpu",
    "predict taps": "taps must be contiguous",
    "residual dtype": "x must be a torch.float64",
    "residual shape": "x must be .ridges, rows, n.",
    "residual rows": "rows must be contiguous",
    "residual count 0": "0 candidates",
    "residual count 9": "9 candidates",
    "residual params rows": "candidate 1 must be .8, order.",
    "residual params taps": "candidate 1 has 16 taps",
    "residual params dtype": "candidate 0 must be a torch.float64",
    "residual params layout": "candidate 0 must be contiguous",
    "residual order": "order 129",
    "residual units": "2.3 units must divide",
    "residual device": "unsupported device cpu",
    "autocorr dtype": "x must be a torch.float64",
    "autocorr shape": "x must be .rows, n.",
    "autocorr rows": "samples must be contiguous",
    "autocorr count 0": "0 candidates",
    "autocorr count 9": "9 candidates",
    "autocorr units": "2.3 units must divide n = 100",
    "autocorr lags": "130 lags outside 1..129",
    "autocorr window dtype": "window 1 must be a torch.float64",
    "autocorr window taps": "window 0 must be .32. contiguous",
    "autocorr device": "unsupported device cpu",
    "autocorr public meta": "unsupported device meta",
    "rice dtype": "must be torch.int32",
    "rice shape": "x must be .rows, n.",
    "rice rows": "must be contiguous",
    "rice n 0": "n = 0 outside 1..2097152",
    "rice n long": "n = 2097153 outside 1..2097152",
    "rice porder 11": "max_porder 11",
    "rice porder divides": "max_porder 3: 2.max_porder partitions",
    "rice device": "unsupported device cpu",
    "rice public dtype": "compute_dtype torch.float32",
    "rice public meta": "unsupported device meta",
}


@pytest.mark.parametrize("case", list(_ARG_CASES))
def test_wrapper_argument_checks(case):
    """Each wrapper raises ValueError, naming the check, before it builds
    or launches anything. The device is checked last, so meta tensors
    reach every other check; a CPU or meta tensor is refused as an
    unsupported device."""
    f64, i32 = torch.float64, torch.int32
    calls = {
        "levinson dtype": lambda: AS.levinson_durbin(
            _meta((4, 9), torch.float32), 8),
        "levinson shape": lambda: AS.levinson_durbin(_meta((4, 8), f64), 8),
        "levinson order": lambda: AS.levinson_durbin(
            _meta((4, 130), f64), 129),
        "levinson device": lambda: AS.levinson_durbin(
            torch.zeros(4, 9, dtype=f64), 8),
        "quantize dtype": lambda: AS.quantize_coefficients(
            _meta((4, 8), torch.float32)),
        "quantize shape": lambda: AS.quantize_coefficients(
            _meta((2, 4, 8), f64)),
        "quantize order": lambda: AS.quantize_coefficients(
            _meta((4, 129), f64)),
        "quantize nbits": lambda: AS.quantize_coefficients(
            _meta((4, 8), f64), 32),
        "quantize device": lambda: AS.quantize_coefficients(
            torch.zeros(4, 8, dtype=f64)),
        "predict dtype": lambda: AS.predict_dense(
            _meta((4, 64), torch.int64), _meta((4, 8), i32),
            _meta((4,), i32), _meta((4,), i32), 4),
        "predict rows": lambda: AS.predict_dense(
            _meta((4, 64), i32), _meta((3, 8), i32), _meta((4,), i32),
            _meta((4,), i32), 4),
        "predict order": lambda: AS.predict_dense(
            _meta((4, 256), i32), _meta((4, 129), i32), _meta((4,), i32),
            _meta((4,), i32), 4),
        "predict u_max": lambda: AS.predict_dense(
            _meta((4, 100), i32), _meta((4, 8), i32), _meta((4,), i32),
            _meta((4,), i32), 8),
        "predict device": lambda: AS.predict_dense(
            *(torch.zeros(s, dtype=i32) for s in ((4, 64), (4, 8), 4, 4)),
            4),
        "public meta tensor": lambda: A.levinson_durbin(
            _meta((2, 3, 9), f64), 8),
        "group count 0": lambda: AS.quantize_layers([]),
        "group count 5": lambda: AS.quantize_layers(
            [_meta((4, 8), f64)] * 5),
        "group order": lambda: AS.quantize_layers(
            [_meta((4, 8), f64), _meta((4, 129), f64)]),
        "group order 0": lambda: AS.quantize_layers(
            [_meta((4, 0), f64)]),
        "group dtype": lambda: AS.quantize_layers(
            [_meta((4, 8), f64), _meta((4, 16), torch.float32)]),
        "group rows": lambda: AS.quantize_layers(
            [_meta((4, 8), f64), _meta((5, 16), f64)]),
        "group nbits": lambda: AS.quantize_layers([_meta((4, 8), f64)], 0),
        "group taps": lambda: AS.quantize_layers(
            [_meta((8, 4), f64).t()]),
        "group device": lambda: AS.quantize_layers(
            [torch.zeros(4, 8, dtype=f64), torch.zeros(4, 16, dtype=f64)]),
        "exact count": lambda: AS.quantize_layers_exact(
            _meta((4, 40), f64), (8,) * 5, 8),
        "exact order": lambda: AS.quantize_layers_exact(
            _meta((4, 200), f64), (4, 129), 8),
        "exact dtype": lambda: AS.quantize_layers_exact(
            _meta((4, 148), torch.float32), (4, 128, 16), 8),
        "exact width": lambda: AS.quantize_layers_exact(
            _meta((4, 147), f64), (4, 128, 16), 8),
        "exact nbits": lambda: AS.quantize_layers_exact(
            _meta((4, 148), f64), (4, 128, 16), 32),
        "exact device": lambda: AS.quantize_layers_exact(
            torch.zeros(4, 148, dtype=f64), (4, 128, 16), 8),
        "predict taps": lambda: AS.predict_dense(
            _meta((4, 64), i32), _meta((8, 4), i32).t(), _meta((4,), i32),
            _meta((4,), i32), 4),
        "residual dtype": lambda: AS.unit_residual_select(
            _meta((2, 4, 64), torch.float32), [_meta((8, 8), f64)], [0]),
        "residual shape": lambda: AS.unit_residual_select(
            _meta((8, 64), f64), [_meta((8, 8), f64)], [0]),
        "residual rows": lambda: AS.unit_residual_select(
            _meta((2, 64, 4), f64).transpose(1, 2), [_meta((8, 8), f64)],
            [0]),
        "residual count 0": lambda: AS.unit_residual_select(
            _meta((2, 4, 64), f64), [], []),
        "residual count 9": lambda: AS.unit_residual_select(
            _meta((2, 4, 64), f64), [_meta((8, 8), f64)] * 9, range(9)),
        "residual params rows": lambda: AS.unit_residual_select(
            _meta((2, 4, 64), f64), [_meta((8, 8), f64), _meta((4, 8), f64)],
            [0, 1]),
        "residual params taps": lambda: AS.unit_residual_select(
            _meta((2, 4, 64), f64), [_meta((8, 8), f64),
                                     _meta((8, 16), f64)], [0, 1]),
        "residual params dtype": lambda: AS.unit_residual_select(
            _meta((2, 4, 64), f64), [_meta((8, 8), torch.float32)], [0]),
        "residual params layout": lambda: AS.unit_residual_select(
            _meta((2, 4, 64), f64), [_meta((8, 8), f64).t()], [0]),
        "residual order": lambda: AS.unit_residual_select(
            _meta((2, 4, 256), f64), [_meta((8, 129), f64)], [0]),
        "residual units": lambda: AS.unit_residual_select(
            _meta((2, 4, 64), f64), [_meta((8, 12), f64)], [3]),
        "residual device": lambda: AS.unit_residual_select(
            torch.zeros(2, 4, 64, dtype=f64), [torch.zeros(8, 8, dtype=f64)],
            [0]),
        "autocorr dtype": lambda: AS.lpc_autocorr(
            _meta((4, 64), torch.float32), [(0, 5, None)]),
        "autocorr shape": lambda: AS.lpc_autocorr(
            _meta((2, 4, 64), f64), [(0, 5, None)]),
        "autocorr rows": lambda: AS.lpc_autocorr(
            _meta((64, 4), f64).t(), [(0, 5, None)]),
        "autocorr count 0": lambda: AS.lpc_autocorr(_meta((4, 64), f64), []),
        "autocorr count 9": lambda: AS.lpc_autocorr(
            _meta((4, 64), f64), [(0, 5, None)] * 9),
        "autocorr units": lambda: AS.lpc_autocorr(
            _meta((4, 100), f64), [(0, 5, None), (3, 5, None)]),
        "autocorr lags": lambda: AS.lpc_autocorr(
            _meta((4, 256), f64), [(0, 130, None)]),
        "autocorr window dtype": lambda: AS.lpc_autocorr(
            _meta((4, 64), f64), [(0, 5, None),
                                  (1, 5, _meta((32,), torch.float32))]),
        "autocorr window taps": lambda: AS.lpc_autocorr(
            _meta((4, 64), f64), [(1, 5, _meta((64,), f64))]),
        "autocorr device": lambda: AS.lpc_autocorr(
            torch.zeros(4, 64, dtype=f64),
            [(1, 5, torch.ones(32, dtype=f64))]),
        "autocorr public meta": lambda: A.unit_autocorrelations(
            _meta((2, 3, 64), f64), [(2, 5)], WINDOW_WELCH),
        "rice dtype": lambda: AS.rice_search(_meta((4, 64), torch.int64), 6),
        "rice shape": lambda: AS.rice_search(_meta((2, 4, 64), i32), 6),
        "rice rows": lambda: AS.rice_search(_meta((64, 4), i32).t(), 2),
        "rice n 0": lambda: AS.rice_search(_meta((4, 0), i32), 0),
        "rice n long": lambda: AS.rice_search(
            _meta((1, (1 << 21) + 1), i32), 0),
        "rice porder 11": lambda: AS.rice_search(_meta((4, 4096), i32), 11),
        "rice porder divides": lambda: AS.rice_search(
            _meta((4, 100), i32), 3),
        "rice device": lambda: AS.rice_search(
            torch.zeros(4, 64, dtype=i32), 6),
        "rice public dtype": lambda: R.rice_search(
            _meta((2, 3, 64), i32), torch.float32),
        "rice public meta": lambda: R.rice_search(_meta((2, 3, 64), i32)),
    }
    before = dict(AS.KERNEL_LAUNCHES)
    with pytest.raises(ValueError, match=_ARG_CASES[case]):
        calls[case]()
    assert AS.KERNEL_LAUNCHES == before
    assert not AS._fns


def test_importing_the_scans_builds_nothing():
    """Importing the wrappers (and the modules that dispatch to them)
    needs no nvcc and builds no library."""
    from linne_tpu_torch.ops import _kernels

    def listing():
        d = _kernels._BUILD_DIR
        return set(d.glob("*")) if d.exists() else set()

    before = listing()
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "PYTHONSTARTUP", "CUDA_HOME")}
    env["PATH"] = os.path.dirname(sys.executable)  # no nvcc on it
    env["OMP_NUM_THREADS"] = "1"
    code = (
        "import sys; "
        f"sys.path.insert(0, {str(REPO_ROOT)!r}); "
        "from linne_tpu_torch.ops import analysis_scans, analysis, intops, "
        "rice_search; "
        "from linne_tpu_torch.ops import _kernels; "
        "assert not _kernels._libs and not analysis_scans._fns; "
        "print('ok')")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
    assert listing() == before
