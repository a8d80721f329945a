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
from linne_tpu.ops import analysis as JA
from linne_tpu.ops import intops as JI
from linne_tpu_torch.ops import analysis as A
from linne_tpu_torch.ops import analysis_scans as AS
from linne_tpu_torch.ops import intops as I
from linne_tpu_torch.presets import PRESETS

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
        "from linne_tpu_torch.ops import analysis_scans, analysis, intops; "
        "from linne_tpu_torch.ops import _kernels; "
        "assert not _kernels._libs and not analysis_scans._fns; "
        "print('ok')")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
    assert listing() == before
