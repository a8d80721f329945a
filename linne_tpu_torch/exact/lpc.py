"""Bit-exact LPC analysis math (host oracle path).

This module reproduces the reference LPC analysis layer
(reference: libs/lpc/src/lpc.c) at the level of individual IEEE-754 double
operations, so that quantized coefficients — and therefore emitted bitstreams
— are byte-identical with the C encoder. Where the C code accumulates sums
serially, we use `np.cumsum` (guaranteed left-to-right accumulation) instead
of `np.sum` (pairwise). Scalar transcendentals go through the `math` module
(CPython wraps the same libm the C build links).

State notes: the reference keeps all scratch vectors in a long-lived
`LPCCalculator` arena and has two reads of *stale* memory that feed into
emitted bits:

- `LPCCalculator_EstimateCodeLength` (lpc.c:846-848) reads
  `parcor_coef[coef_order]`, one element past what the Levinson-Durbin
  recursion wrote — i.e. a value left over from an earlier fit;
- the Welch window (lpc.c:196-205) never writes the middle sample for odd
  lengths, leaving the previous window output in `buffer`.

`LpcState` models that arena so both effects are reproduced.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from .. import native as _native

from ..constants import FLT_EPSILON, FLT_MAX

_FLT_MIN = float.fromhex("0x1p-126")
_LPC_PI = 3.1415926535897932384626433832795029
_INV_LOGE2 = 1.4426950408889634
_AF_RESIDUAL_EPSILON = 1e-6
_BETA_LAPLACE = 1.9426950408889634

WINDOW_RECTANGULAR = 0
WINDOW_SIN = 1
WINDOW_WELCH = 2

_window_cache = {}


def _sin_window(n: int) -> np.ndarray:
    key = (WINDOW_SIN, n)
    w = _window_cache.get(key)
    if w is None:
        w = np.array(
            [math.sin((_LPC_PI * s) / (n - 1)) for s in range(n)], dtype=np.float64
        )
        _window_cache[key] = w
    return w


def _welch_window(n: int) -> np.ndarray:
    """Welch weights for indices [0, n) — the middle index of an odd-length
    window is never applied by the reference; callers must preserve the stale
    buffer value there."""
    key = (WINDOW_WELCH, n)
    w = _window_cache.get(key)
    if w is None:
        divisor = 4.0 * math.pow(n - 1, -2.0)
        w = np.zeros(n, dtype=np.float64)
        for s in range(n >> 1):
            weight = divisor * s * (n - 1 - s)
            w[s] = weight
            w[n - s - 1] = weight
        _window_cache[key] = w
    return w


def _serial_sum(x: np.ndarray) -> float:
    """Left-to-right float64 accumulation starting from 0.0 (matches a C
    accumulator initialized to 0.0 — the leading zero also fixes the sign of
    an all-zero sum, e.g. 0.0 + -0.0 = +0.0)."""
    if x.shape[0] == 0:
        return 0.0
    acc = np.empty(x.shape[0] + 1, dtype=np.float64)
    acc[0] = 0.0
    acc[1:] = x
    return float(np.cumsum(acc)[-1])


def _serial_sub(base: float, terms: np.ndarray) -> float:
    """base - t0 - t1 - ... with left-to-right evaluation. Implemented as a
    serial sum of negated terms, which is bit-identical to chained
    subtraction (negation is exact, rounding is sign-symmetric)."""
    if terms.shape[0] == 0:
        return base - 0.0
    acc = np.empty(terms.shape[0] + 1, dtype=np.float64)
    acc[0] = base
    np.negative(terms, out=acc[1:])
    return float(np.cumsum(acc)[-1])


class LpcState:
    """Long-lived analysis scratch, one per encoder handle (mirrors the
    arena lifetime of `struct LPCCalculator`, lpc.c:31-46)."""

    def __init__(self, max_order: int, max_num_samples: int):
        self.max_order = max_order
        self.max_num_samples = max_num_samples
        self.buffer = np.zeros(max_num_samples, dtype=np.float64)
        self.auto_corr = np.zeros(max_order + 1, dtype=np.float64)
        self.lpc_coef = np.zeros(max_order + 1, dtype=np.float64)
        self.parcor_coef = np.zeros(max_order + 1, dtype=np.float64)

    # -- windowing ---------------------------------------------------------

    def apply_window(self, window_type: int, data: np.ndarray, n: int) -> None:
        if window_type == WINDOW_RECTANGULAR:
            self.buffer[:n] = data[:n]
        elif window_type == WINDOW_SIN:
            self.buffer[:n] = data[:n] * _sin_window(n)
        elif window_type == WINDOW_WELCH:
            w = _welch_window(n)
            if n & 1:
                mid = n >> 1
                stale = self.buffer[mid]
                self.buffer[:n] = data[:n] * w
                self.buffer[mid] = stale  # reference never writes the middle
            else:
                self.buffer[:n] = data[:n] * w
        else:
            raise ValueError(f"unknown window type {window_type}")

    # -- autocorrelation ---------------------------------------------------

    def autocorrelation(self, n: int, num_lags: int) -> None:
        """auto_corr[lag] = sum_{i} buffer[i] * buffer[i+lag], serial in i
        (reference: lpc.c:215-249). The native helper runs the identical
        strict-order chains (fp contraction off) ~4x faster; equality is
        pinned by tests/test_exact_native_helpers.py."""
        d = self.buffer[:n]
        if _native.available():
            self.auto_corr[:num_lags] = _native.exact_autocorr(d, num_lags)
            return
        for lag in range(num_lags):
            prod = d[: n - lag] * d[lag:]
            self.auto_corr[lag] = _serial_sum(prod)

    # -- Levinson-Durbin ---------------------------------------------------

    def levinson_durbin(self, order: int) -> None:
        """Run the recursion on self.auto_corr, writing lpc_coef[0:order]
        and parcor_coef[0:order] (reference: lpc.c:252-324). The native
        helper runs the identical op sequence in place (same write extents,
        preserving arena staleness); pinned by
        tests/test_exact_native_helpers.py."""
        if order <= 258 and _native.available():
            _native.exact_levinson(self.auto_corr, order, FLT_EPSILON,
                                   self.lpc_coef, self.parcor_coef)
            return
        ac = self.auto_corr
        if abs(ac[0]) < FLT_EPSILON:
            self.lpc_coef[: order + 1] = 0.0
            self.parcor_coef[: order + 1] = 0.0
            return

        a = np.zeros(order + 2, dtype=np.float64)
        u = np.zeros(order + 2, dtype=np.float64)
        v = np.zeros(order + 2, dtype=np.float64)

        a[0] = 1.0
        ek = float(ac[0])
        a[1] = -ac[1] / ac[0]
        self.parcor_coef[0] = ac[1] / ek
        ek += float(ac[1]) * float(a[1])
        u[0] = 1.0
        v[1] = 1.0

        for k in range(1, order):
            # gamma = (sum_i a[i] * ac[k+1-i]) / -ek, serial in i
            prod = a[: k + 1] * ac[k + 1 : 0 : -1][: k + 1]
            gamma = _serial_sum(prod)
            gamma /= -ek
            ek *= 1.0 - gamma * gamma
            # u/v update
            u[1 : k + 1] = a[1 : k + 1]
            v[1 : k + 1] = a[k:0:-1]
            u[0] = 1.0
            u[k + 1] = 0.0
            v[0] = 0.0
            v[k + 1] = 1.0
            a[: k + 2] = u[: k + 2] + gamma * v[: k + 2]
            self.parcor_coef[k] = -gamma

        self.lpc_coef[:order] = a[1 : order + 1]

    # -- combined windowed fit --------------------------------------------

    def calculate_coef(
        self, data: np.ndarray, n: int, order: int, window_type: int,
        regular_term: float,
    ) -> None:
        """Window + autocorrelation + ridge + Levinson-Durbin
        (reference: lpc.c:327-366)."""
        self.apply_window(window_type, data, n)
        self.autocorrelation(n, order + 1)
        if n < order:
            self.lpc_coef[: order + 1] = 0.0
            self.parcor_coef[: order + 1] = 0.0
            return
        self.auto_corr[0] *= 1.0 + regular_term
        self.levinson_durbin(order)

    def calculate_coef_af(
        self, data: np.ndarray, n: int, order: int, max_iterations: int,
        window_type: int, regular_term: float,
    ) -> np.ndarray:
        """Auxiliary-function (IRLS) refinement initialized from
        Levinson-Durbin; with 0 iterations this is the plain L-D fit
        (reference: lpc.c:578-661). Returns lpc_coef[:order] (a copy)."""
        self.calculate_coef(data, n, order, window_type, regular_term)
        a = self.lpc_coef[:order].copy()
        if abs(self.auto_corr[0]) < FLT_EPSILON:
            self.lpc_coef[: order + 1] = 0.0
            return self.lpc_coef[:order].copy()

        prev_obj = FLT_MAX
        for _ in range(max_iterations):
            r_mat, r_vec, obj = _af_matrix_and_vector(data, n, a, order)
            solved = _cholesky_solve(r_mat, r_vec)
            if solved is None:  # singular: theoretically all-zero input
                self.lpc_coef[:order] = 0.0
                return self.lpc_coef[:order].copy()
            a = solved
            if abs(prev_obj - obj) < 1e-8:
                break
            prev_obj = obj
        self.lpc_coef[:order] = a
        return self.lpc_coef[:order].copy()

    # -- code-length estimation -------------------------------------------

    def estimate_code_length(
        self, data: np.ndarray, n: int, bits_per_sample: int, order: int,
        window_type: int = WINDOW_SIN,
    ) -> float:
        """Estimated bits/sample from PARCOR coefficients
        (reference: lpc.c:810-865). Reads parcor_coef[order], which the
        recursion does not write — the stale-state quirk described above."""
        self.calculate_coef(data, n, order, window_type, 0.0)
        power = float(self.auto_corr[0])
        power *= math.pow(2, 2.0 * (bits_per_sample - 1))
        if abs(power) <= _FLT_MIN:
            return 0.0
        log2_mean_res_power = _log2(power) - _log2(float(n))
        log2_var_ratio = 0.0
        for ord_ in range(1, order + 1):
            p = float(self.parcor_coef[ord_])
            log2_var_ratio += _log2(1.0 - p * p)
        length = _BETA_LAPLACE + 0.5 * (log2_mean_res_power + log2_var_ratio)
        if length <= 0:
            return 1.0
        return length


    # -- Burg method --------------------------------------------------------

    def calculate_coef_burg(self, data: np.ndarray, n: int,
                            order: int) -> np.ndarray:
        """Burg-method fit via the autocovariance recursion
        (reference: lpc.c:664-807, the enabled branch). Operates on the raw
        data (no window). Returns lpc_coef[:order] (a copy).

        cov[i][i+l] is the autocorrelation of the first n-i samples at lag l;
        each reflection step minimizes forward+backward prediction error.
        """
        data = np.asarray(data, dtype=np.float64)
        # autocovariance table, serial sums like LPC_CalculateAutoCorrelation
        cov = np.zeros((order + 1, order + 1), dtype=np.float64)
        for i in range(order + 1):
            d = data[: n - i]
            for lag in range(order + 1 - i):
                cov[i, i + lag] = _serial_sum(d[: d.shape[0] - lag] * d[lag:])
            for j in range(i + 1, order + 1):
                cov[j, i] = cov[i, j]

        a = np.zeros(order + 1, dtype=np.float64)
        a[0] = 1.0
        diag = np.diag(cov)
        for k in range(order):
            ak = a[: k + 1]
            # Fk + Bk: serial diagonal chain, then the strict upper triangle
            # doubled (reference accumulates both in i-major order)
            fkbk = _serial_sum(ak * ak * (diag[: k + 1] + diag[k + 1 - np.arange(k + 1)]))
            ij = np.triu_indices(k + 1, 1)
            if ij[0].size:
                terms = (a[ij[0]] * a[ij[1]]
                         * (cov[ij[0], ij[1]] + cov[k + 1 - ij[0], k + 1 - ij[1]]))
                fkbk += 2.0 * _serial_sum(terms)
            # Ck: full (k+1)x(k+1) sum, i-major serial
            ci = np.arange(k + 1)
            ck = _serial_sum(
                (ak[:, None] * ak[None, :] * cov[np.ix_(ci, k + 1 - ci)]).reshape(-1))
            mu = -2.0 * ck / fkbk
            for i in range((k + 1) // 2 + 1):
                t1, t2 = a[i], a[k + 1 - i]
                a[i] = t1 + mu * t2
                a[k + 1 - i] = mu * t1 + t2
        self.lpc_coef[:order] = a[1: order + 1]
        return self.lpc_coef[:order].copy()

    # -- MDL ----------------------------------------------------------------

    def calculate_mdl(self, data: np.ndarray, n: int, order: int,
                      window_type: int = WINDOW_SIN) -> float:
        """Minimum description length of an order-`order` fit
        (reference: lpc.c:868-900): n * sum_{k=1..order} ln(1-parcor[k]^2)
        + order * ln(n). Like EstimateCodeLength, the k=order term reads
        parcor_coef[order], one past what Levinson-Durbin writes (the
        stale-arena quirk in the module docstring)."""
        self.calculate_coef(data, n, order, window_type, 0.0)
        tmp = 0.0
        for k in range(1, order + 1):
            p = float(self.parcor_coef[k])
            tmp += math.log(1.0 - p * p)
        tmp *= n
        tmp += order * math.log(n)
        return tmp

    # -- LPC <-> PARCOR -----------------------------------------------------

    def convert_lpc_to_parcor(self, lpc_coef: np.ndarray,
                              order: int) -> np.ndarray:
        """Downward Levinson recursion LPC -> PARCOR
        (reference: lpc.c:903-937). Returns parcor[:order] (a copy)."""
        tmp = np.array(lpc_coef[:order], dtype=np.float64)
        parcor = np.empty(order, dtype=np.float64)
        for i in range(order - 1, -1, -1):
            gamma = float(tmp[i])
            parcor[i] = -gamma
            prev = tmp[:i].copy()
            denom = 1.0 - gamma * gamma
            for k in range(i):
                tmp[k] = (prev[k] - gamma * prev[i - k - 1]) / denom
        return parcor

    def quantize_coefficients_as_parcor(
        self, lpc_coef: np.ndarray, order: int, nbits_precision: int
    ) -> np.ndarray:
        """LPC -> PARCOR -> fixed-point with round-half-away and boundary
        clamp (reference: lpc.c:940-978)."""
        qmax = 1 << (nbits_precision - 1)
        parcor = self.convert_lpc_to_parcor(lpc_coef, order)
        self.parcor_coef[:order] = parcor
        out = np.empty(order, dtype=np.int32)
        scale = math.pow(2.0, nbits_precision - 1)
        for i in range(order):
            q = int(_c_round(float(parcor[i]) * scale))
            if q >= qmax:
                q = qmax - 1
            elif q < -qmax:
                q = -qmax
            out[i] = q
        return out


def convert_parcor_to_lpc(parcor_coef: np.ndarray, order: int) -> np.ndarray:
    """Upward recursion PARCOR -> LPC — the inverse of
    LpcState.convert_lpc_to_parcor (reference keeps this only in its test
    harness, test/lpc/main.cpp:108-143)."""
    lpc = np.zeros(order, dtype=np.float64)
    lpc[0] = -float(parcor_coef[0])
    for i in range(1, order):
        gamma = -float(parcor_coef[i])
        prev = lpc[:i].copy()
        for k in range(i):
            lpc[k] = prev[k] + gamma * prev[i - k - 1]
        lpc[i] = gamma
    return lpc


def _log2(d: float) -> float:
    # The reference computes log2 as log(d) * (1/ln 2) (lpc.c:54-60).
    return math.log(d) * _INV_LOGE2


def _af_matrix_and_vector(
    data: np.ndarray, n: int, a: np.ndarray, order: int
) -> Tuple[np.ndarray, np.ndarray, float]:
    """IRLS normal equations of the forward-residual auxiliary function
    (reference: lpc.c:452-509). All accumulations serial over samples.
    The native helper runs identical chains ~20x faster (fp contraction
    off); equality pinned by tests/test_exact_native_helpers.py."""
    nres = n - order
    if _native.available():
        r_mat, r_vec, raw_obj = _native.exact_af_normal(
            data, n, a, order, _AF_RESIDUAL_EPSILON)
        return r_mat, r_vec, raw_obj / nres
    # X[t, i] = data[(order + t) - i - 1], t = 0..nres-1, i = 0..order-1
    # residual[t] = data[order + t] + sum_i a[i] * X[t, i]   (serial in i)
    idx = (np.arange(order, n)[:, None] - np.arange(order)[None, :]) - 1
    X = data[idx]  # (nres, order)
    d = data[order:n]
    # serial accumulation over i: cumsum along axis 1 starting from d
    terms = a[None, :] * X
    acc = np.concatenate([d[:, None], terms], axis=1)
    residual = np.abs(np.cumsum(acc, axis=1)[:, -1])
    obj_value = _serial_sum(residual)
    residual = np.maximum(residual, _AF_RESIDUAL_EPSILON)
    inv_res = 1.0 / residual

    r_vec = np.empty(order, dtype=np.float64)
    r_mat = np.empty((order, order), dtype=np.float64)
    for i in range(order):
        xi = X[:, i]
        r_vec[i] = -_serial_sum((d * xi) * inv_res)
        for j in range(i, order):
            r_mat[i, j] = _serial_sum((xi * X[:, j]) * inv_res)
    for i in range(order):
        for j in range(i + 1, order):
            r_mat[j, i] = r_mat[i, j]
    return r_mat, r_vec, obj_value / nres


def _cholesky_solve(amat: np.ndarray, bvec: np.ndarray):
    """In-place Cholesky solve with the reference's descending inner-sum
    order and pow(sum, -0.5) diagonal (reference: lpc.c:402-448).
    Returns None on a non-positive pivot (singular matrix)."""
    if _native.available():
        return _native.exact_cholesky_solve(
            np.ascontiguousarray(amat), bvec)
    dim = amat.shape[0]
    A = amat  # mutated, caller owns
    inv_diag = np.empty(dim, dtype=np.float64)
    for i in range(dim):
        # sum = A[i][i] - sum_{k=i-1..0} A[i][k]^2  (descending k)
        row = A[i, :i][::-1]
        s = _serial_sub(float(A[i, i]), row * row)
        if s <= 0.0:
            return None
        inv_diag[i] = math.pow(s, -0.5)
        for j in range(i + 1, dim):
            rowj = A[j, :i][::-1]
            s2 = _serial_sub(float(A[i, j]), row * rowj)
            A[j, i] = s2 * inv_diag[i]
    x = np.empty(dim, dtype=np.float64)
    for i in range(dim):
        s = _serial_sub(float(bvec[i]), A[i, :i][::-1] * x[:i][::-1])
        x[i] = s * inv_diag[i]
    for i in range(dim - 1, -1, -1):
        s = _serial_sub(float(x[i]), A[i + 1 :, i] * x[i + 1 :])
        x[i] = s * inv_diag[i]
    return x


def quantize_coefficients(
    double_coef: np.ndarray, order: int, nbits_precision: int
) -> Tuple[np.ndarray, int]:
    """Error-feedback quantizer with frexp-derived dynamic right shift,
    processed tail-to-head (reference: lpc.c:981-1040).
    Returns (int_coef, rshift)."""
    qmax = 1 << (nbits_precision - 1)
    coefs = double_coef[:order]
    max_abs = 0.0
    for v in coefs.tolist():
        av = abs(v)
        if max_abs < av:
            max_abs = av
    if max_abs <= math.pow(2.0, -(nbits_precision - 1)):
        return np.zeros(order, dtype=np.int32), nbits_precision
    _, ndigit = math.frexp(max_abs)
    rshift = (nbits_precision - 1) - ndigit
    scale = math.pow(2.0, rshift)
    int_coef = np.zeros(order, dtype=np.int32)
    qerror = 0.0
    for ord_ in range(order - 1, -1, -1):
        qerror += float(coefs[ord_]) * scale
        qtmp = int(_c_round(qerror))
        if qtmp >= qmax:
            qtmp = qmax - 1
        elif qtmp < -qmax:
            qtmp = -qmax
        qerror -= qtmp
        int_coef[ord_] = qtmp
    return int_coef, rshift


def _c_round(d: float) -> float:
    # round-half-away-from-zero (reference: lpc.c:49-52)
    return math.floor(d + 0.5) if d >= 0.0 else -math.floor(-d + 0.5)
