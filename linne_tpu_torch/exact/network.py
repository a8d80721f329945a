"""Bit-exact per-block multi-layer LPC predictor ("LINNE net") — host oracle.

Reproduces the encoder-side model-fitting pipeline of the reference
(reference: libs/linne_network/src/linne_network.c) with the same
double-precision operation order:

- per-layer power-of-two unit-count search scored by in-place mean |residual|
  (linne_network.c:268-347),
- greedy layer-by-layer fit + forward over a ridge-candidate sweep
  (linne_network.c:582-630),
- full-batch momentum gradient descent on the L1 loss for `-l` learning
  (linne_network.c:805-873).

Serial C accumulations are reproduced with `np.cumsum` along the accumulation
axis. Unit-local convolutions read across unit boundaries for units > 0 and
assume zero history for unit 0, exactly as the reference pointer arithmetic
does.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .. import native as _native
from ..constants import FLT_EPSILON, FLT_MAX, LOG2_NUM_UNITS_BITWIDTH
from .lpc import LpcState, WINDOW_WELCH, _serial_sum, _welch_window

_MAX_NUM_UNITS = 1 << ((1 << LOG2_NUM_UNITS_BITWIDTH) - 1)  # 128

# (num_params, n) -> (level_units int32[], welch weights concat, w_off
# int64[]) for the native whole-layer fit — the valid power-of-two unit
# counts and their per-level Welch windows (from the oracle's window cache,
# so Python stays the single source of window truth).
_fit_layer_cache: dict = {}


def _fit_layer_levels(num_params: int, n: int):
    key = (num_params, n)
    hit = _fit_layer_cache.get(key)
    if hit is None:
        levels = []
        nunits = 1
        while nunits <= min(_MAX_NUM_UNITS, num_params):
            if not (num_params % nunits or n % nunits):
                levels.append(nunits)
            nunits <<= 1
        ws = [_welch_window(n // u) for u in levels]
        w_off = np.zeros(len(levels), dtype=np.int64)
        off = 0
        for i, w in enumerate(ws):
            w_off[i] = off
            off += w.shape[0]
        hit = (np.asarray(levels, dtype=np.int32),
               np.concatenate(ws) if ws else np.zeros(0, dtype=np.float64),
               w_off)
        _fit_layer_cache[key] = hit
    return hit


# (per-layer num_params tuple, n) -> concatenated level tables for the
# native whole-network sweep: per-layer slices into one level_units/w_off
# pair, with w_off entries absolute into the concatenated Welch weights
# (built from the per-layer oracle caches above).
_fit_network_cache: dict = {}


def _fit_network_tables(num_params_t: tuple, n: int):
    key = (num_params_t, n)
    hit = _fit_network_cache.get(key)
    if hit is None:
        units_parts, woff_parts, weight_parts = [], [], []
        level_off = np.zeros(len(num_params_t), dtype=np.int32)
        level_cnt = np.zeros(len(num_params_t), dtype=np.int32)
        wbase = 0
        for l, p in enumerate(num_params_t):
            levels, ws, w_off = _fit_layer_levels(p, n)
            level_off[l] = sum(u.shape[0] for u in units_parts)
            level_cnt[l] = levels.shape[0]
            units_parts.append(levels)
            woff_parts.append(w_off + wbase)
            weight_parts.append(ws)
            wbase += ws.shape[0]
        hit = (np.asarray(num_params_t, dtype=np.int32),
               np.concatenate(units_parts),
               level_off, level_cnt,
               np.concatenate(woff_parts),
               np.concatenate(weight_parts))
        _fit_network_cache[key] = hit
    return hit


def _sliding_matrix(x: np.ndarray, n: int, order: int) -> np.ndarray:
    """W[t, j] = x_padded[t - order + j], j = 0..order-1, where x_padded has
    `order` zeros of left context. Matches the reference convolution layout
    (weights time-reversed: W[:, -1] is the previous sample). Returned as a
    zero-copy stride view."""
    xp = np.concatenate([np.zeros(order, dtype=np.float64), x[:n]])
    return np.lib.stride_tricks.sliding_window_view(xp, order)[:n]


def _unit_predictions(
    params: np.ndarray, data: np.ndarray, n: int, num_units: int,
    include_base: bool,
) -> np.ndarray:
    """Serial-order per-sample dot products of each unit's filter with its
    (cross-boundary) input window.

    If include_base, accumulation starts from data[t] (the unit-search
    residual evaluation, linne_network.c:319-335); otherwise from 0.0 (the
    layer forward pass, linne_network.c:192-208). Returns the accumulated
    vector of length n (entry 0 of unit 0 must be ignored by callers).

    The native helper runs the identical strict-order per-sample chains
    (fp contraction off) without materializing the [n, npu+1] cumsum
    matrix; equality is pinned by tests/test_exact_native_helpers.py."""
    npu = params.shape[0] // num_units
    ns = n // num_units
    if n % num_units == 0 and _native.available():
        return _native.exact_unit_predict(
            np.ascontiguousarray(data[:n], np.float64), params, num_units,
            npu, include_base)
    W = _sliding_matrix(data, n, npu)
    # per-sample filter: unit u covers rows [u*ns, (u+1)*ns)
    P = np.repeat(params.reshape(num_units, npu), ns, axis=0)
    # A diverged -l run legitimately overflows these doubles to inf/NaN;
    # the C reference computes straight through (bit-identity is the
    # contract), so silence numpy's warnings without changing arithmetic.
    with np.errstate(invalid="ignore", over="ignore"):
        terms = W * P
        if include_base:
            acc = np.concatenate([data[:n, None], terms], axis=1)
        else:
            acc = np.concatenate([np.zeros((n, 1)), terms], axis=1)
        return np.cumsum(acc, axis=1)[:, -1]


class LayerState:
    """One prediction layer (reference struct: linne_network.c:12-20)."""

    def __init__(self, num_samples: int, num_params: int):
        assert num_samples > num_params
        self.num_samples = num_samples
        self.num_params = num_params
        self.num_units = 1
        self.params = np.zeros(num_params, dtype=np.float64)
        self.dparams = np.zeros(num_params, dtype=np.float64)
        self.din = np.zeros(num_samples, dtype=np.float64)
        self.dout = np.zeros(num_samples, dtype=np.float64)

    def forward(self, data: np.ndarray, n: int) -> None:
        """data += unitwise prediction, in place (linne_network.c:165-210).
        Sample 0 of unit 0 is untouched."""
        self.din[:n] = data[:n]
        pred = _unit_predictions(self.params, self.din, n, self.num_units, False)
        # inf + -inf here is legitimate on a diverged -l run (see
        # _unit_predictions); warn-suppress just the accumulate.
        with np.errstate(invalid="ignore", over="ignore"):
            data[1:n] += pred[1:n]

    def backward(self, data: np.ndarray, n: int) -> None:
        """Computes dparams and replaces `data` with the input gradient
        (linne_network.c:213-265). Native helper: identical chains, ~20x;
        pinned by tests/test_exact_native_helpers.py."""
        self.dout[:n] = data[:n]
        npu = self.num_params // self.num_units
        ns = n // self.num_units
        if n % self.num_units == 0 and data[:n].flags.c_contiguous \
                and _native.available():
            _native.exact_layer_backward(
                self.din[:n], self.dout[:n], data[:n], self.params,
                self.num_units, npu, n, self.dparams)
            return
        # A diverged training run legitimately carries inf/NaN doubles
        # through these chains (the C reference computes straight through
        # them; bit-identity with it is the contract) — silence numpy's
        # invalid/overflow warnings, don't change the arithmetic.
        with np.errstate(invalid="ignore", over="ignore"):
            for unit in range(self.num_units):
                pin = self.din[unit * ns : (unit + 1) * ns]
                pout = self.dout[unit * ns : (unit + 1) * ns]
                pparams = self.params[unit * npu : (unit + 1) * npu]
                pback = data[unit * ns : (unit + 1) * ns]
                pdp = self.dparams[unit * npu : (unit + 1) * npu]
                # dparams[i] = sum_{j=0}^{ns-npu+i-1} pin[j] * pout[npu-i+j]
                for i in range(npu):
                    jn = ns - npu + i
                    pdp[i] = _serial_sum(
                        pin[:jn] * pout[npu - i : npu - i + jn])
                # input grad: back[i] = sum_j params[j]*pout[npu+i-j], scaled
                for i in range(ns - npu):
                    terms = pparams * pout[npu + i : i : -1][: npu]
                    pback[i] += _serial_sum(terms) / npu
                for i in range(ns - npu, ns):
                    # edge: only in-range pout entries (j > npu+i-ns) count
                    j0 = npu + i - ns + 1
                    terms = pparams[j0:] * pout[i + 1 : npu + i - j0 + 1][::-1]
                    pback[i] += _serial_sum(terms) / npu


class NetworkState:
    """Multi-layer predictor + shared LPC scratch
    (reference struct: linne_network.c:23-33)."""

    def __init__(self, max_num_samples: int, max_num_layers: int,
                 max_num_params: int):
        self.max_num_samples = max_num_samples
        self.max_num_layers = max_num_layers
        self.max_num_params = max_num_params
        self.lpcc = LpcState(max_num_params, max_num_samples)
        self.layers: List[LayerState] = []
        self.data_buffer = np.zeros(max_num_samples, dtype=np.float64)
        self.num_samples = max_num_samples

    def set_layer_structure(self, num_samples: int,
                            num_params_list: Sequence[int]) -> None:
        self.layers = [LayerState(num_samples, p) for p in num_params_list]
        self.num_samples = num_samples

    # -- fitting -----------------------------------------------------------

    def _search_optimal_num_units(
        self, layer: LayerState, data: np.ndarray, n: int,
        max_num_units: int, regular_term: float,
    ) -> int:
        """Try unit counts 1,2,4,...,max; fit each split with a 0-iteration
        AF fit (pure Levinson-Durbin, Welch window) and score mean |residual|
        (linne_network.c:268-347)."""
        min_loss = FLT_MAX
        best = 0
        nunits = 1
        while nunits <= max_num_units:
            if (layer.num_params % nunits) or (n % nunits):
                nunits <<= 1
                continue
            npu = layer.num_params // nunits
            ns = n // nunits
            for unit in range(nunits):
                coefs = self.lpcc.calculate_coef_af(
                    data[unit * ns :], ns, npu, 0, WINDOW_WELCH, regular_term)
                layer.params[unit * npu : (unit + 1) * npu] = coefs[::-1]
            pred = _unit_predictions(layer.params, data, n, nunits, True)
            # serial sum of |residual| skipping sample 0 of unit 0
            mean_loss = _serial_sum(np.abs(pred[1:n])) / n
            if mean_loss < min_loss:
                min_loss = mean_loss
                best = nunits
            nunits <<= 1
        assert best != 0
        return best

    def _set_parameter(self, layer: LayerState, data: np.ndarray, n: int,
                       num_af_iterations: int, regular_term: float) -> None:
        npu = layer.num_params // layer.num_units
        ns = n // layer.num_units
        for unit in range(layer.num_units):
            coefs = self.lpcc.calculate_coef_af(
                data[unit * ns :], ns, npu, num_af_iterations,
                WINDOW_WELCH, regular_term)
            layer.params[unit * npu : (unit + 1) * npu] = coefs[::-1]

    def _fit_layer(self, layer: LayerState, data: np.ndarray, n: int,
                   num_af_iterations: int, regular_term: float) -> None:
        """Unit-count search + final refit for one layer
        (linne_network.c:268-376). The native whole-layer helper runs the
        identical fit sequence against the same arena arrays in one call
        (the per-unit crossings' ctypes overhead dominated the profile);
        equality is pinned by tests/test_exact_native_helpers.py and the
        golden suites."""
        if layer.num_params <= 258 and _native.available():
            levels, weights, w_off = _fit_layer_levels(layer.num_params, n)
            best = _native.exact_fit_layer(
                data, n, layer.num_params, num_af_iterations, regular_term,
                FLT_EPSILON, FLT_MAX, weights, w_off, levels,
                self.lpcc.buffer, self.lpcc.auto_corr, self.lpcc.lpc_coef,
                self.lpcc.parcor_coef, layer.params,
                self._pred_scratch(n))
            if best > 0:
                layer.num_units = best
                return
        max_units = min(_MAX_NUM_UNITS, layer.num_params)
        layer.num_units = self._search_optimal_num_units(
            layer, data, n, max_units, regular_term)
        self._set_parameter(layer, data, n, num_af_iterations, regular_term)

    def _pred_scratch(self, n: int) -> np.ndarray:
        buf = getattr(self, "_pred_buf", None)
        if buf is None or buf.shape[0] < n:
            buf = np.empty(max(n, self.max_num_samples), dtype=np.float64)
            self._pred_buf = buf
        return buf

    def _search_set_units_and_parameters(
        self, data: np.ndarray, n: int, num_af_iterations: int,
        regular_term: float,
    ) -> float:
        self.data_buffer[:n] = data[:n]
        buf = self.data_buffer
        for layer in self.layers:
            self._fit_layer(layer, buf, n, num_af_iterations, regular_term)
            layer.forward(buf, n)
        return _serial_sum(np.abs(buf[:n])) / n

    def set_units_and_parameters(
        self, data: np.ndarray, n: int, num_afmethod_iterations: int,
        regular_terms: Sequence[float],
    ) -> None:
        """Ridge-candidate sweep, then final refit with the requested AF
        iteration count (linne_network.c:605-630). The whole search runs as
        ONE native call when the envelope allows (linne_exact_fit_network,
        bit-identical incl. arena post-state; pinned by
        tests/test_exact_native_helpers.py) — the per-(ridge x layer)
        crossings and numpy forward glue dominated the remaining
        ExactEncoder profile. The envelope prechecks below mirror
        linne_host.h: a mid-sweep native bail would leave the arena
        part-mutated, so every bail condition must be excluded up front."""
        if (_native.available() and self.layers and len(regular_terms) > 0
                and all(0 < L.num_params <= 258 and n > L.num_params
                        for L in self.layers)):
            (num_params_arr, level_units, level_off, level_cnt, w_off,
             weights) = _fit_network_tables(
                tuple(L.num_params for L in self.layers), n)
            params = np.empty(int(num_params_arr.sum()), dtype=np.float64)
            units = np.empty(len(self.layers), dtype=np.int32)
            st = _native.exact_fit_network(
                np.ascontiguousarray(data[:n], np.float64), n,
                num_params_arr, num_afmethod_iterations,
                np.ascontiguousarray(regular_terms, np.float64),
                FLT_EPSILON, FLT_MAX, weights, w_off, level_units,
                level_off, level_cnt, self.lpcc.buffer, self.lpcc.auto_corr,
                self.lpcc.lpc_coef, self.lpcc.parcor_coef, params, units,
                self.data_buffer, self._pred_scratch(n))
            if st == 0:
                off = 0
                for l, layer in enumerate(self.layers):
                    layer.params[:] = params[off : off + layer.num_params]
                    layer.num_units = int(units[l])
                    off += layer.num_params
                return
        self._set_units_and_parameters_py(
            data, n, num_afmethod_iterations, regular_terms)

    def _set_units_and_parameters_py(
        self, data: np.ndarray, n: int, num_afmethod_iterations: int,
        regular_terms: Sequence[float],
    ) -> None:
        min_loss = FLT_MAX
        best_i = 0
        for i, term in enumerate(regular_terms):
            loss = self._search_set_units_and_parameters(data, n, 0, term)
            if loss < min_loss:
                min_loss = loss
                best_i = i
        self._search_set_units_and_parameters(
            data, n, num_afmethod_iterations, regular_terms[best_i])

    # -- loss / training ---------------------------------------------------

    def calculate_loss(self, data: np.ndarray, n: int) -> float:
        for layer in self.layers:
            layer.forward(data, n)
        return _serial_sum(np.abs(data[:n])) / n

    def _calculate_gradient(self, data: np.ndarray, n: int) -> float:
        loss = self.calculate_loss(data, n)
        # L1 subgradient: sign(x)/n with sign(+-0) = +0
        # (linne_network.c:66-75)
        d = data[:n]
        sgn = np.where(d > 0, 1.0, np.where(d < 0, -1.0, 0.0))
        data[:n] = sgn / n
        for layer in reversed(self.layers):
            layer.backward(data, n)
        return loss

    def estimate_code_length(self, data: np.ndarray, n: int,
                             bits_per_sample: int) -> float:
        return self.lpcc.estimate_code_length(
            data, n, bits_per_sample, self.layers[0].num_params)


class TrainerState:
    """Momentum-SGD trainer (reference: linne_network.c:805-873)."""

    def __init__(self, max_num_layers: int, max_num_params: int):
        self.momentum = [
            np.zeros(max_num_params, dtype=np.float64)
            for _ in range(max_num_layers)
        ]
        self.alpha = float(np.float32(0.8))

    def train(self, net: NetworkState, data: np.ndarray, n: int,
              max_iterations: int, learning_rate: float,
              loss_epsilon: float) -> None:
        for l, layer in enumerate(net.layers):
            self.momentum[l][: layer.num_params] = 0.0
        if (_native.available()
                and all(n % L.num_units == 0 for L in net.layers)):
            # whole loop in one native call (bit-identical; pinned by
            # tests/test_exact_native_helpers.py); per-layer state copied
            # back so later code sees the oracle's post-train arrays
            layers = net.layers
            units = np.array([L.num_units for L in layers], dtype=np.int32)
            nparams = np.array([L.num_params for L in layers],
                               dtype=np.int32)
            params = np.concatenate([L.params for L in layers])
            dparams = np.zeros_like(params)
            momentum = np.zeros_like(params)
            _native.exact_train(
                np.ascontiguousarray(data[:n], np.float64), n, units,
                nparams, params, dparams, momentum, max_iterations,
                learning_rate, loss_epsilon, self.alpha, FLT_MAX)
            off = 0
            for l, L in enumerate(layers):
                L.params[:] = params[off : off + L.num_params]
                L.dparams[:] = dparams[off : off + L.num_params]
                self.momentum[l][: L.num_params] = (
                    momentum[off : off + L.num_params])
                off += L.num_params
            return
        prev_loss = FLT_MAX
        for _ in range(max_iterations):
            net.data_buffer[:n] = data[:n]
            loss = net._calculate_gradient(net.data_buffer, n)
            # A diverged run legitimately carries inf/NaN doubles through
            # the momentum update (the C reference computes straight
            # through; bit-identity is the contract) — suppress numpy's
            # warnings only around these lines, never alter arithmetic.
            # The forward/backward kernels carry their own narrow wraps.
            with np.errstate(invalid="ignore", over="ignore"):
                for l, layer in enumerate(net.layers):
                    m = self.momentum[l][: layer.num_params]
                    np.multiply(m, self.alpha, out=m)
                    m += learning_rate * layer.dparams
                    layer.params -= m
            if abs(loss - prev_loss) < loss_epsilon:
                break
            prev_loss = loss
