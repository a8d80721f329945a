"""Batched analysis ops: autocorrelation, Levinson-Durbin, unit search,
quantizer. Counterpart of linne_tpu/ops/analysis.py.

Every level of the reference's nested per-block loops (ridge candidates x
layers x unit counts x units; reference call stack:
LINNENetwork_SetUnitsAndParameters, linne_network.c:582-630) is a batch
dimension of one tensor computation over [ridges, blocks, channels, ...].
The recursions over taps or orders (`lax.scan` in the reference), a
layer's windowed autocorrelations (every candidate split's windowing and
lags, and the block-type estimate's) and the residual pass of its
unit-count sweep (every candidate's residual, loss and the first-minimum
pick) are, on a CUDA tensor, one launch each of a hand-written kernel
(ops/analysis_scans.py, csrc/analysis_scans.cu) and, on a CPU tensor,
their plain versions here: Python loops of batched tensor ops
(`_levinson_durbin_plain`, `_quantize_coefficients_plain`,
`_unit_autocorrelations_plain`, `_unit_residual_select_plain`).

Routes, as in the reference: a lag scan (one pass over the signal per lag
or tap) for few lags, an FFT (torch.fft) at 32 and above, and the
matrix-unit routes (`_autocorr_matmul`, `_unit_forward_matmul`: one batched
float64 product each, on the H100's FP64 tensor cores) from 9 lags / 8 taps
up, under a bound on what they materialize. The reference takes the
matrix-unit routes where a matrix unit exists and keeps the lag/FFT routes
on the CPU; `_use_matmul_routes` says which here. On a card the
autocorrelation takes none of them: `autocorrelation` and
`unit_autocorrelations` launch the `lpc_autocorr` kernel, and its routes
are the plain version's (`_autocorrelation_plain`), where the override
forces `_autocorr_matmul` on the CPU for the route-parity tests;
`unit_forward` keeps its routes on both devices. The routes compute the
same quantity; only float rounding differs, which can shift a chosen
coefficient, never losslessness.

Winners are picked with first-minimum semantics, as the reference's
strict-< selection: a running `loss < best` fold over unit candidates
(`unit_residual_select`) and `torch.argmin` (first index on ties) over
ridges.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import FLT_EPSILON

from . import analysis_scans
from .windows import WINDOW_SIN, WINDOW_WELCH, window_weights

_FFT_AUTOCORR_MIN_LAGS = 32

_MATMUL_ROUTES_OVERRIDE = None  # tests force True/False

_CHUNK = 128  # the products' chunk; also bounds the max lag G covers

# The matmul routes materialize O(rows * K * (K + lags)) intermediates;
# above this bound the scan routes are taken. The reference's formula
# (4 bytes an element) is kept as it is, so that under the override the
# port takes the reference's route at every shape.
_MATMUL_BYTES_BUDGET = 420 * 1024 * 1024


def _use_matmul_routes(t: torch.Tensor) -> bool:
    """The override when set, else whether `t` lies on a card: the
    reference's rule (the matrix-unit routes where a matrix unit exists,
    the CPU keeps the lag/FFT routes), with the H100's FP64 tensor cores
    as the matrix unit."""
    if _MATMUL_ROUTES_OVERRIDE is not None:
        return _MATMUL_ROUTES_OVERRIDE
    return t.is_cuda


def _rows(t: torch.Tensor) -> int:
    rows = 1
    for d in t.shape[:-1]:
        rows *= int(d)
    return rows


def _window(window_type: int, n: int, like: torch.Tensor,
            windows: dict | None = None) -> torch.Tensor:
    """The window of `n` taps in like's dtype on its device. With
    `windows`, a dict that the caller keeps, it is made at the first call
    and kept there: a stage captured as a CUDA graph reads the same window
    at every replay, so its owner keeps it as long as the graph
    (codec/encoder.py keeps one such dict a stage chain)."""
    key = (window_type, n, like.dtype, like.device)
    w = None if windows is None else windows.get(key)
    if w is None:
        w = torch.as_tensor(window_weights(window_type, n), dtype=like.dtype,
                            device=like.device)
        if windows is not None:
            windows[key] = w
    return w


def _autocorr_matmul(x: torch.Tensor, num_lags: int) -> torch.Tensor:
    """Autocorrelation as one batched product: the signal in K=128-sample
    chunks Zl [m, K] and their (num_lags-1)-extended contexts Zr
    [m, K+L-1]; G = Zl^T @ Zr holds every (position-in-chunk, offset)
    product, and ac[lag] is the lag-th diagonal sum of G."""
    n = x.shape[-1]
    K = _CHUNK
    L = num_lags
    assert L - 1 <= K
    batch_shape = tuple(x.shape[:-1])
    m = -(-n // K)
    w = K + L - 1
    # pad for the widest context read: last chunk start (m-1)*K + w
    xp = F.pad(x.reshape(-1, n), (0, m * K + L - 1 - n))
    zl = xp[:, : m * K].reshape(-1, m, K)
    zr = xp.unfold(-1, w, K)  # [rows, m, w]: chunk i's context
    g = torch.einsum("rmk,rmw->rkw", zl, zr).contiguous()
    # diagonal l of G: G[k, k + l], read through strides (w + 1, 1)
    diag = g.as_strided((g.shape[0], K, L), (K * w, w + 1, 1))
    ac = torch.sum(diag, dim=1)  # [rows, L]
    return ac.reshape(batch_shape + (L,)).to(x.dtype)


def autocorrelation(x: torch.Tensor, num_lags: int) -> torch.Tensor:
    """Batched autocorrelation over the last axis: ac[..., lag] =
    sum_t x[t] * x[t+lag] for lag in [0, num_lags). A CUDA tensor launches
    the `lpc_autocorr` kernel (no window, one unit). Any other takes the
    plain routes: a lag scan (one pass over the signal per lag) for few
    lags, the Wiener-Khinchin FFT route for many, and under the matrix-unit
    override (`_MATMUL_ROUTES_OVERRIDE`) the chunked G-matrix product from
    9 lags (npu >= 8) while its G tensor stays within
    _MATMUL_BYTES_BUDGET."""
    if x.is_cuda:
        batch_shape = tuple(x.shape[:-1])
        ac = analysis_scans.lpc_autocorr(x.reshape(-1, x.shape[-1]),
                                          [(0, num_lags, None)])[0]
        return ac.reshape(batch_shape + (num_lags,))
    return _autocorrelation_plain(x, num_lags)


def _autocorrelation_plain(x: torch.Tensor, num_lags: int) -> torch.Tensor:
    """autocorrelation's plain routes on any device (on a card: the
    matrix-unit route by default, which the kernel replaced)."""
    n = x.shape[-1]
    if 9 <= num_lags <= _CHUNK + 1 and _use_matmul_routes(x):
        g_bytes = _rows(x) * _CHUNK * (_CHUNK + num_lags - 1) * 4
        if g_bytes <= _MATMUL_BYTES_BUDGET:
            return _autocorr_matmul(x, num_lags)
    if num_lags >= _FFT_AUTOCORR_MIN_LAGS:
        fft_n = 1
        while fft_n < n + num_lags:
            fft_n <<= 1
        batch_shape = tuple(x.shape[:-1])
        xp = F.pad(x.reshape(-1, n), (0, fft_n - n))
        spec = torch.fft.rfft(xp, dim=-1)
        power = (spec * torch.conj(spec)).real
        ac = torch.fft.irfft(power, n=fft_n, dim=-1)[:, :num_lags]
        return ac.reshape(batch_shape + (num_lags,)).to(x.dtype)
    xp = F.pad(x, (0, num_lags))
    return torch.stack(
        [torch.sum(x * xp[..., lag : lag + n], dim=-1)
         for lag in range(num_lags)], dim=-1)


def levinson_durbin(ac: torch.Tensor, order: int, with_parcor: bool = False):
    """Batched Levinson-Durbin recursion (reference: lpc.c:252-324).

    ac: [..., order+1] autocorrelation (ridge already applied to lag 0).
    Returns lpc[..., order] (prediction coefficients a_1..a_order, sign
    convention as the reference: residual = x + sum a_i * x_{t-i}); if
    with_parcor, also parcor[..., order] (parcor[k] = -gamma_k).
    The caller's `ac` is not written. A CPU tensor takes
    `_levinson_durbin_plain`; any other launches the kernel or raises.
    """
    if ac.device.type == "cpu":
        return _levinson_durbin_plain(ac, order, with_parcor)
    batch_shape = tuple(ac.shape[:-1])
    out = analysis_scans.levinson_durbin(
        ac.reshape(-1, ac.shape[-1]).contiguous(), order, with_parcor)
    if with_parcor:
        return tuple(t.reshape(batch_shape + (order,)) for t in out)
    return out.reshape(batch_shape + (order,))


def _levinson_durbin_plain(ac: torch.Tensor, order: int,
                           with_parcor: bool = False):
    """levinson_durbin as batched torch ops, a Python loop over the order:
    the kernel's plain version."""
    batch_shape = tuple(ac.shape[:-1])
    silent = torch.abs(ac[..., 0]) < FLT_EPSILON
    ac = torch.cat([torch.where(silent, 1.0, ac[..., 0]).unsqueeze(-1),
                    ac[..., 1:]], dim=-1)

    # zero-padded reversed ac for the gamma gather: acp[order - k - 1 + i]
    # == ac[k+1-i] for k+1-i in range, else 0
    acp = torch.cat([torch.flip(ac, [-1]),
                     ac.new_zeros(batch_shape + (order,))], dim=-1)
    zeros_a = ac.new_zeros(batch_shape + (order + 1,))
    a = zeros_a.clone()
    a[..., 0].fill_(1.0)  # no host scalar tensor: capturable
    ek = ac[..., 0]
    neg_gammas = []
    for k in range(order):
        s = acp[..., order - k - 1 : 2 * order - k]
        num = torch.sum(a * s, dim=-1)
        gamma = torch.where(torch.abs(ek) > 0,
                            num / -torch.where(ek == 0, 1.0, ek), 0.0)
        ek = ek * (1.0 - gamma * gamma)
        # a_new[i] = a[i] + gamma * a[k+1-i] (a[k+1-i] -> 0 out of range)
        ap = torch.cat([torch.flip(a, [-1]), zeros_a], dim=-1)
        rev = ap[..., order - k - 1 : 2 * order - k]
        a = a + gamma.unsqueeze(-1) * rev
        neg_gammas.append(-gamma)
    lpc = torch.where(silent.unsqueeze(-1), 0.0, a[..., 1:])
    if with_parcor:
        parcor = torch.stack(neg_gammas, dim=-1)
        parcor = torch.where(silent.unsqueeze(-1), 0.0, parcor)
        return lpc, parcor
    return lpc


def unit_autocorrelations(signal: torch.Tensor, splits, window_type: int,
                          windows: dict | None = None) -> list:
    """The windowed autocorrelation of each unit split of signal [..., n]:
    for each (units, lags) of `splits`, ac[..., units, lags] of the n /
    units samples of each unit times the window of that many taps
    (`window_type`, kept in `windows`: see _window). A CPU tensor takes
    `_unit_autocorrelations_plain`; any other launches the `lpc_autocorr`
    kernel once for all the splits (a leading axis of stride 0, the
    ridges expanded over a layer's input, is read once and the result
    expanded over it) or raises."""
    if signal.device.type == "cpu":
        return _unit_autocorrelations_plain(signal, splits, window_type,
                                            windows)
    return _unit_autocorrelations_launch(signal, splits, window_type,
                                         windows)


def _unit_autocorrelations_launch(signal: torch.Tensor, splits,
                                  window_type: int,
                                  windows: dict | None = None) -> list:
    """unit_autocorrelations through `analysis_scans.lpc_autocorr`: the
    distinct rows of signal [..., n] (a leading axis of stride 0 read
    once), one launch, each split's result in signal's batch shape."""
    n = signal.shape[-1]
    lead = tuple(signal.shape[:-1])
    base = signal
    if signal.dim() > 1 and signal.shape[0] > 1 and signal.stride(0) == 0:
        base = signal[:1]
    acs = analysis_scans.lpc_autocorr(
        base.reshape(-1, n),
        [((u - 1).bit_length(), lags,
          _window(window_type, n // u, signal, windows))
         for u, lags in splits])
    return [ac.reshape(tuple(base.shape[:-1]) + (u, lags)).expand(
        lead + (u, lags)) for ac, (u, lags) in zip(acs, splits)]


def _unit_autocorrelations_plain(signal: torch.Tensor, splits,
                                 window_type: int,
                                 windows: dict | None = None) -> list:
    """unit_autocorrelations as torch ops, a split at a time: each unit
    multiplied by the window, then `autocorrelation`'s plain routes (on a
    card the matrix-unit route, the pass the kernel replaced). The kernel's
    plain version."""
    n = signal.shape[-1]
    out = []
    for units, lags in splits:
        ns = n // units
        seg = signal.reshape(tuple(signal.shape[:-1]) + (units, ns))
        windowed = seg * _window(window_type, ns, signal, windows)
        out.append(_autocorrelation_plain(windowed, lags))
    return out


def fit_unit_lpc(
    signal: torch.Tensor, num_units: int, order_per_unit: int,
    regular_term, windows: dict | None = None,
) -> torch.Tensor:
    """Per-unit Welch-windowed LPC fit of one unit-split candidate.

    signal: [..., n]; regular_term: scalar or tensor broadcastable over the
    batch dims (a [R, 1, 1, 1] ridge axis rides through as a batch
    dimension). Returns reversed (convolution-layout) coefficients
    [..., num_units, order_per_unit] matching the reference's parameter
    ordering (linne_network.c:310-316: h[0] oldest ... h[np-1] newest).
    `windows` keeps the Welch windows (see _window).
    """
    ac, = unit_autocorrelations(signal, [(num_units, order_per_unit + 1)],
                                WINDOW_WELCH, windows)
    return _unit_lpc(ac, signal.shape[-1] // num_units, regular_term)


def _unit_lpc(ac: torch.Tensor, ns: int, regular_term) -> torch.Tensor:
    """fit_unit_lpc from a candidate's ac [..., units, order_per_unit + 1]
    (units of ns samples): the ridge on lag 0, the recursion, zero
    coefficients for a degenerate split, the reversed layout."""
    order_per_unit = ac.shape[-1] - 1
    ridge = 1.0 + torch.as_tensor(regular_term, dtype=ac.dtype,
                                  device=ac.device)
    ac = torch.cat([(ac[..., 0] * ridge).unsqueeze(-1), ac[..., 1:]], dim=-1)
    lpc = levinson_durbin(ac, order_per_unit)
    if ns < order_per_unit:  # degenerate split -> zero coefficients
        lpc = torch.zeros_like(lpc)
    return torch.flip(lpc, [-1])


def unit_forward(
    signal: torch.Tensor, params: torch.Tensor, num_units: int,
) -> torch.Tensor:
    """Residual of a unit-split convolution layer: out[t] = x[t] +
    sum_j P[unit(t), j] * x[t - npu + j], with zero history before t=0 and
    cross-unit context exactly like the reference pointer arithmetic
    (linne_network.c:183-208). Sample 0 passes through.

    signal: [..., n]; params: [..., num_units, npu] (reversed layout).
    """
    n = signal.shape[-1]
    npu = params.shape[-1]
    ns = n // num_units
    if npu >= 8 and _use_matmul_routes(signal):
        w = _CHUNK + npu - 1
        hmat_bytes = _rows(signal) * num_units * w * _CHUNK * 4
        if hmat_bytes <= _MATMUL_BYTES_BUDGET:
            return _unit_forward_matmul(signal, params, num_units)
    if npu >= _FFT_AUTOCORR_MIN_LAGS:
        return _unit_forward_fft(signal, params, num_units)
    return _unit_forward_loop(signal, params, num_units)


def _unit_forward_loop(signal: torch.Tensor, params: torch.Tensor,
                       num_units: int) -> torch.Tensor:
    """unit_forward as a loop over the taps, each product rounded and added
    to the prediction in tap order: the route of few taps, and the sums
    the `unit_residual_select` kernel repeats bit for bit."""
    n = signal.shape[-1]
    npu = params.shape[-1]
    ns = n // num_units
    xp = F.pad(signal, (npu, 0))
    pred = torch.zeros_like(signal)
    for j in range(npu):
        # per-step coefficient row, expanded over each unit's segment
        coef = torch.repeat_interleave(params[..., j], ns, dim=-1)
        pred = pred + coef * xp[..., j : j + n]
    out = signal + pred
    return torch.cat([signal[..., :1], out[..., 1:]], dim=-1)


def _unit_forward_fft(signal: torch.Tensor, params: torch.Tensor,
                      num_units: int) -> torch.Tensor:
    """unit_forward via FFT correlation: pred over a unit is the correlation
    of its (left-context-extended) segment with its filter."""
    n = signal.shape[-1]
    npu = params.shape[-1]
    ns = n // num_units
    batch_shape = tuple(signal.shape[:-1])
    seg_len = ns + npu
    fft_n = 1
    while fft_n < seg_len:
        fft_n <<= 1
    # ctx[u, t] = x[u*ns - npu + t], zero history before t=0
    xp = F.pad(signal, (npu, 0))
    idx = (torch.arange(num_units, device=signal.device)[:, None] * ns
           + torch.arange(seg_len, device=signal.device)[None, :])
    ctx = xp[..., idx]  # [..., u, seg_len]
    flat_ctx = F.pad(ctx.reshape(-1, seg_len), (0, fft_n - seg_len))
    pflat = params.expand(batch_shape + (num_units, npu))
    flat_p = F.pad(pflat.reshape(-1, npu), (0, fft_n - npu))
    spec = torch.fft.rfft(flat_ctx, dim=-1) * torch.conj(
        torch.fft.rfft(flat_p, dim=-1))
    corr = torch.fft.irfft(spec, n=fft_n, dim=-1)[:, :ns]
    pred = corr.reshape(batch_shape + (n,)).to(signal.dtype)
    out = signal + pred
    return torch.cat([signal[..., :1], out[..., 1:]], dim=-1)


def _unit_forward_matmul(signal: torch.Tensor, params: torch.Tensor,
                         num_units: int) -> torch.Tensor:
    """unit_forward as one batched product: each unit's left-context-
    extended segment in K-output windows Xc [m, K+npu-1], times a per-row
    Toeplitz expansion of the filter H [K+npu-1, K] (H[w, r] = h[w-r]);
    the prediction chunks are Xc @ H."""
    n = signal.shape[-1]
    npu = params.shape[-1]
    ns = n // num_units
    batch_shape = tuple(signal.shape[:-1])
    K = _CHUNK
    m = -(-ns // K)
    w = K + npu - 1
    seg_len = ns + npu
    # ctx[u, t] = x[u*ns - npu + t], zero history before t=0 (the FFT
    # route's layout); padded so the last chunk's window stays in bounds
    xp = F.pad(signal, (npu, 0))
    ctx = xp.unfold(-1, seg_len, ns)  # [..., u, seg_len]
    pad_tail = (m - 1) * K + w - seg_len
    if pad_tail > 0:
        ctx = F.pad(ctx, (0, pad_tail))
    xc = ctx.unfold(-1, w, K)  # [..., u, m, w]
    # H[w_, r] = h[w_ - r] for 0 <= w_ - r < npu else 0: with hz the
    # filter between K-1 zeros on each side, window s of hz is hz[s + r'],
    # so H is those w windows with r' = K-1-r reversed (the reference
    # gathers the same values; windows keep the training's backward a
    # fold instead of an indexed scatter)
    hz = F.pad(params.expand(batch_shape + (num_units, npu)), (K - 1, K - 1))
    hmat = hz.unfold(-1, K, 1).flip(-1)  # [..., u, w, K]
    pred = torch.einsum("...umw,...uwk->...umk", xc, hmat)
    pred = pred.reshape(batch_shape + (num_units, m * K))[..., :ns]
    pred = pred.reshape(batch_shape + (num_units * ns,)).to(signal.dtype)
    out = signal + pred
    return torch.cat([signal[..., :1], out[..., 1:]], dim=-1)


def candidate_units(order: int, n: int, max_units: int = 128) -> list:
    """Static list of unit counts the reference would try
    (linne_network.c:284-295): powers of two dividing both the layer order
    and the analysis length, capped at 128."""
    cands = []
    u = 1
    while u <= min(max_units, order):
        if order % u == 0 and n % u == 0 and (n // u) > (order // u):
            cands.append(u)
        u <<= 1
    return cands


def fit_layer(signal: torch.Tensor, order: int, regular_term,
              windows: dict | None = None):
    """Unit-count search + fit for one layer over a batched signal.

    Fits every candidate split (their autocorrelations from one
    `unit_autocorrelations` call), scores mean |residual| excluding sample
    0 (linne_network.c:319-337), picks the first minimum
    (`unit_residual_select`). Returns (log2_units[...], flat_params[...,
    order], residual[..., n], loss[...]). `windows` keeps the Welch
    windows (see _window).
    """
    n = signal.shape[-1]
    units = candidate_units(order, n)
    acs = unit_autocorrelations(signal, [(u, order // u + 1) for u in units],
                                WINDOW_WELCH, windows)
    params = [_unit_lpc(ac, n // u, regular_term)
              for ac, u in zip(acs, units)]
    return unit_residual_select(signal, params, units)


def unit_residual_select(signal: torch.Tensor, params: Sequence[torch.Tensor],
                         units: Sequence[int]):
    """The residual pass of a layer's unit-count sweep: each candidate
    split's residual (unit_forward of signal [..., n] by params[i]
    [..., units[i], order / units[i]], fit_unit_lpc's layout), its loss
    (sum of |residual| without sample 0, over n) and the first minimum
    over the candidates in the given order (strict <: ties keep the
    earlier split, a NaN loss never wins nor is replaced). Returns
    (log2_units[...] int32, flat_params[..., order], residual[..., n],
    loss[...]) of the winners. A CPU tensor takes
    `_unit_residual_select_plain`; any other launches the kernel once (its
    residuals are `_unit_forward_loop`'s bits, its loss agrees to
    rounding) or raises. The leading axis (the ridges) may be expanded:
    it is read, not copied."""
    if signal.device.type == "cpu":
        return _unit_residual_select_plain(signal, params, units)
    n = signal.shape[-1]
    batch_shape = tuple(signal.shape[:-1])
    order = params[0].shape[-1] * units[0]
    x = signal.reshape((batch_shape[0] if batch_shape else 1, -1, n))
    rows = x.shape[0] * x.shape[1]
    log2u, flat, res, loss = analysis_scans.unit_residual_select(
        x, [p.expand(batch_shape + tuple(p.shape[-2:])).reshape(rows, order)
            for p in params],
        [(u - 1).bit_length() for u in units])
    return (log2u.reshape(batch_shape), flat.reshape(batch_shape + (order,)),
            res.reshape(batch_shape + (n,)), loss.reshape(batch_shape))


def _unit_residual_select_plain(signal: torch.Tensor,
                                params: Sequence[torch.Tensor],
                                units: Sequence[int]):
    """unit_residual_select as batched torch ops, a Python loop over the
    candidates: the kernel's plain version."""
    n = signal.shape[-1]
    best_loss = best_flat = best_res = best_log2u = None
    for p, u in zip(params, units):
        res = unit_forward(signal, p, u)
        loss = torch.sum(torch.abs(res[..., 1:]), dim=-1) / n
        flat = p.reshape(tuple(p.shape[:-2]) + (-1,))
        log2u = torch.full(loss.shape, (u - 1).bit_length(),
                           dtype=torch.int32, device=signal.device)
        if best_loss is None:
            best_loss, best_flat, best_res, best_log2u = (
                loss, flat, res, log2u)
        else:
            better = loss < best_loss  # strict: ties keep the earlier split
            best_loss = torch.where(better, loss, best_loss)
            best_flat = torch.where(better.unsqueeze(-1), flat, best_flat)
            best_res = torch.where(better.unsqueeze(-1), res, best_res)
            best_log2u = torch.where(better, log2u, best_log2u)
    return best_log2u, best_flat, best_res, best_loss


def take_ridge(t: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """t[best[...], ...] along the leading ridge axis of t [R, ..., (K)]."""
    idx = best.long().unsqueeze(0)
    if t.dim() > best.dim() + 1:
        idx = idx.unsqueeze(-1).expand((1,) + tuple(t.shape[1:]))
    return torch.gather(t, 0, idx)[0]


def fit_network(
    signal: torch.Tensor, layer_orders: Sequence[int],
    ridge_terms: Sequence[float],
):
    """Full ridge-sweep greedy network fit (the batched analog of
    LINNENetwork_SetUnitsAndParameters, linne_network.c:605-630).

    signal: [..., n] normalized float. Returns per-layer
    (log2_units[...] list, params[..., order] list) selected from the best
    ridge candidate per batch element.
    """
    nridge = len(ridge_terms)
    x = signal.unsqueeze(0).expand((nridge,) + tuple(signal.shape))
    ridge_vec = torch.tensor(list(ridge_terms), dtype=signal.dtype,
                             device=signal.device).reshape(
        (nridge,) + (1,) * signal.dim())  # broadcasts over [..., u]
    layers = []
    for order in layer_orders:
        log2u, flat, res, _ = fit_layer(x, order, ridge_vec)
        layers.append((log2u, flat))
        x = res
    loss = torch.sum(torch.abs(x), dim=-1) / x.shape[-1]  # [R, ...batch]
    best = torch.argmin(loss, dim=0)  # first minimum, as in C
    return ([take_ridge(l, best) for l, _ in layers],
            [take_ridge(f, best) for _, f in layers])


def quantize_coefficients(coefs: torch.Tensor, nbits: int = 8):
    """Batched error-feedback quantizer (reference: lpc.c:981-1040).

    coefs: [..., order] float. Returns (int_coef[..., order] int32,
    rshift[...] int32). A CPU tensor takes `_quantize_coefficients_plain`;
    any other launches the kernel (bit-equal to it) or raises."""
    if coefs.device.type == "cpu":
        return _quantize_coefficients_plain(coefs, nbits)
    batch_shape = tuple(coefs.shape[:-1])
    order = coefs.shape[-1]
    int_coef, rshift = analysis_scans.quantize_coefficients(
        coefs.reshape(-1, order).contiguous(), nbits)
    return (int_coef.reshape(batch_shape + (order,)),
            rshift.reshape(batch_shape))


def quantize_layers(coefs: Sequence[torch.Tensor], nbits: int = 8):
    """quantize_coefficients on every layer of a batch at once.

    coefs: 1..4 layers [..., order_l] float (the same batch shape).
    Returns (int_coef[..., sum of orders] int32, the layers side by side
    in the given order; rshift[layers, ...] int32). CPU tensors take
    `_quantize_layers_plain`; any other launches the kernel once (bit-equal
    to it) or raises."""
    if coefs[0].device.type == "cpu":
        return _quantize_layers_plain(coefs, nbits)
    batch_shape = tuple(coefs[0].shape[:-1])
    int_coef, rshift = analysis_scans.quantize_layers(
        [c.reshape(-1, c.shape[-1]) for c in coefs], nbits)
    return (int_coef.reshape(batch_shape + (-1,)),
            rshift.reshape((len(coefs),) + batch_shape))


def _quantize_layers_plain(coefs: Sequence[torch.Tensor], nbits: int = 8):
    """quantize_layers as `_quantize_coefficients_plain` a layer: the
    grouped kernel's plain version."""
    outs = [_quantize_coefficients_plain(c, nbits) for c in coefs]
    return (torch.cat([q for q, _ in outs], dim=-1),
            torch.stack([r for _, r in outs]))


def _quantize_coefficients_plain(coefs: torch.Tensor, nbits: int = 8):
    """quantize_coefficients as batched torch ops, a Python loop over the
    taps: the kernel's plain version."""
    order = coefs.shape[-1]
    qmax = 1 << (nbits - 1)
    max_abs = torch.amax(torch.abs(coefs), dim=-1)
    is_zero = max_abs <= 2.0 ** (-(nbits - 1))
    _, exp = torch.frexp(torch.where(is_zero, 1.0, max_abs))
    rshift = torch.clamp((nbits - 1) - exp, 1, 15).to(torch.int32)
    scale = torch.exp2(rshift.to(coefs.dtype))

    qerror = coefs.new_zeros(coefs.shape[:-1])
    qs = [None] * order
    for t in range(order - 1, -1, -1):
        qerror = qerror + coefs[..., t] * scale
        # round half away from zero (torch.round rounds half to even)
        q = torch.where(qerror >= 0.0, torch.floor(qerror + 0.5),
                        -torch.floor(-qerror + 0.5))
        q = torch.clamp(q, -qmax, qmax - 1)
        qerror = qerror - q
        qs[t] = q.to(torch.int32)
    int_coef = torch.where(is_zero.unsqueeze(-1), 0,
                           torch.stack(qs, dim=-1))
    rshift = torch.where(is_zero, nbits, rshift)
    return int_coef, rshift


def estimate_code_length(
    signal: torch.Tensor, order: int, bits_per_sample: int,
    windows: dict | None = None,
) -> torch.Tensor:
    """Batched bits/sample estimate for the block-type decision
    (reference: lpc.c:810-865). signal: [..., n] normalized float;
    `windows` keeps the sine window (see _window)."""
    n = signal.shape[-1]
    ac = unit_autocorrelations(signal, [(1, order + 1)], WINDOW_SIN,
                               windows)[0][..., 0, :]
    _, parcor = levinson_durbin(ac, order, with_parcor=True)
    power = ac[..., 0] * 2.0 ** (2.0 * (bits_per_sample - 1))
    log2_power = torch.log2(torch.clamp(power, min=1e-300)) - np.log2(n)
    # indices 1..order-1; the reference also reads the stale [order] entry,
    # which the fast path treats as 0 (analysis-only deviation)
    pk = parcor[..., 1:]
    log2_var = torch.sum(torch.log2(torch.clamp(1.0 - pk * pk, min=1e-30)),
                         dim=-1)
    beta = 1.9426950408889634
    est = beta + 0.5 * (log2_power + log2_var)
    return torch.where(power == 0.0, 0.0, torch.where(est <= 0, 1.0, est))
