"""Batched analysis ops: autocorrelation, Levinson-Durbin, unit search,
quantizer. Counterpart of linne_tpu/ops/analysis.py.

Every level of the reference's nested per-block loops (ridge candidates x
layers x unit counts x units; reference call stack:
LINNENetwork_SetUnitsAndParameters, linne_network.c:582-630) is a batch
dimension of one tensor computation over [ridges, blocks, channels, ...].
The recursions over taps or orders (`lax.scan` in the reference) are, on
a CUDA tensor, one launch each of a hand-written kernel
(ops/analysis_scans.py, csrc/analysis_scans.cu) and, on a CPU tensor,
their plain versions here: Python loops of batched tensor ops
(`_levinson_durbin_plain`, `_quantize_coefficients_plain`).

Routes, as in the reference: a lag scan (one pass over the signal per lag
or tap) for few lags, an FFT (torch.fft) at 32 and above, and the
matrix-unit routes (`_autocorr_matmul`, `_unit_forward_matmul`: one batched
float64 product each, on the H100's FP64 tensor cores) from 9 lags / 8 taps
up, under a bound on what they materialize. The reference takes the
matrix-unit routes where a matrix unit exists and keeps the lag/FFT routes
on the CPU; `_use_matmul_routes` says which here. The routes compute the
same quantity; only float rounding differs, which can shift a chosen
coefficient, never losslessness.

Winners are picked with first-minimum semantics, as the reference's
strict-< selection: a running `loss < best` fold over unit candidates and
`torch.argmin` (first index on ties) over ridges.
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


def _window(window_type: int, n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(window_weights(window_type, n), dtype=like.dtype,
                           device=like.device)


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
    sum_t x[t] * x[t+lag] for lag in [0, num_lags). A lag scan (one pass
    over the signal per lag) for few lags, the Wiener-Khinchin FFT route
    for many, and on a matrix unit the chunked G-matrix product from 9
    lags (npu >= 8) while its G tensor stays within _MATMUL_BYTES_BUDGET."""
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
    a[..., 0] = 1.0
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


def fit_unit_lpc(
    signal: torch.Tensor, num_units: int, order_per_unit: int,
    regular_term,
) -> torch.Tensor:
    """Per-unit Welch-windowed LPC fit of one unit-split candidate.

    signal: [..., n]; regular_term: scalar or tensor broadcastable over the
    batch dims (a [R, 1, 1, 1] ridge axis rides through as a batch
    dimension). Returns reversed (convolution-layout) coefficients
    [..., num_units, order_per_unit] matching the reference's parameter
    ordering (linne_network.c:310-316: h[0] oldest ... h[np-1] newest).
    """
    n = signal.shape[-1]
    ns = n // num_units
    seg = signal.reshape(tuple(signal.shape[:-1]) + (num_units, ns))
    windowed = seg * _window(WINDOW_WELCH, ns, signal)
    ac = autocorrelation(windowed, order_per_unit + 1)
    ridge = 1.0 + torch.as_tensor(regular_term, dtype=signal.dtype,
                                  device=signal.device)
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


def fit_layer(signal: torch.Tensor, order: int, regular_term):
    """Unit-count search + fit for one layer over a batched signal.

    Evaluates every candidate split, scores mean |residual| excluding sample
    0 (linne_network.c:319-337), picks the first minimum. Returns
    (log2_units[...], flat_params[..., order], residual[..., n], loss[...]).
    """
    n = signal.shape[-1]
    best_loss = best_flat = best_res = best_log2u = None
    for u in candidate_units(order, n):
        params = fit_unit_lpc(signal, u, order // u, regular_term)
        res = unit_forward(signal, params, u)
        loss = torch.sum(torch.abs(res[..., 1:]), dim=-1) / n
        flat = params.reshape(tuple(params.shape[:-2]) + (order,))
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
) -> torch.Tensor:
    """Batched bits/sample estimate for the block-type decision
    (reference: lpc.c:810-865). signal: [..., n] normalized float."""
    n = signal.shape[-1]
    windowed = signal * _window(WINDOW_SIN, n, signal)
    ac = autocorrelation(windowed, order + 1)
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
