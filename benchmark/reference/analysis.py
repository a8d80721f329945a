"""The batched encoder's analysis in plain PyTorch: what side information a
full block gets, worked out from its samples alone.

This is the algorithm of the port's batched encode (the JAX package's
batched analysis, which the port keeps byte for byte), written out with
plain tensor ops and no kernel: the block-type estimate, mid/side and two
pre-emphasis stages, for every ridge term the greedy layer cascade (each
layer tries every unit count and keeps the first minimum of its mean
absolute residual), the ridge term with the least final residual, the
error-feedback quantizer, the integer prediction cascade and the
partitioned Rice parameter search. Recursions run as Python loops over
the order; autocorrelations and layer residuals take the lag scan below
32 lags or taps and the FFT from 32. `dtype` is the float type of the
analysis: float64 as the configuration states, float32 for the control.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import integer

FLT_EPSILON = 2.0 ** -23
RAW_THRESHOLD = float(np.float32(0.95))
COEF_BITS = 8
LOG2_MAX_PARTITIONS = 10
RICE_PARAM_BITS = 5
_FFT_MIN = 32
_OPTX = 0.5127629514437670454896078808815218508243560791015625
_LOG_OPTX = math.log(_OPTX)
_MASK32 = 0xFFFFFFFF


class SideInfo(NamedTuple):
    """Per block [B, ...]: what a stream's block carries."""
    block_type: torch.Tensor  # [B] 0 compress, 1 silent, 2 raw
    pprev: torch.Tensor       # [B, C, 2]
    pcoef: torch.Tensor       # [B, C, 2]
    log2u: torch.Tensor       # [B, C, L]
    rshift: torch.Tensor      # [B, C, L]
    coefs: torch.Tensor       # [B, C, sum of orders]
    porder: torch.Tensor      # [B, C]
    k2: torch.Tensor          # [B, C, 2^porder], -1 past the partitions


def sin_window(n: int, dtype, device) -> torch.Tensor:
    s = np.arange(n)
    return torch.as_tensor(np.sin(np.pi * s / (n - 1)), dtype=dtype,
                           device=device)


def welch_window(n: int, dtype, device) -> torch.Tensor:
    s = np.arange(n, dtype=np.float64)
    w = 4.0 * (n - 1) ** -2.0 * s * (n - 1 - s)
    return torch.as_tensor(w, dtype=dtype, device=device)


def autocorrelation(x: torch.Tensor, lags: int) -> torch.Tensor:
    n = x.shape[-1]
    if lags >= _FFT_MIN:
        m = 1
        while m < n + lags:
            m <<= 1
        spec = torch.fft.rfft(F.pad(x, (0, m - n)), dim=-1)
        return torch.fft.irfft((spec * spec.conj()).real, n=m,
                               dim=-1)[..., :lags]
    xp = F.pad(x, (0, lags))
    return torch.stack([torch.sum(x * xp[..., k : k + n], dim=-1)
                        for k in range(lags)], dim=-1)


def levinson(ac: torch.Tensor, order: int):
    """Levinson-Durbin on [..., order + 1] autocorrelations: (a_1..a_order
    with residual = x + sum a_i x_{t-i}, parcor)."""
    silent = torch.abs(ac[..., 0]) < FLT_EPSILON
    r = torch.cat([torch.where(silent, 1.0, ac[..., 0]).unsqueeze(-1),
                   ac[..., 1:]], dim=-1)
    a = torch.zeros(ac.shape[:-1] + (order + 1,), dtype=ac.dtype,
                    device=ac.device)
    a[..., 0] = 1.0
    e = r[..., 0]
    parcor = []
    for k in range(order):
        num = torch.sum(a[..., : k + 1] * torch.flip(r[..., 1 : k + 2], [-1]),
                        dim=-1)
        gamma = torch.where(torch.abs(e) > 0,
                            num / -torch.where(e == 0, 1.0, e), 0.0)
        e = e * (1.0 - gamma * gamma)
        upd = a[..., 1 : k + 2] + gamma.unsqueeze(-1) * torch.flip(
            a[..., : k + 1], [-1])
        a = torch.cat([a[..., :1], upd, a[..., k + 2 :]], dim=-1)
        parcor.append(-gamma)
    lpc = torch.where(silent.unsqueeze(-1), 0.0, a[..., 1:])
    par = torch.where(silent.unsqueeze(-1), 0.0, torch.stack(parcor, -1))
    return lpc, par


def estimate_bits(sig: torch.Tensor, order: int, bps: int) -> torch.Tensor:
    """Estimated bits a sample of each [..., n] row would take."""
    n = sig.shape[-1]
    ac = autocorrelation(sig * sin_window(n, sig.dtype, sig.device),
                         order + 1)
    _, parcor = levinson(ac, order)
    power = ac[..., 0] * 2.0 ** (2.0 * (bps - 1))
    log2_power = torch.log2(torch.clamp(power, min=1e-300)) - np.log2(n)
    pk = parcor[..., 1:]
    log2_var = torch.sum(torch.log2(torch.clamp(1.0 - pk * pk, min=1e-30)),
                         dim=-1)
    est = 1.9426950408889634 + 0.5 * (log2_power + log2_var)
    return torch.where(power == 0.0, 0.0, torch.where(est <= 0, 1.0, est))


def preemphasis_coef(x: torch.Tensor, dtype) -> torch.Tensor:
    d = x.to(dtype)
    c0 = torch.sum(d[..., :-1] * d[..., :-1], dim=-1)
    c1 = torch.sum(d[..., :-1] * d[..., 1:], dim=-1)
    ratio = c1 / torch.where(c0 == 0, 1.0, c0)
    coef = torch.clamp(torch.floor(ratio * 32.0 + 0.5), max=15).to(torch.int64)
    return torch.where((c0 < 1e-6) | (ratio < 0.0), 0, coef)


def unit_counts(order: int, n: int) -> list:
    """Unit counts a layer tries: powers of two up to 128 dividing the
    order and the length, with more samples than taps in a unit."""
    out, u = [], 1
    while u <= min(128, order):
        if order % u == 0 and n % u == 0 and n // u > order // u:
            out.append(u)
        u <<= 1
    return out


def fit_units(sig: torch.Tensor, u: int, npu: int,
              ridge: torch.Tensor) -> torch.Tensor:
    """Each unit's Welch-windowed LPC with the ridge on lag 0; taps
    oldest first: [..., u, npu]."""
    n = sig.shape[-1]
    ns = n // u
    seg = sig.reshape(sig.shape[:-1] + (u, ns))
    ac = autocorrelation(seg * welch_window(ns, sig.dtype, sig.device),
                         npu + 1)
    ac = torch.cat([(ac[..., 0] * (1.0 + ridge)).unsqueeze(-1), ac[..., 1:]],
                   dim=-1)
    lpc, _ = levinson(ac, npu)
    if ns < npu:
        lpc = torch.zeros_like(lpc)
    return torch.flip(lpc, [-1])


def unit_residual(sig: torch.Tensor, params: torch.Tensor,
                  u: int) -> torch.Tensor:
    """x[t] + sum_j P[unit(t), j] x[t - npu + j], zero history, sample 0
    passed through."""
    n = sig.shape[-1]
    npu = params.shape[-1]
    ns = n // u
    if npu >= _FFT_MIN:
        m = 1
        while m < ns + npu:
            m <<= 1
        xp = F.pad(sig, (npu, 0))
        idx = (torch.arange(u, device=sig.device)[:, None] * ns
               + torch.arange(ns + npu, device=sig.device)[None, :])
        ctx = xp[..., idx]
        spec = (torch.fft.rfft(F.pad(ctx, (0, m - ns - npu)), dim=-1)
                * torch.conj(torch.fft.rfft(
                    F.pad(params.expand(ctx.shape[:-1] + (npu,)),
                          (0, m - npu)), dim=-1)))
        pred = torch.fft.irfft(spec, n=m, dim=-1)[..., :ns].reshape(
            sig.shape)
    else:
        xp = F.pad(sig, (npu, 0))
        pred = torch.zeros_like(sig)
        for j in range(npu):
            coef = torch.repeat_interleave(params[..., j], ns, dim=-1)
            pred = pred + coef * xp[..., j : j + n]
    out = sig + pred
    return torch.cat([sig[..., :1], out[..., 1:]], dim=-1)


def fit_layer(sig: torch.Tensor, order: int, ridge: torch.Tensor):
    n = sig.shape[-1]
    best = None
    for u in unit_counts(order, n):
        params = fit_units(sig, u, order // u, ridge)
        res = unit_residual(sig, params, u)
        loss = torch.sum(torch.abs(res[..., 1:]), dim=-1) / n
        flat = params.reshape(params.shape[:-2] + (order,))
        l2 = torch.full(loss.shape, (u - 1).bit_length(), dtype=torch.int64,
                        device=sig.device)
        if best is None:
            best = [loss, flat, res, l2]
        else:
            better = loss < best[0]
            best = [torch.where(better, loss, best[0]),
                    torch.where(better.unsqueeze(-1), flat, best[1]),
                    torch.where(better.unsqueeze(-1), res, best[2]),
                    torch.where(better, l2, best[3])]
    return best[3], best[1], best[2]


def quantize(coefs: torch.Tensor):
    """Error-feedback quantizer to 8-bit coefficients: (int coefs, shift),
    the newest tap first, rounding half away from zero."""
    order = coefs.shape[-1]
    qmax = 1 << (COEF_BITS - 1)
    max_abs = torch.amax(torch.abs(coefs), dim=-1)
    zero = max_abs <= 2.0 ** (-(COEF_BITS - 1))
    _, ex = torch.frexp(torch.where(zero, 1.0, max_abs))
    shift = torch.clamp((COEF_BITS - 1) - ex, 1, 15).to(torch.int64)
    scale = torch.exp2(shift.to(coefs.dtype))
    err = torch.zeros(coefs.shape[:-1], dtype=coefs.dtype,
                      device=coefs.device)
    q = [None] * order
    for t in range(order - 1, -1, -1):
        err = err + coefs[..., t] * scale
        v = torch.where(err >= 0.0, torch.floor(err + 0.5),
                        -torch.floor(-err + 0.5))
        v = torch.clamp(v, -qmax, qmax - 1)
        err = err - v
        q[t] = v.to(torch.int64)
    ints = torch.where(zero.unsqueeze(-1), 0, torch.stack(q, dim=-1))
    return ints, torch.where(zero, COEF_BITS, shift)


def max_porder(n: int) -> int:
    p = 1
    while n % (1 << p) == 0:
        p += 1
    return min(p - 1, LOG2_MAX_PARTITIONS)


def rice_search(x: torch.Tensor, dtype):
    """Partition order and per-partition Rice parameters minimising the
    coded bits of int residual rows x [..., n] (first minimum in
    ascending order). Returns (porder [...], k2 [..., 2^porder] padded
    with -1)."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    mp = max_porder(n)
    u = torch.where(x < 0, -2 * x - 1, 2 * x)
    sums = torch.sum(u.to(dtype).reshape(lead + (1 << mp, n >> mp)), dim=-1)
    totals, ks = [], []
    for po in range(mp, -1, -1):
        parts = 1 << po
        nsmpl = n >> po
        mean = sums / nsmpl
        rho = 1.0 / (1.0 + mean)
        log1m = torch.log(torch.clamp(1.0 - rho, min=1e-300))
        k2 = torch.floor(torch.log2(torch.clamp(_LOG_OPTX / log1m,
                                                min=1e-300)))
        k2 = torch.where(mean <= 0.0, 0.0, torch.clamp(k2, 0.0, 31.0)).to(
            torch.int64)
        uv = u.reshape(lead + (parts, nsmpl))
        kb = k2.unsqueeze(-1)
        q = uv >> kb
        bits = torch.sum(kb + 2 + torch.where(q >= 2, q - 2, 0),
                         dim=(-2, -1)) + RICE_PARAM_BITS
        if parts > 1:
            d = k2[..., 1:] - k2[..., :-1]
            zz = torch.where(d < 0, -2 * d - 1, 2 * d)
            nd = torch.floor(torch.log2((zz + 1).to(torch.float64))) + 1
            bits = bits + torch.sum(
                torch.where(zz == 0, 1, 2 * nd.to(torch.int64) - 1), dim=-1)
        totals.append(bits & _MASK32)
        ks.append(F.pad(k2, (0, (1 << LOG2_MAX_PARTITIONS) - parts),
                        value=-1))
        if po > 0:
            sums = torch.sum(sums.reshape(lead + (parts // 2, 2)), dim=-1)
    best = torch.argmin(torch.stack(totals[::-1]), dim=0)
    kstack = torch.stack(ks[::-1])
    idx = best[None, ..., None].expand((1,) + kstack.shape[1:])
    return best, torch.gather(kstack, 0, idx)[0]


def analyse(blocks: torch.Tensor, orders: Sequence[int],
            ridges: Sequence[float], bps: int, ms_stereo: bool,
            dtype=torch.float64) -> SideInfo:
    """Side information of full blocks [B, C, n] (integer samples)."""
    x = blocks.to(torch.int64)
    B, C, n = x.shape
    scale = 2.0 ** (-(bps - 1))
    est = estimate_bits(x.to(dtype) * scale, orders[0], bps)
    raw = torch.sum(est, dim=-1) / C / bps >= RAW_THRESHOLD
    silent = ~torch.any((x != 0).flatten(1), dim=-1)
    buf = integer.ms(x) if ms_stereo else x
    prevs, coefs = [], []
    for _ in range(2):
        prev = buf[..., 0]
        coef = preemphasis_coef(buf, dtype)
        buf = integer.preemphasis(buf, prev, coef)
        prevs.append(prev)
        coefs.append(coef)
    sig = buf.to(dtype) * scale
    R = len(ridges)
    # [R, B, C, units]: the ridge axis leads, as the autocorrelations' lag 0
    ridge = torch.tensor(ridges, dtype=dtype, device=x.device).reshape(
        R, 1, 1, 1)
    h = sig.unsqueeze(0).expand((R,) + sig.shape)
    per_layer = []
    for order in orders:
        l2, flat, h = fit_layer(h, order, ridge)
        per_layer.append((l2, flat))
    loss = torch.sum(torch.abs(h), dim=-1) / n
    best = torch.argmin(loss, dim=0)  # [B, C]
    log2u, quant, shifts = [], [], []
    for l2, flat in per_layer:
        log2u.append(torch.gather(l2, 0, best.unsqueeze(0))[0])
        f = torch.gather(flat, 0, best[None, ..., None].expand(
            (1,) + flat.shape[1:]))[0]
        qi, sh = quantize(f)
        quant.append(qi)
        shifts.append(sh)
    layers = list(zip(quant, log2u, shifts))
    res = buf.reshape(B * C, n)
    for qi, l2, sh in layers:
        res = integer.predict(res, qi.reshape(B * C, -1), l2.reshape(-1),
                              sh.reshape(-1))
    porder, k2 = rice_search(res.reshape(B, C, n), dtype)
    btype = torch.where(raw, 2, torch.where(silent, 1, 0))
    return SideInfo(btype, torch.stack(prevs, -1), torch.stack(coefs, -1),
                    torch.stack(log2u, -1), torch.stack(shifts, -1),
                    torch.cat(quant, -1), porder, k2)
