"""Integer unit-split LPC prediction/synthesis cascade (host oracle).

Fixed-point semantics fixed by the format (reference:
libs/linne_encoder/src/linne_lpc_predict.c:7-38,
libs/linne_decoder/src/linne_lpc_synthesize.c:8-83):

- a layer of `order` coefficients split into `num_units` sub-filters;
- each unit filters its own contiguous segment of `num_samples // num_units`
  samples; the first `order // num_units` samples of every unit and any
  remainder tail samples pass through unchanged;
- prediction adds `(half + sum coef*x) >> rshift` to form the residual;
  synthesis subtracts it recursively (the decode-side IIR).

All arithmetic wraps modulo 2^32 as int32 (sums accumulate associatively, so
we evaluate in int64 and wrap once before the shift).
"""

from __future__ import annotations

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view


def _wrap_i32(v: np.ndarray) -> np.ndarray:
    return (v & np.int64(0xFFFFFFFF)).astype(np.uint32).astype(np.int32)


def predict(
    data: np.ndarray, num_samples: int, coef: np.ndarray, num_units: int,
    rshift: int,
) -> np.ndarray:
    """FIR residual computation (encoder side); returns a new int32 array."""
    order = coef.shape[0]
    npu = order // num_units
    ns = num_samples // num_units
    residual = data[:num_samples].astype(np.int32).copy()
    if ns <= npu:
        return residual
    x = data[: num_units * ns].astype(np.int64).reshape(num_units, ns)
    c = coef.astype(np.int64).reshape(num_units, npu)
    # windows[u, t, k] = x[u, t + k], t = 0..ns-npu-1
    win = sliding_window_view(x, npu, axis=1)[:, : ns - npu, :]
    # corrupt streams may carry rshift=0 (4-bit field); match the native/
    # XLA convention half=0 so all decode paths agree even on garbage
    half = np.int64(1 << (rshift - 1)) if rshift >= 1 else np.int64(0)
    pred = np.einsum("utk,uk->ut", win, c, dtype=np.int64) + half
    pred = _wrap_i32(pred) >> np.int32(rshift)
    out = residual[: num_units * ns].reshape(num_units, ns)
    out[:, npu:] = _wrap_i32(out[:, npu:].astype(np.int64) + pred.astype(np.int64))
    return residual


def synthesize(
    data: np.ndarray, num_samples: int, coef: np.ndarray, num_units: int,
    rshift: int,
) -> None:
    """Recursive IIR reconstruction (decoder side), in place over int32
    `data`. Chunked stale-dot formulation (same trick as the native
    kernel): each K-output chunk takes full-length dots against the
    pre-chunk window in one int64 matmul — exact, because int32 wrapping
    arithmetic is a mod-2^32 ring where multiplication distributes over
    wrapped addition — then corrects each output serially in python ints
    for the taps that landed on in-chunk outputs. Only the irreducible
    per-output correction (the per-step `>> rshift` forbids state-space
    blocking) stays in the interpreter."""
    order = coef.shape[0]
    npu = order // num_units
    ns = num_samples // num_units
    if ns <= npu:
        return
    # corrupt streams may carry rshift=0; half=0 like the native/XLA paths
    half = (1 << (rshift - 1)) if rshift >= 1 else 0
    K = 16
    seg = data[: num_units * ns].reshape(num_units, ns)
    x64 = seg.astype(np.int64)
    for u in range(num_units):
        xu = x64[u]
        cs = coef[u * npu : (u + 1) * npu]
        c64 = cs.astype(np.int64)
        clist = cs.tolist()
        npred = ns - npu
        # one window view for the whole row: row t+m reads xu[t+m : t+m+npu],
        # which at chunk time holds final values below t+npu and stale ones
        # at/above it — exactly the stale/fresh split the corrections assume
        V = sliding_window_view(xu, npu)
        t = 0
        while t < npred:
            k = min(K, npred - t)
            pre = (V[t : t + k] @ c64).tolist()
            targets = xu[t + npu : t + npu + k].tolist()
            deltas = []
            for m in range(k):
                s = pre[m] + half
                if m:
                    # in-chunk outputs i land on tap j = npu - m + i; only
                    # i >= m - npu fall inside output m's window
                    i0 = m - npu if m > npu else 0
                    cbase = npu - m
                    for i in range(i0, m):
                        s += clist[cbase + i] * deltas[i]
                s &= 0xFFFFFFFF
                if s >= 0x80000000:
                    s -= 0x100000000
                d = -(s >> rshift)
                deltas.append(d)
                v = (targets[m] + d) & 0xFFFFFFFF
                targets[m] = v - 0x100000000 if v >= 0x80000000 else v
            xu[t + npu : t + npu + k] = targets
            t += k
    seg[:] = x64.astype(np.int32)
