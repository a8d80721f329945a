"""The format's integer arithmetic in plain PyTorch, for many blocks at
once: mid/side, pre-emphasis, the unit-split prediction cascade, and
their inverses.

Integers are held in int64 and wrapped to 32 bits where the format's
int32 arithmetic wraps. `residual_of` runs the encoder's direction (a
block's samples and side information give the residual the stream must
carry); `synthesize` runs the decoder's, which `dtype=torch.float32`
computes in single precision instead (the decode's control).
"""

from __future__ import annotations

import torch

from .stream import PREEMPH_SHIFT


def wrap32(v: torch.Tensor) -> torch.Tensor:
    return ((v + 2**31) & 0xFFFFFFFF) - 2**31


def ms(x: torch.Tensor) -> torch.Tensor:
    """[..., 2, n] L/R -> mid/side."""
    side = wrap32(x[..., 1, :] - x[..., 0, :])
    mid = wrap32(x[..., 0, :] + (side >> 1))
    return torch.stack([mid, side], dim=-2)


def lr(x: torch.Tensor) -> torch.Tensor:
    """The inverse of `ms`."""
    left = wrap32(x[..., 0, :] - (x[..., 1, :] >> 1))
    right = wrap32(x[..., 1, :] + left)
    return torch.stack([left, right], dim=-2)


def preemphasis(x: torch.Tensor, prev: torch.Tensor,
                coef: torch.Tensor) -> torch.Tensor:
    """y[t] = x[t] - ((x[t-1] * coef) >> 5), x[-1] = prev; x [..., n],
    prev and coef [...]."""
    before = torch.cat([prev.unsqueeze(-1), x[..., :-1]], dim=-1)
    return wrap32(x - (wrap32(before * coef.unsqueeze(-1)) >> PREEMPH_SHIFT))


def _by_units(log2u: torch.Tensor):
    for l2 in torch.unique(log2u).tolist():
        yield int(l2), (log2u == l2).nonzero(as_tuple=True)[0]


def predict(x: torch.Tensor, coefs: torch.Tensor, log2u: torch.Tensor,
            rshift: torch.Tensor) -> torch.Tensor:
    """One prediction layer on rows: x [R, n], coefs [R, order], log2u and
    rshift [R]. Each of a row's 2^log2u units filters its own segment of
    n / units samples with order / units taps (oldest first); its first
    taps-many samples and any remainder pass through; elsewhere
    residual = x + ((half + sum coef * x) >> rshift), half = 2^(rshift-1)
    (0 where rshift is 0), wrapped as int32."""
    out = x.clone()
    R, n = x.shape
    order = coefs.shape[-1]
    for l2, rows in _by_units(log2u):
        u = 1 << l2
        npu, ns = order // u, n // u
        if npu == 0 or ns <= npu:
            continue
        seg = x[rows, : u * ns].reshape(-1, u, ns)
        c = coefs[rows].reshape(-1, u, npu)
        acc = torch.zeros(seg.shape[0], u, ns - npu, dtype=torch.int64,
                          device=x.device)
        for j in range(npu):
            acc += c[..., j : j + 1] * seg[..., j : j + ns - npu]
        sh = rshift[rows].reshape(-1, 1, 1)
        half = torch.where(sh >= 1, 1 << (sh - 1).clamp(min=0), 0)
        pred = wrap32(acc + half) >> sh
        body = out[rows, : u * ns].reshape(-1, u, ns)
        body[..., npu:] = wrap32(seg[..., npu:] + pred)
        out[rows, : u * ns] = body.reshape(-1, u * ns)
    return out


def residual_of(samples: torch.Tensor, ms_stereo: bool, pprev, pcoef,
                layers) -> torch.Tensor:
    """The residual that blocks of `samples` [B, C, n] must carry under
    their side information: pprev, pcoef [B, C, 2]; `layers` a list of
    (coefs [B, C, order], log2u [B, C], rshift [B, C]) in the encoder's
    order. Returns [B, C, n]."""
    x = ms(samples) if ms_stereo else samples
    for st in range(pprev.shape[-1]):
        x = preemphasis(x, pprev[..., st], pcoef[..., st])
    B, C, n = x.shape
    x = x.reshape(B * C, n)
    for coefs, log2u, rshift in layers:
        x = predict(x, coefs.reshape(B * C, -1), log2u.reshape(-1),
                    rshift.reshape(-1))
    return x.reshape(B, C, n)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 explicit significand bits (to
    nearest, ties away from zero), as the tensor cores read float32
    operands with TF32 on."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def synthesize(residual: torch.Tensor, ms_stereo: bool, pprev, pcoef,
               layers, dtype=torch.int64, operands=None) -> torch.Tensor:
    """The decoder's direction: the samples [B, C, n] that residual
    [B, C, n] and the side information (as in `residual_of`) stand for.
    Each layer's recursion runs sample by sample over every row at once.
    With dtype float32 each prediction sum (and its rounding half) is
    taken in single precision and floored by 2^rshift, with no 32-bit
    wrap; `operands` (as `tf32`) then rounds each product's operands
    first. `synthesize.largest_sum` holds the largest magnitude of a
    prediction sum of the last call."""
    B, C, n = residual.shape
    x = residual.reshape(B * C, n).clone()
    exact = dtype == torch.int64
    largest = torch.zeros((), dtype=torch.float64, device=x.device)
    for coefs, log2u, rshift in reversed(layers):
        coefs = coefs.reshape(B * C, -1)
        order = coefs.shape[-1]
        for l2, rows in _by_units(log2u.reshape(-1)):
            u = 1 << l2
            npu, ns = order // u, n // u
            if npu == 0 or ns <= npu:
                continue
            seg = x[rows, : u * ns].reshape(-1, u, ns).clone()
            c = coefs[rows].reshape(-1, u, npu)
            sh = rshift.reshape(-1)[rows].reshape(-1, 1)
            half = torch.where(sh >= 1, 1 << (sh - 1).clamp(min=0), 0)
            if not exact:
                c = c.to(dtype)
                half = half.to(dtype)
                scale = torch.exp2(sh.to(dtype))
            if operands is not None:
                c = operands(c)
            for t in range(npu, ns):
                window = seg[..., t - npu : t]
                if exact:
                    s = (c * window).sum(-1)
                    d = wrap32(s + half) >> sh
                else:
                    w = window.to(dtype)
                    if operands is not None:
                        w = operands(w)
                    s = (c * w).sum(-1)
                    d = torch.floor((s + half) / scale).to(torch.int64)
                largest = torch.maximum(largest, s.abs().max().to(
                    torch.float64))
                seg[..., t] = wrap32(seg[..., t] - d)
            x[rows, : u * ns] = seg.reshape(-1, u * ns)
    synthesize.largest_sum = float(largest)
    x = x.reshape(B, C, n)
    for st in reversed(range(pprev.shape[-1])):
        coef = pcoef[..., st]
        prev = pprev[..., st]
        out = x.clone()
        for t in range(n):
            before = prev if t == 0 else out[..., t - 1]
            if exact:
                step = wrap32(before * coef) >> PREEMPH_SHIFT
            else:
                step = torch.floor(before.to(dtype) * coef.to(dtype)
                                   / 2**PREEMPH_SHIFT).to(torch.int64)
            out[..., t] = wrap32(x[..., t] + step)
        x = out
    return lr(x) if ms_stereo else x
