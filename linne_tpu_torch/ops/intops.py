"""Batched integer (wire-semantics) ops: MS transform, pre-emphasis, and the
unit-split LPC predict cascade. Counterpart of linne_tpu/ops/intops.py.

Elementwise int32 tensor arithmetic wraps in two's complement on the CPU
and on CUDA, which is what the reference decoder expects
(reference: libs/linne_internal/src/linne_utility.c:120-212,
libs/linne_encoder/src/linne_lpc_predict.c:7-38). The trap is a reduction:
`torch.sum` of int32 returns int64 and loses the wrap, so the predict
cascade accumulates tap by tap with elementwise adds and never sums.

The dense predict cascade runs, on a CUDA tensor, as one launch of a
hand-written kernel (ops/analysis_scans.py, csrc/analysis_scans.cu,
bit-equal) and, on a CPU tensor, as its plain version
`_predict_dense_plain`, a Python loop over the taps.
"""

from __future__ import annotations

import torch

from ..constants import PREEMPH_COEF_SHIFT

from . import analysis_scans


def ms_transform(buf: torch.Tensor) -> torch.Tensor:
    """L/R -> mid/side on channels 0/1 of buf[..., ch, n] (int32)."""
    side = buf[..., 1, :] - buf[..., 0, :]
    mid = buf[..., 0, :] + (side >> 1)
    return torch.cat(
        [mid.unsqueeze(-2), side.unsqueeze(-2), buf[..., 2:, :]], dim=-2)


def preemphasis_coefficient(x: torch.Tensor,
                            dtype=torch.float64) -> torch.Tensor:
    """Batched pre-emphasis coefficient (reference:
    linne_utility.c:158-193). x: [..., n] int32. Returns int32 coef [...]."""
    d = x.to(dtype)
    curr = d[..., :-1]
    succ = d[..., 1:]
    corr0 = torch.sum(curr * curr, dim=-1)
    corr1 = torch.sum(curr * succ, dim=-1)
    ratio = corr1 / torch.where(corr0 == 0, 1.0, corr0)
    # round half away from zero for the non-negative ratios kept below;
    # torch.round would round half to even
    coef = torch.floor(ratio * 32.0 + 0.5).to(torch.int32)
    coef = torch.clamp(coef, max=(1 << (PREEMPH_COEF_SHIFT - 1)) - 1)
    bad = (corr0 < 1e-6) | (ratio < 0.0)
    return torch.where(bad, 0, coef)


def preemphasis_apply(x: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """y[t] = x[t] - ((x[t-1] * coef) >> 5), x[-1] := x[0]
    (the encoder seeds prev with the first sample, linne_encoder.c:637)."""
    prev = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    return x - ((prev * coef.unsqueeze(-1)) >> PREEMPH_COEF_SHIFT)


def predict_cascade_layer(
    x: torch.Tensor, coefs: torch.Tensor, log2_units: torch.Tensor,
    rshift: torch.Tensor, unit_choices: list,
) -> torch.Tensor:
    """One integer predict layer with runtime-selected unit count.

    x: [..., n] int32 signal; coefs: [..., order] int32 (flat unit layout);
    log2_units: [...] int32; rshift: [...] int32. `unit_choices` is the
    static list of possible unit counts. When every choice divides n, one
    dense full-order masked pass serves them all (_predict_dense); a ragged
    length (a device-encoded tail analyzed at a rounded length) computes
    each variant and selects per row.
    """
    if len(unit_choices) == 1:
        return _predict_fixed_units(x, coefs, unit_choices[0], rshift)
    n = x.shape[-1]
    if all(n % u == 0 for u in unit_choices):
        return _predict_dense(x, coefs, log2_units, rshift,
                              max(unit_choices))
    variants = [
        _predict_fixed_units(x, coefs, u, rshift) for u in unit_choices
    ]
    stack = torch.stack(variants, dim=0)  # [nvar, ..., n]
    # each row's variant: the index of its unit count among the choices
    # (0 for a count that is none of them), from device ops alone, so that
    # the stage holds no host data and can be captured as a CUDA graph
    idx = torch.zeros_like(log2_units, dtype=torch.int64)
    for i, u in enumerate(unit_choices):
        idx = torch.where(log2_units == u.bit_length() - 1, i, idx)
    idx = idx[None, ..., None].expand((1,) + x.shape)
    return torch.gather(stack, 0, idx)[0]


def _predict_dense(
    x: torch.Tensor, coefs: torch.Tensor, log2u: torch.Tensor,
    rshift: torch.Tensor, u_max: int,
) -> torch.Tensor:
    """Full-order masked FIR (see _predict_dense_plain). A CPU tensor
    takes the plain version; any other launches the kernel or raises."""
    if x.device.type == "cpu":
        return _predict_dense_plain(x, coefs, log2u, rshift, u_max)
    batch = tuple(x.shape[:-1])
    n = x.shape[-1]
    order = coefs.shape[-1]
    # coefs may be a layer's columns of the quantizer's grouped output: the
    # kernel reads its rows at their stride, without a copy
    out = analysis_scans.predict_dense(
        x.reshape(-1, n).contiguous(), coefs.reshape(-1, order),
        log2u.reshape(-1).contiguous(), rshift.reshape(-1).contiguous(),
        u_max)
    return out.reshape(batch + (n,))


def _predict_dense_plain(
    x: torch.Tensor, coefs: torch.Tensor, log2u: torch.Tensor,
    rshift: torch.Tensor, u_max: int,
) -> torch.Tensor:
    """Full-order masked FIR: fine segment s belongs to real unit
    s*u//u_max; column j carries tap age k = order - j, valid iff
    k <= order/u. The first order/u samples of every real unit pass
    through. The caller guarantees u_max | n."""
    n = x.shape[-1]
    order = coefs.shape[-1]
    ns_max = n // u_max
    batch = tuple(x.shape[:-1])
    dev = x.device
    ones = (1,) * len(batch)
    k = (order - torch.arange(order, device=dev)).reshape(ones + (1, order))
    s = torch.arange(u_max, device=dev).reshape(ones + (u_max, 1))
    l2 = log2u.long()
    u_r = (1 << l2)[..., None, None]
    npu_r = (order >> l2)[..., None, None]
    unit = (s * u_r) // u_max                         # [.., u_max, 1]
    valid = k <= npu_r                                # [.., 1, order]
    src = unit * npu_r + (npu_r - k)                  # [.., u_max, order]
    flat = coefs.unsqueeze(-2).expand(batch + (u_max, order))
    dense = torch.where(valid, torch.gather(flat, -1, torch.where(valid, src, 0)),
                        0)

    half = torch.ones_like(rshift) << (rshift - 1)
    xp = torch.cat([x.new_zeros(batch + (order,)), x], dim=-1)
    acc = half.unsqueeze(-1).expand(batch + (n,))
    for j in range(order):
        cj = torch.repeat_interleave(dense[..., j], ns_max, dim=-1)
        acc = acc + cj * xp[..., j : j + n]           # x[g-order+j]
    pred = acc >> rshift.unsqueeze(-1)
    g = torch.arange(n, device=dev)
    ns_r = (n >> l2).unsqueeze(-1)                    # n >> l == n // u
    offset = g - (g // ns_r) * ns_r
    kept = offset >= npu_r[..., 0]
    return x + torch.where(kept, pred, 0)


def _predict_fixed_units(
    x: torch.Tensor, coefs: torch.Tensor, num_units: int,
    rshift: torch.Tensor,
) -> torch.Tensor:
    """FIR residual for a fixed unit split. The first order//num_units
    samples of each unit and any remainder tail pass through."""
    n = x.shape[-1]
    order = coefs.shape[-1]
    npu = order // num_units
    ns = n // num_units
    if ns <= npu:
        return x
    body_len = num_units * ns
    lead = tuple(x.shape[:-1])
    seg = x[..., :body_len].reshape(lead + (num_units, ns))
    c = coefs.reshape(tuple(coefs.shape[:-1]) + (num_units, npu))
    half = (torch.ones_like(rshift) << (rshift - 1))[..., None, None]
    pred = half.expand(lead + (num_units, ns - npu))
    for j in range(npu):
        pred = pred + c[..., j : j + 1] * seg[..., j : j + ns - npu]
    pred = pred >> rshift[..., None, None]
    out_seg = torch.cat([seg[..., :npu], seg[..., npu:] + pred], dim=-1)
    return torch.cat(
        [out_seg.reshape(lead + (body_len,)), x[..., body_len:]], dim=-1)


def normalize_to_float(x: torch.Tensor, bits_per_sample: int,
                       dtype) -> torch.Tensor:
    return x.to(dtype) * (2.0 ** (-(bits_per_sample - 1)))
