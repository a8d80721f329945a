"""Batched auxiliary-function (IRLS) coefficient refinement.
Counterpart of linne_tpu/ops/afmethod.py.

The reference refines each unit's Levinson-Durbin fit by iteratively
reweighted least squares on the L1 objective: build normal equations
weighted by 1/|residual|, solve by Cholesky, repeat
(reference: lpc.c:452-509, 578-633). Here whole row populations
(rows = blocks x channels x units, grouped by unit count so shapes are
static) refine together: the normal matrices are accumulated as chunked
X^T diag(w) X products in float64 and solved with a batched Cholesky
(`torch.linalg`, cuSOLVER on the card).

Runs a fixed iteration count (the reference early-stops per fit on an
objective delta of 1e-8; converged rows simply stop moving).
"""

from __future__ import annotations

import torch

from .analysis import fit_unit_lpc, unit_forward

_RES_EPS = 1e-6
_CHUNK = 2048


def _windows_chunk(data: torch.Tensor, start: int, size: int, order: int):
    """X[t, i] = data[start + t - i - 1] for t in [0, size), i in [0,
    order). data: [rows, ns]; start >= order, so no index is negative."""
    t = torch.arange(size, device=data.device)
    i = torch.arange(order, device=data.device)
    idx = (start + t[:, None]) - i[None, :] - 1
    return data[:, idx]  # [rows, size, order]


def af_refine(data: torch.Tensor, a0: torch.Tensor, num_iterations: int):
    """data: [rows, ns] layer-input segments; a0: [rows, order] initial
    prediction coefficients in the reference's sign convention
    (residual = x_t + sum_i a_i x_{t-i-1}). Returns refined a."""
    rows, ns = data.shape
    order = a0.shape[-1]
    if ns - order <= 0 or num_iterations == 0:
        return a0

    chunk_bounds = []
    pos = order
    while pos < ns:
        size = min(_CHUNK, ns - pos)
        chunk_bounds.append((pos, size))
        pos += size

    a = a0
    for _ in range(num_iterations):
        # residual pass
        res = torch.cat(
            [data[:, start : start + size]
             + torch.einsum("rto,ro->rt",
                            _windows_chunk(data, start, size, order), a)
             for start, size in chunk_bounds], dim=-1)
        w = 1.0 / torch.clamp(torch.abs(res), min=_RES_EPS)  # [rows, nres]
        # normal equations, chunked
        r_mat = data.new_zeros((rows, order, order))
        r_vec = data.new_zeros((rows, order))
        off = 0
        for start, size in chunk_bounds:
            X = _windows_chunk(data, start, size, order)
            wc = w[:, off : off + size]
            r_mat = r_mat + torch.einsum("rto,rtp->rop",
                                         X * wc[..., None], X)
            r_vec = r_vec - torch.einsum(
                "rt,rto->ro", data[:, start : start + size] * wc, X)
            off += size
        # batched SPD solve; a row whose factorization fails or whose
        # solution is not finite gets zero coefficients (the reference
        # zeroes them on a singular matrix). The failed factor's contents
        # are never trusted: cuSOLVER leaves them unspecified.
        chol, info = torch.linalg.cholesky_ex(r_mat)
        y = torch.linalg.solve_triangular(chol, r_vec[..., None], upper=False)
        sol = torch.linalg.solve_triangular(chol.mT, y, upper=True)[..., 0]
        ok = (info == 0) & torch.all(torch.isfinite(sol), dim=-1)
        a = torch.where(ok[:, None], sol, 0.0)
    return a


def make_af_refit_fn(order: int, num_iterations: int):
    def refit(data, a0):
        return af_refine(data, a0, num_iterations)

    return refit


def make_af_layer_stage(order: int, unit_choices, num_iterations: int):
    """One AF-refined layer pass for the encoder's `-a` path.

    Mirrors the reference's final SetParameter pass with AF iterations
    (linne_network.c:596-598, 628-629): re-initialize each unit split with
    the (ridge-regularized) Levinson-Durbin fit, refine with IRLS, then
    forward the layer. All unit-split candidates are evaluated and the
    per-(block, channel) winner — already decided by the af=0 sweep, since
    the reference's final unit search uses 0 AF iterations — is gathered.

    Returns stage(x, log2u, ridge_val) -> (flat_params, residual)."""
    lut = {u: i for i, u in enumerate(unit_choices)}
    table = [lut.get(1 << l, 0) for l in range(8)]

    def stage(x, log2u, ridge_val):
        # x: [B, C, n] float; log2u: [B, C] int; ridge_val: [B, C] float
        lead = tuple(x.shape[:-1])
        n = x.shape[-1]
        flats = []
        residuals = []
        for u in unit_choices:
            npu = order // u
            ns = n // u
            rev = fit_unit_lpc(x, u, npu, ridge_val[..., None])
            a0 = torch.flip(rev, [-1])  # natural tap order for IRLS
            segs = x.reshape(lead + (u, ns)).reshape(-1, ns)
            a = af_refine(segs, a0.reshape(-1, npu), num_iterations)
            rev2 = torch.flip(a.reshape(a0.shape), [-1])  # wire layout
            flats.append(rev2.reshape(lead + (order,)))
            residuals.append(unit_forward(x, rev2, u))
        idx = torch.tensor(table, dtype=torch.long,
                           device=x.device)[log2u.long()][None, ..., None]
        flat = torch.gather(torch.stack(flats),
                            0, idx.expand((1,) + lead + (order,)))[0]
        res = torch.gather(torch.stack(residuals),
                           0, idx.expand((1,) + lead + (n,)))[0]
        return flat, res

    return stage
