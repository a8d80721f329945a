"""The `-l` encode's analysis in plain PyTorch: what side information a
full block gets when every block's layer cascade is trained by gradient
descent after the LPC fit (`linne -e -l`).

The steps up to the ridge pick are `analysis.py`'s (block type,
mid/side, two pre-emphasis stages, every ridge term's greedy layer
cascade, the ridge with the least final residual), taken by import. Then
every (block, channel) row of a compress block trains its chosen float
parameters under its chosen unit counts, the trainer of the upstream's
`LINNENetworkTrainer_Train` (linne_network.c:805-873, hyperparameters
linne_internal.h:29-33):

- the loss is the mean |residual| of the whole cascade over the block's
  samples (sample 0, which passes through, included);
- the forward is a lag scan in tap order (oldest tap first), the rows
  grouped by their unit count: no FFT and no matrix product;
- the gradient comes from `torch.autograd`, through an |x| whose
  derivative at +0 and -0 is +1;
- full-batch momentum descent, momentum 0.8, learning rate 0.1f: at each
  iteration the loss and its gradient at the current parameters, then
  m = 0.8 m + lr g and p = p - m for the rows still active, then a row
  stops for good once its loss moved by less than 1e-7 from the last
  iteration's, or after 2,000 iterations.

Rows are independent, so the rows that stopped leave the batch (their
parameters stay as they are). The trained parameters are then quantized,
predicted and Rice-coded by `analysis.py`'s functions.

Departure from the C source: the gradient is the loss's true gradient
(autograd, d|x|/dx = +1 at 0), where the C backward scales the input's
gradient by 1/nparams (linne_network.c:213-265). So the bytes are not
the C tool's: they are the batched port's `-l` algorithm, worked out
from the samples alone.
`dtype` is the float type of the analysis and of the trainer (float64 as
the configuration states; float32 for a control).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from . import analysis, integer

MAX_ITERATIONS = 2000
LEARNING_RATE = float.fromhex("0x1.99999ap-4")  # (double)0.1f
LOSS_EPSILON = 1.0e-7
MOMENTUM = 0.8


class Learned(NamedTuple):
    """What the trained analysis gives full blocks [B, ...]."""
    side: analysis.SideInfo
    stops: torch.Tensor      # [B, C] int64: iterations each row trained
    l1: torch.Tensor         # [B, C] mean |integer residual| of each row


class _Fit(NamedTuple):
    btype: torch.Tensor      # [B]
    pprev: torch.Tensor      # [B, C, 2]
    pcoef: torch.Tensor      # [B, C, 2]
    buf: torch.Tensor        # [B, C, n] int64 after pre-emphasis
    sig: torch.Tensor        # [B, C, n] the float signal the layers fit
    log2u: list              # per layer [B, C]
    params: list             # per layer [B, C, order], the winning ridge's


def fit(blocks: torch.Tensor, orders: Sequence[int], ridges: Sequence[float],
        bps: int, ms_stereo: bool, dtype=torch.float64) -> _Fit:
    """`analysis.analyse` up to the ridge pick, on full blocks [B, C, n]."""
    x = blocks.to(torch.int64)
    B, C, n = x.shape
    scale = 2.0 ** (-(bps - 1))
    est = analysis.estimate_bits(x.to(dtype) * scale, orders[0], bps)
    raw = torch.sum(est, dim=-1) / C / bps >= analysis.RAW_THRESHOLD
    silent = ~torch.any((x != 0).flatten(1), dim=-1)
    buf = integer.ms(x) if ms_stereo else x
    prevs, coefs = [], []
    for _ in range(2):
        prev = buf[..., 0]
        coef = analysis.preemphasis_coef(buf, dtype)
        buf = integer.preemphasis(buf, prev, coef)
        prevs.append(prev)
        coefs.append(coef)
    sig = buf.to(dtype) * scale
    R = len(ridges)
    ridge = torch.tensor(ridges, dtype=dtype, device=x.device).reshape(
        R, 1, 1, 1)
    h = sig.unsqueeze(0).expand((R,) + sig.shape)
    per_layer = []
    for order in orders:
        l2, flat, h = analysis.fit_layer(h, order, ridge)
        per_layer.append((l2, flat))
    loss = torch.sum(torch.abs(h), dim=-1) / n
    best = torch.argmin(loss, dim=0)  # [B, C]
    log2u = [torch.gather(l2, 0, best.unsqueeze(0))[0]
             for l2, _ in per_layer]
    params = [torch.gather(flat, 0, best[None, ..., None].expand(
        (1,) + flat.shape[1:]))[0] for _, flat in per_layer]
    btype = torch.where(raw, 2, torch.where(silent, 1, 0))
    return _Fit(btype, torch.stack(prevs, -1), torch.stack(coefs, -1), buf,
                sig, log2u, params)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| whose derivative is +1 at +0 and at -0."""
    return torch.where(x >= 0, x, -x)


def _groups(log2u: torch.Tensor):
    """[(log2 units, row indices)] of rows [R] and the permutation that
    puts the groups' rows back in order."""
    groups = [(int(l2), (log2u == l2).nonzero(as_tuple=True)[0])
              for l2 in torch.unique(log2u).tolist()]
    inverse = torch.argsort(torch.cat([rows for _, rows in groups]))
    return groups, inverse


def layer_forward(x: torch.Tensor, params: torch.Tensor, groups,
                  inverse) -> torch.Tensor:
    """One layer on rows: out[t] = x[t] + sum_j P[unit(t), j] x[t - npu +
    j], zero history before t = 0 and each unit's context reaching into
    the unit before it, sample 0 passed through. x [R, n]; params [R,
    order], each row's units side by side, each unit's taps oldest first;
    the rows grouped by unit count (`_groups`)."""
    n = x.shape[-1]
    order = params.shape[-1]
    outs = []
    for l2, rows in groups:
        u = 1 << l2
        npu, ns = order // u, n // u
        xg = x[rows]
        pg = params[rows].reshape(-1, u, npu)
        xp = F.pad(xg, (npu, 0))
        pred = torch.zeros((xg.shape[0], u, ns), dtype=x.dtype,
                           device=x.device)
        for j in range(npu):  # tap j reads x[t - (npu - j)]
            pred = pred + pg[..., j : j + 1] * xp[:, j : j + n].reshape(
                -1, u, ns)
        out = xg + pred.reshape(-1, n)
        outs.append(torch.cat([xg[:, :1], out[:, 1:]], dim=-1))
    return torch.cat(outs)[inverse]


def cascade_loss(sig: torch.Tensor, params: Sequence[torch.Tensor],
                 layout) -> torch.Tensor:
    """Mean |residual| of the whole cascade, a row: sig [R, n], params
    per layer [R, order], `layout` per layer (groups, inverse)."""
    x = sig
    for p, (groups, inverse) in zip(params, layout):
        x = layer_forward(x, p, groups, inverse)
    return torch.sum(_abs(x), dim=-1) / sig.shape[-1]


def train(sig: torch.Tensor, params: Sequence[torch.Tensor],
          log2u: Sequence[torch.Tensor]):
    """Train rows sig [R, n] from params per layer [R, order] under unit
    counts log2u per layer [R]: (trained params, each row's iterations
    [R] int64)."""
    R = sig.shape[0]
    dev = sig.device
    P = [p.detach().clone() for p in params]
    M = [torch.zeros_like(p) for p in P]
    prev = torch.full((R,), float("inf"), dtype=sig.dtype, device=dev)
    stops = torch.zeros(R, dtype=torch.int64, device=dev)
    live = torch.arange(R, device=dev)
    it = 0
    while it < MAX_ITERATIONS and live.numel():
        layout = [_groups(l2[live]) for l2 in log2u]
        leaves = [p[live].requires_grad_() for p in P]
        with torch.enable_grad():
            loss = cascade_loss(sig[live], leaves, layout)
            grads = torch.autograd.grad(torch.sum(loss), leaves)
        loss = loss.detach()
        for li, g in enumerate(grads):
            m = MOMENTUM * M[li][live] + LEARNING_RATE * g
            M[li][live] = m
            P[li][live] = leaves[li].detach() - m
        stops[live] += 1
        keep = torch.abs(loss - prev[live]) >= LOSS_EPSILON
        prev[live] = loss
        live = live[keep]
        it += 1
    return P, stops


def analyse(blocks: torch.Tensor, orders: Sequence[int],
            ridges: Sequence[float], bps: int, ms_stereo: bool,
            dtype=torch.float64, chunk: int = 128) -> Learned:
    """The `-l` side information of full blocks [B, C, n] (integer
    samples): the layer fits in chunks of `chunk` blocks, then every
    compress row of them trained in one batch, then the integer stages."""
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        fits = [fit(blocks[a : a + chunk], orders, ridges, bps, ms_stereo,
                    dtype) for a in range(0, blocks.shape[0], chunk)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    btype = torch.cat([f.btype for f in fits])
    B, C, n = blocks.shape
    log2u = [torch.cat([f.log2u[li] for f in fits]) for li in
             range(len(orders))]
    params = [torch.cat([f.params[li] for f in fits]) for li in
              range(len(orders))]
    stops = torch.zeros((B, C), dtype=torch.int64, device=blocks.device)
    rows = (btype == 0).nonzero(as_tuple=True)[0]
    if rows.numel():
        sig = torch.cat([f.sig for f in fits])[rows].reshape(-1, n)
        flat = [p[rows].reshape(-1, p.shape[-1]) for p in params]
        out, st = train(sig, flat, [l[rows].reshape(-1) for l in log2u])
        for li, p in enumerate(out):
            params[li][rows] = p.reshape(-1, C, p.shape[-1])
        stops[rows] = st.reshape(-1, C)
    buf = torch.cat([f.buf for f in fits])
    quant, shifts = [], []
    for p in params:
        qi, sh = analysis.quantize(p)
        quant.append(qi)
        shifts.append(sh)
    res = buf.reshape(B * C, n)
    for qi, l2, sh in zip(quant, log2u, shifts):
        res = integer.predict(res, qi.reshape(B * C, -1), l2.reshape(-1),
                              sh.reshape(-1))
    res = res.reshape(B, C, n)
    porder, k2 = analysis.rice_search(res, dtype)
    l1 = torch.sum(torch.abs(res), dim=-1).to(torch.float64) / n
    side = analysis.SideInfo(
        btype, torch.cat([f.pprev for f in fits]),
        torch.cat([f.pcoef for f in fits]), torch.stack(log2u, -1),
        torch.stack(shifts, -1), torch.cat(quant, -1), porder, k2)
    return Learned(side, stops, l1)
