"""The upstream C encoder's analysis of a track's first blocks, in plain
NumPy (and the format's integer arithmetic from `integer`), strict serial
float64: what type and side information `linne -e` gives each block.

Every float64 sum runs in the C source's order, one rounding an
operation, from the same 0.0, as the upstream encoder runs it
(libs/linne_encoder/src/linne_encoder.c, libs/linne_network/src/
linne_network.c, libs/lpc/src/lpc.c, libs/linne_internal/src/
linne_utility.c):

- the block type (linne_encoder.c:497-516): each input channel, scaled
  to [-1, 1), sine-windowed, autocorrelated and run through
  Levinson-Durbin at the first layer's order; its estimated bits a
  sample (lpc.c:810-865) read the reflection coefficients
  parcor[1..order], and parcor[order] is one element past what the
  recursion writes (lpc.c:846-848): a stale value of the encoder's
  arena, left by the fits of an earlier block. The arena's
  `parcor_coef` is carried from block to block as the C encoder carries
  it, from zeros at the track's start; raw at a mean of 0.95 of the
  sample width or more, silent where every sample is zero;
- mid/side and two pre-emphasis stages (linne_encoder.c:624-641,
  linne_utility.c:120-212), each coefficient from the lag-0 and lag-1
  sums of the stage's input;
- for each ridge term (linne_network.c:582-630), the greedy layer
  cascade: each layer tries every power-of-two unit count that divides
  its order and the block (linne_network.c:268-347); each unit's
  Welch-windowed (lpc.c:196-205) autocorrelation, each lag summed in
  sample order (lpc.c:215-249; a loop over samples, a vector over lags),
  the ridge on lag 0 (lpc.c:358), Levinson-Durbin (lpc.c:252-324); the
  unit count with the first strict minimum of the mean absolute residual
  (each predicted sample summed in tap order from the sample itself,
  linne_network.c:319-335; a loop over taps, a vector over samples); the
  layer's output is its input plus its prediction summed from 0.0
  (linne_network.c:165-210). The ridge term with the first strict
  minimum of the last layer's mean absolute output wins; its pass is the
  final one (with no auxiliary-function iterations the final refit is
  that pass again, linne_network.c:628-629);
- the error-feedback quantizer to 8-bit coefficients, tail to head, with
  round-half-away (lpc.c:49-52, 981-1040);
- the integer prediction cascade (`integer.predict`) and the partitioned
  Rice parameter search (`analysis.rice_search`), which are exact
  integer work and the format's own rules.

The fits of different blocks, channels and ridge terms are independent
(full blocks never read the arena before writing it), so they run side
by side as arrays, the tracks in groups of about `GROUP_BLOCKS` blocks;
every chain keeps its order, and each multiply and add is its own
rounding (no fused multiply-add). Only the arena is serial, and it is
replayed block by block.

Departures from the C source, none of which changes a result at the
shapes accepted here:
- only full blocks, from a track's start: the tail block's analysis
  length and its window's stale middle sample (odd lengths, lpc.c:
  196-205) are not modelled, and shapes whose unit sub-lengths are odd
  are refused;
- no `-a N` (auxiliary-function iterations) and no `-l` (training): the
  configurations here set neither, and they are refused;
- of the arena only `parcor_coef` is kept: it is the only array whose
  stale contents reach an output;
- the zero-signal early-out (|lag 0| < FLT_EPSILON) is computed as a
  mask over the full recursion, whose values it replaces by zeros, as
  the C code's early return leaves them.

`dtype=np.float32` runs every floating-point step one precision below the
configuration's (the comparison's control); float64 is the encoder's.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from . import integer
from .analysis import rice_search

FLT_EPSILON = 2.0 ** -23
FLT_MAX = float(np.finfo(np.float32).max)
FLT_MIN = 2.0 ** -126
RAW_THRESHOLD = float(np.float32(0.95))
COEF_BITS = 8
MAX_UNITS = 128
NUM_PREEMPH = 2
PREEMPH_SHIFT = 5
LPC_PI = 3.1415926535897932384626433832795029
INV_LOGE2 = 1.4426950408889634
BETA_LAPLACE = 1.9426950408889634
BLOCK_COMPRESS, BLOCK_SILENT, BLOCK_RAW = 0, 1, 2
GROUP_BLOCKS = 32  # blocks fitted side by side: their arrays stay in cache


class Block(NamedTuple):
    """One block as the upstream encoder writes it, less the residual;
    the arrays are None for a raw or silent block."""
    block_type: int
    pprev: np.ndarray   # [C, 2] pre-emphasis state
    pcoef: np.ndarray   # [C, 2] pre-emphasis coefficients
    log2u: np.ndarray   # [C, L] log2 of each layer's unit count
    rshift: np.ndarray  # [C, L]
    coefs: np.ndarray   # [C, sum of orders], time-reversed a unit
    porder: np.ndarray  # [C] Rice partition order
    k2: np.ndarray      # [C, 1024] Rice parameters, -1 past the partitions


FIELDS = ("pprev", "pcoef", "log2u", "rshift", "coefs", "porder", "k2")


# -- serial building blocks ---------------------------------------------------

def serial_sum(x: np.ndarray) -> np.ndarray:
    """Sum over the last axis, left to right from +0.0 (add.accumulate
    adds in order, one rounding an addition)."""
    acc = np.concatenate([np.zeros(x.shape[:-1] + (1,), x.dtype), x],
                         axis=-1)
    return np.add.accumulate(acc, axis=-1)[..., -1]


def c_round(d: np.ndarray) -> np.ndarray:
    """Round half away from zero (lpc.c:49-52)."""
    return np.where(d >= 0.0, np.floor(d + 0.5), -np.floor(-d + 0.5))


def log2(d: float) -> float:
    """log(d) times 1/ln 2, as lpc.c:54-60 computes it (libm's log)."""
    if d == 0.0:
        return -math.inf
    if d < 0.0 or math.isnan(d):
        return math.nan
    return math.log(d) * INV_LOGE2


_windows: dict = {}


def sine_window(n: int) -> np.ndarray:
    w = _windows.get(("sin", n))
    if w is None:
        w = np.array([math.sin((LPC_PI * s) / (n - 1)) for s in range(n)])
        _windows[("sin", n)] = w
    return w


def welch_window(n: int) -> np.ndarray:
    """Even n only: every weight written (lpc.c:196-205)."""
    w = _windows.get(("welch", n))
    if w is None:
        divisor = 4.0 * math.pow(n - 1, -2.0)
        s = np.arange(n >> 1, dtype=np.float64)
        half = divisor * s * (n - 1 - s)
        w = np.concatenate([half, half[::-1]])
        _windows[("welch", n)] = w
    return w


def autocorrelation(seg: np.ndarray, nlags: int) -> np.ndarray:
    """ac[..., lag] = sum over i of seg[i] * seg[i + lag], each lag's sum
    in sample order from +0.0: a loop over the samples, a vector over the
    lags (a product past the segment's end is a zero, which leaves a sum
    as it is). seg [..., ns] -> [..., nlags]."""
    ns = seg.shape[-1]
    padded = np.concatenate(
        [seg, np.zeros(seg.shape[:-1] + (nlags - 1,), seg.dtype)], axis=-1)
    ac = np.zeros(seg.shape[:-1] + (nlags,), seg.dtype)
    prod = np.empty_like(ac)
    for i in range(ns):
        np.multiply(seg[..., i : i + 1], padded[..., i : i + nlags], out=prod)
        ac += prod
    return ac


def levinson(ac: np.ndarray, order: int):
    """Levinson-Durbin in the C source's order (lpc.c:252-324) over the
    leading axes: (lpc coefficients [..., order], parcor [..., order],
    zero case [...]). Where |ac[0]| < FLT_EPSILON the C code writes zeros
    to lpc_coef[0..order] and parcor_coef[0..order] and returns."""
    zc = np.abs(ac[..., 0]) < FLT_EPSILON
    lead = ac.shape[:-1]
    dt = ac.dtype
    with np.errstate(all="ignore"):
        a = np.zeros(lead + (order + 2,), dt)
        parcor = np.zeros(lead + (order,), dt)
        a[..., 0] = 1.0
        ek = ac[..., 0].copy()
        a[..., 1] = -ac[..., 1] / ac[..., 0]
        parcor[..., 0] = ac[..., 1] / ek
        ek = ek + ac[..., 1] * a[..., 1]
        for k in range(1, order):
            gamma = np.zeros(lead, dt)
            for i in range(k + 1):
                gamma = gamma + a[..., i] * ac[..., k + 1 - i]
            gamma = gamma / -ek
            ek = ek * (1.0 - gamma * gamma)
            one, zero = np.ones(lead + (1,), dt), np.zeros(lead + (1,), dt)
            u = np.concatenate([one, a[..., 1 : k + 1], zero], axis=-1)
            v = np.concatenate([zero, a[..., k:0:-1], one], axis=-1)
            a[..., : k + 2] = u + gamma[..., None] * v
            parcor[..., k] = -gamma
    coef = np.where(zc[..., None], 0.0, a[..., 1 : order + 1])
    parcor = np.where(zc[..., None], 0.0, parcor)
    return coef, parcor, zc


def predict(x: np.ndarray, params: np.ndarray, units: int, base: bool
            ) -> np.ndarray:
    """Each sample's prediction by its unit's taps (time-reversed, the
    newest last), summed tap by tap from the sample itself (`base`) or
    from 0.0: a loop over the taps, a vector over the samples. A unit
    reads across its start into the previous unit's samples, the first
    unit reads zeros. x [..., n], params [..., units, npu]."""
    n = x.shape[-1]
    npu = params.shape[-1]
    split = x.shape[:-1] + (units, n // units)
    xp = np.concatenate([np.zeros(x.shape[:-1] + (npu,), x.dtype), x],
                        axis=-1)
    acc = x.copy() if base else np.zeros(x.shape, x.dtype)
    out = acc.reshape(split)
    prod = np.empty(split, x.dtype)
    with np.errstate(all="ignore"):
        for j in range(npu):
            np.multiply(params[..., j, None], xp[..., j : j + n].reshape(
                split), out=prod)
            out += prod
    return acc


def first_strict_min(losses: np.ndarray) -> np.ndarray:
    """Index of the first strict minimum over the last axis, from
    FLT_MAX (linne_network.c:336-340, 612-618)."""
    best = np.zeros(losses.shape[:-1], np.int64)
    low = np.full(losses.shape[:-1], FLT_MAX)
    for i in range(losses.shape[-1]):
        take = losses[..., i] < low
        low = np.where(take, losses[..., i], low)
        best = np.where(take, i, best)
    return best


def unit_counts(order: int, n: int) -> List[int]:
    """Unit counts a layer tries (linne_network.c:300-303)."""
    out, u = [], 1
    while u <= min(MAX_UNITS, order):
        if order % u == 0 and n % u == 0:
            out.append(u)
        u <<= 1
    return out


def quantize(params: np.ndarray):
    """Error-feedback quantizer of rows [..., P], tail to head
    (lpc.c:981-1040): (int coefficients [..., P], shift [...])."""
    qmax = 1 << (COEF_BITS - 1)
    absval = np.abs(params)
    max_abs = np.zeros(params.shape[:-1], params.dtype)
    for i in range(params.shape[-1]):  # `<` from 0.0: a NaN never wins
        max_abs = np.where(max_abs < absval[..., i], absval[..., i], max_abs)
    low = max_abs <= 2.0 ** -(COEF_BITS - 1)
    rshift = (COEF_BITS - 1) - np.frexp(max_abs)[1]
    scale = np.ldexp(np.ones_like(max_abs), rshift)
    ints = np.zeros(params.shape, np.int64)
    qerror = np.zeros(params.shape[:-1], params.dtype)
    with np.errstate(all="ignore"):
        for t in range(params.shape[-1] - 1, -1, -1):
            qerror = qerror + params[..., t] * scale
            q = np.clip(c_round(qerror), -qmax, qmax - 1)
            qerror = qerror - q
            ints[..., t] = np.where(low, 0, q).astype(np.int64)
    return ints, np.where(low, COEF_BITS, rshift).astype(np.int64)


def preemphasis_coef(x: np.ndarray, dtype=np.float64) -> np.ndarray:
    """Each row's 5-bit pre-emphasis coefficient (linne_utility.c:158-193)
    from the serial sums of x[t]^2 and x[t] x[t+1] over t < n - 1."""
    d = x.astype(dtype)
    c0 = serial_sum(d[..., :-1] * d[..., :-1])
    c1 = serial_sum(d[..., :-1] * d[..., 1:])
    with np.errstate(all="ignore"):
        ratio = c1 / c0
    coef = np.minimum(c_round(ratio * 32.0), (1 << (PREEMPH_SHIFT - 1)) - 1)
    return np.where((c0 < 1e-6) | (ratio < 0.0), 0, coef).astype(np.int64)


# -- the analysis -------------------------------------------------------------

class Fits(NamedTuple):
    """The cascade's result for rows [M]: the winner's units, params, and
    for every (ridge, layer, level) what its fits left in the arena."""
    best_ridge: np.ndarray     # [M]
    units: np.ndarray          # [M, L]
    params: List[np.ndarray]   # per layer [M, P]
    deposits: list             # [ridge][layer] (levels, best [M], parcor
    #                            [(M, npu)], any zero case [(M,)])


def fit(x: np.ndarray, orders: Sequence[int], ridges: Sequence[float]
        ) -> Fits:
    """The ridge sweep and layer cascade of rows x [M, n] (float64, the
    pre-emphasized samples scaled to [-1, 1))."""
    M, n = x.shape
    R = len(ridges)
    ridge = np.asarray(ridges, x.dtype)[:, None, None]
    h = np.broadcast_to(x, (R, M, n)).copy()
    deposits = [[None] * len(orders) for _ in range(R)]
    layer_units, layer_params = [], []
    for li, order in enumerate(orders):
        levels = unit_counts(order, n)
        losses, preds, params_l, parc_l, zc_l = [], [], [], [], []
        for u in levels:
            npu, ns = order // u, n // u
            if ns & 1 or ns <= npu:
                raise ValueError(f"sub-length {ns} of order {order} at {u} "
                                 "units is not modelled")
            seg = h.reshape(R, M, u, ns) * welch_window(ns).astype(x.dtype)
            ac = autocorrelation(seg, npu + 1)
            ac[..., 0] = ac[..., 0] * (1.0 + ridge)
            coef, parcor, zc = levinson(ac, npu)
            params = coef[..., ::-1]  # [R, M, u, npu], taps time-reversed
            with np.errstate(all="ignore"):
                res = predict(h, params, u, base=True)
                losses.append(serial_sum(np.abs(res[..., 1:])) / n)
            preds.append(params)
            params_l.append(params.reshape(R, M, order))
            parc_l.append(parcor[:, :, -1])   # the last unit's write
            zc_l.append(zc.any(axis=-1))     # [npu] = 0 by any unit
        best = first_strict_min(np.stack(losses, axis=-1))  # [R, M]
        for ri in range(R):
            deposits[ri][li] = (levels, best[ri],
                                [p[ri] for p in parc_l],
                                [z[ri] for z in zc_l])
        forward = np.zeros((R, M, n), x.dtype)
        chosen = np.zeros((R, M, order), x.dtype)
        for k, u in enumerate(levels):
            sel = best == k
            if not sel.any():
                continue
            pred = predict(h[sel], preds[k][sel], u, base=False)
            out = h[sel].copy()
            with np.errstate(all="ignore"):
                out[:, 1:] = out[:, 1:] + pred[:, 1:]
            forward[sel] = out
            chosen[sel] = params_l[k][sel]
        h = forward
        layer_units.append(np.asarray(levels)[best])
        layer_params.append(chosen)
    with np.errstate(all="ignore"):
        final = serial_sum(np.abs(h)) / n  # [R, M]
    win = first_strict_min(final.T)  # [M]
    rows = np.arange(M)
    return Fits(win, np.stack([u[win, rows] for u in layer_units], axis=1),
                [p[win, rows] for p in layer_params], deposits)


def deposit(arena: np.ndarray, fits: Fits, row: int, ridges: int) -> None:
    """Replay one channel's fits into the arena's parcor_coef in the C
    encoder's order: each ridge term's pass, then the winner's final pass;
    in each, every layer's levels in turn, then the chosen level's refit.
    A level leaves its last unit's parcor[0..npu-1], and parcor[npu] = 0
    where any of its units took the zero case."""
    for ri in list(range(ridges)) + [int(fits.best_ridge[row])]:
        for levels, best, parcor, zc in fits.deposits[ri]:
            for k in list(range(len(levels))) + [int(best[row])]:
                npu = parcor[k].shape[-1]
                arena[:npu] = parcor[k][row]
                if zc[k][row]:
                    arena[npu] = 0.0


def estimates(blocks: np.ndarray, order: int, bps: int, dtype=np.float64):
    """What the block-type estimate computes of each input channel before
    it reads the arena: (power [..], parcor [.., order], zero case [..])
    of blocks [..., n] (integer samples)."""
    n = blocks.shape[-1]
    x = blocks.astype(dtype) * 2.0 ** -(bps - 1)
    ac = autocorrelation(x * sine_window(n).astype(dtype), order + 1)
    _coef, parcor, zc = levinson(ac, order)
    return ac[..., 0] * math.pow(2, 2.0 * (bps - 1)), parcor, zc


def code_length(arena: np.ndarray, power: float, parcor: np.ndarray,
                zc: bool, n: int, order: int) -> float:
    """Estimated bits a sample (lpc.c:810-865): the recursion's writes go
    to the arena first, then parcor[1..order] is read from it."""
    arena[:order] = parcor
    if zc:
        arena[order] = 0.0
    if abs(power) <= FLT_MIN:
        return 0.0
    mean_power = log2(power) - log2(float(n))
    var_ratio = 0.0
    for k in range(1, order + 1):
        p = float(arena[k])
        var_ratio += log2(1.0 - p * p)
    length = BETA_LAPLACE + 0.5 * (mean_power + var_ratio)
    return 1.0 if length <= 0 else length


def analyse_tracks(tracks: Sequence[np.ndarray], num_blocks: int,
                   config: dict, dtype=np.float64) -> List[List[Block]]:
    """The first `num_blocks` blocks of each track [C, samples] (int), as
    the upstream encoder writes them when it encodes the track from its
    start: one list of Blocks a track."""
    step = max(1, GROUP_BLOCKS // max(num_blocks, 1))
    if len(tracks) > step:  # rows are independent: the same result
        return [blocks for i in range(0, len(tracks), step)
                for blocks in analyse_tracks(tracks[i : i + step],
                                             num_blocks, config, dtype)]
    f = config["format"]
    n = f["num_samples_per_block"]
    bps = f["bits_per_sample"]
    orders = list(config["layer_num_params"])
    ridges = list(config["ridge_terms"])
    if config.get("afmethod_iterations", 0) or config.get("learning"):
        raise ValueError("-a N and -l are not modelled")
    C = f["num_channels"]
    for t in tracks:
        if t.shape[-1] < num_blocks * n:
            raise ValueError("a track is shorter than the blocks asked for")
    # [S, K, C, n]
    x = np.stack([np.stack([t[:, k * n : (k + 1) * n]
                            for k in range(num_blocks)]) for t in tracks])
    S = x.shape[0]
    power, est_parcor, est_zc = estimates(x, orders[0], bps, dtype)

    # mid/side and the two pre-emphasis stages
    plane = torch.from_numpy(x.astype(np.int64))
    if f["mid_side"]:
        plane = integer.ms(plane)
    prevs, coefs = [], []
    for _ in range(NUM_PREEMPH):
        prev = plane[..., 0]
        coef = torch.from_numpy(preemphasis_coef(plane.numpy(), dtype))
        plane = integer.preemphasis(plane, prev, coef)
        prevs.append(prev.numpy())
        coefs.append(coef.numpy())
    rows = plane.reshape(-1, n)
    fits = fit(rows.numpy().astype(dtype) * 2.0 ** -(bps - 1), orders, ridges)

    # the integer prediction cascade and the Rice parameters
    ints, shifts = [], []
    res = rows
    for li, order in enumerate(orders):
        q, sh = quantize(fits.params[li])
        ints.append(q)
        shifts.append(sh)
        log2u = torch.from_numpy(np.log2(fits.units[:, li]).astype(np.int64))
        res = integer.predict(res, torch.from_numpy(q), log2u,
                              torch.from_numpy(sh))
    porder, k2 = rice_search(res, torch.float64)
    log2u = np.log2(fits.units).astype(np.int64)
    coef_all = np.concatenate(ints, axis=1)
    shift_all = np.stack(shifts, axis=1)

    def per_block(a, s, k):
        i = (s * num_blocks + k) * C
        return a[i : i + C]

    out = []
    for s in range(S):
        arena = np.zeros(MAX_UNITS + 2)  # a fresh encoder's parcor_coef
        blocks = []
        for k in range(num_blocks):
            mean = 0.0
            for c in range(C):
                mean += code_length(arena, float(power[s, k, c]),
                                    est_parcor[s, k, c], bool(est_zc[s, k, c]),
                                    n, orders[0])
            mean /= C
            mean /= bps
            if mean >= RAW_THRESHOLD:
                blocks.append(Block(BLOCK_RAW, *[None] * 7))
                continue
            if not x[s, k].any():
                blocks.append(Block(BLOCK_SILENT, *[None] * 7))
                continue
            for c in range(C):
                deposit(arena, fits, (s * num_blocks + k) * C + c,
                        len(ridges))
            blocks.append(Block(
                BLOCK_COMPRESS,
                np.stack([p[s, k] for p in prevs], axis=-1),
                np.stack([p[s, k] for p in coefs], axis=-1),
                per_block(log2u, s, k), per_block(shift_all, s, k),
                per_block(coef_all, s, k),
                per_block(porder.numpy(), s, k),
                per_block(k2.numpy(), s, k)))
        out.append(blocks)
    return out
