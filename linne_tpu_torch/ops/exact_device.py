"""Serial-order-preserving LPC analysis of the byte-exact encoder, batched
on a torch device. Counterpart of linne_tpu/ops/exact_device.py.

This expresses the reference encoder's exact double-precision analysis —
serial-order windowed autocorrelation, Levinson-Durbin (reference:
libs/lpc/src/lpc.c:252-324), the power-of-two unit-count search and greedy
layer cascade (libs/linne_network/src/linne_network.c:268-347,582-630) and
the error-feedback coefficient quantizer (lpc.c:981-1040) — as one batched
computation over fit rows, so that byte-exact `.lnn` production can run the
fits on the card instead of the host oracle's loops.

Faithfulness contract (matches `exact` op for op):

- every C serial accumulation runs in the same left-to-right order from
  the same 0.0: on CUDA tensors in the hand-written kernels of
  `ops/exact_serial.py` (`csrc/exact_serial.cu`), on CPU tensors in their
  plain torch versions;
- the quantizer's error feedback runs tap by tap, every layer of a fit in
  one launch of `analysis_scans.quantize_layers_exact`
  (`csrc/analysis_scans.cu`) on CUDA tensors, in its plain torch version
  (`_quantize_layers_plain`) on CPU tensors;
- the per-sample unit prediction is a serial chain over taps but a vector
  over time;
- zero-signal early-outs (|r0| < FLT_EPSILON) are computed as masks over
  the full recursion, value-identical to the reference's skip;
- the per-fit writes into the shared `LPCCalculator` arena (whose stale
  reads later feed EstimateCodeLength, see exact/lpc.py) are returned per
  level so the caller can replay them into the host arena in the
  reference's order (`fold_parcor_state`).

The CPU and the card both compute IEEE float64, with every operation
rounded on its own (the kernels use the non-contracting `__dmul_rn` /
`__dadd_rn` intrinsics), so the strict graph is byte-identical to the
oracle by construction on both, and it is the default everywhere.

Two modes, as in the JAX package:

- **strict** — the serial sums above; bit-identical to the oracle.
- **fast** — the same operation set with the serial sums replaced by plain
  torch reductions (another summation order). Kept for parity with the
  JAX API; the encoder's margin guard certifies its decisions. Select it
  with `strict=False` or LINNE_EXACT_DEVICE_STRICT=0.

Scope: blocks must divide evenly at every unit level with even
sub-lengths (full 10240-sample blocks always do); odd sub-lengths would
need the reference's stale Welch middle sample (lpc.c:196-205).
"""

from __future__ import annotations

import functools
import math
import os
from typing import List, Sequence

import numpy as np
import torch

from ..constants import FLT_EPSILON, FLT_MAX
from ..exact.lpc import _welch_window
from . import analysis_scans as _as
from . import exact_serial as _ks

_MAX_NUM_UNITS = 128

_F64 = torch.float64


def _resolve_strict(strict) -> bool:
    """None -> strict (the CPU and CUDA are both IEEE float64).
    LINNE_EXACT_DEVICE_STRICT overrides ("1"/"0")."""
    if strict is not None:
        return bool(strict)
    env = os.environ.get("LINNE_EXACT_DEVICE_STRICT")
    if env not in (None, "", "auto"):
        return env not in ("0", "fast", "false")
    return True


@functools.lru_cache(maxsize=256)
def _valid_levels(num_params: int, n: int) -> list:
    """Power-of-two unit counts admissible for (num_params, n) — the same
    filter as linne_network.c:300-303."""
    levels = []
    u = 1
    while u <= min(_MAX_NUM_UNITS, num_params):
        if not (num_params % u or n % u):
            levels.append(u)
        u <<= 1
    return levels


def supported(layer_num_params: Sequence[int], n: int) -> bool:
    """True when every admissible unit level has an even sub-length (no
    stale Welch middle sample) and every layer order fits its sub-length."""
    for p in layer_num_params:
        levels = _valid_levels(p, n)
        if not levels:
            return False
        for u in levels:
            ns = n // u
            if ns & 1 or ns <= p // u:
                return False
    return True


# ---------------------------------------------------------------------------
# serial building blocks: strict = the kernels of exact_serial, fast =
# plain torch reductions
# ---------------------------------------------------------------------------


def _autocorr_fast(seg: torch.Tensor, nlags: int) -> torch.Tensor:
    """Fast-mode autocorrelation: one parallel reduction per lag (the same
    products as the serial version, another summation order)."""
    ns = seg.shape[-1]
    segp = torch.cat([seg, seg.new_zeros(seg.shape[:-1] + (nlags - 1,))],
                     dim=-1)
    cols = [torch.sum(seg * segp[..., lag : lag + ns], dim=-1)
            for lag in range(nlags)]
    return torch.stack(cols, dim=-1)


def _autocorr(seg: torch.Tensor, nlags: int, strict: bool) -> torch.Tensor:
    return (_ks.autocorr_serial if strict else _autocorr_fast)(seg, nlags)


def _levinson_fast(ac: torch.Tensor, order: int):
    """Fast-mode Levinson-Durbin: the same recursion with the inner serial
    sum as ONE parallel dot per step (`a` keeps zeros beyond the current
    step, so products outside 0..k contribute exact zeros). Returns
    (lpc_coef, parcor, zerocase) like the serial version."""
    zerocase = torch.abs(ac[..., 0]) < FLT_EPSILON
    shape = ac.shape[:-1]
    a = ac.new_zeros(shape + (order + 2,))
    a[..., 0] = 1.0
    parc = ac.new_zeros(shape + (order,))
    ek = ac[..., 0]
    a1 = -ac[..., 1] / ac[..., 0]
    parc[..., 0] = ac[..., 1] / ek
    ek = ek + ac[..., 1] * a1
    a[..., 1] = a1
    if order > 1:
        # acr_pad[m] = ac[order - m], zero-padded so per-step windows of
        # length order+2 always read defined values
        acr_pad = torch.cat([torch.flip(ac, dims=[-1]),
                             ac.new_zeros(shape + (order + 2,))], dim=-1)
        for k in range(1, order):
            # w[i] = ac[k+1-i] for i <= k+1, zeros beyond (a is zero there)
            w = acr_pad[..., order - k - 1 : 2 * order - k + 1]
            g = torch.sum(a * w, dim=-1)
            gamma = g / (-ek)
            ek = ek * (1.0 - gamma * gamma)
            # v[i] = a[k+1-i] for 1 <= i <= k+1, zeros at i=0 and beyond
            ar_pad = torch.cat([torch.flip(a, dims=[-1]),
                                a.new_zeros(shape + (order + 2,))], dim=-1)
            v = ar_pad[..., order - k : 2 * order - k + 2]
            a = a + gamma[..., None] * v
            parc[..., k] = -gamma
    nz = (~zerocase)[..., None]
    return (torch.where(nz, a[..., 1 : order + 1], 0.0),
            torch.where(nz, parc, 0.0), zerocase)


def _levinson(ac: torch.Tensor, order: int, strict: bool):
    if strict:
        return _ks.levinson_serial(ac.contiguous(), order)
    return _levinson_fast(ac, order)


def _chain_predict(x: torch.Tensor, params: torch.Tensor, num_units: int,
                   strict: bool = True):
    """Per-sample serial tap chains, vectorised over time
    (linne_network.c:165-210,319-335; oracle: _unit_predictions).

    x: [B, n] layer input; params: [B, num_units, npu] stored time-reversed
    like layer.params. Returns (with_base, no_base), each [B, n].
    Fast mode keeps the tap chain but drops the NaN shield, as the JAX
    fast graph does."""
    if strict:
        return _ks.chain_predict(x.contiguous(), params.contiguous())
    B, n = x.shape
    npu = params.shape[2]
    ns = n // num_units
    xp = torch.cat([x.new_zeros((B, npu)), x], dim=1)
    base = x.reshape(B, num_units, ns)
    nobase = x.new_zeros((B, num_units, ns))
    for j in range(npu):
        term = params[:, :, j : j + 1] * xp[:, j : j + n].reshape(
            B, num_units, ns)
        base = base + term
        nobase = nobase + term
    return base.reshape(B, n), nobase.reshape(B, n)


def _serial_abs_mean(rows: torch.Tensor, start: int, n: int,
                     strict: bool = True) -> torch.Tensor:
    """sum(|rows[..., start:n]|) / n over the trailing axis — serial in t
    in strict mode (linne_network.c:50-63), a parallel reduction in fast
    mode. rows: [B, ...]; returns [B, ...]."""
    if not strict:
        return _ks._div(torch.sum(torch.abs(rows[..., start:n]), dim=-1), n)
    return _ks.serial_abs_mean(rows.contiguous(), start, n)


# ---------------------------------------------------------------------------
# quantizer (lpc.c:981-1040)
# ---------------------------------------------------------------------------


# Exact powers of two, indexed by e + 1074 for e in [-1074, 1023], with an
# inf guard entry (the JAX package's table: pow on the card is not
# guaranteed exact, a table lookup is).
_POW2_OFFSET = 1074
_POW2_TABLE = np.array(
    [2.0 ** e for e in range(-1074, 1024)] + [np.inf], dtype=np.float64)


@functools.lru_cache(maxsize=8)
def _pow2_table(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_POW2_TABLE).to(device)


def _exp2_int(e: torch.Tensor) -> torch.Tensor:
    """Exact 2**e for integer e (table lookup)."""
    tab = _pow2_table(e.device)
    idx = torch.clamp(e.long() + _POW2_OFFSET, 0, tab.shape[0] - 2)
    return tab[idx]


def _frexp_exponent(x: torch.Tensor) -> torch.Tensor:
    """The frexp exponent of finite positive x (x = m * 2**e, m in
    [0.5, 1)); torch.frexp is exact on the CPU and the card. The JAX
    package's table search gives the same exponent there; at x = 0 both
    results are masked by the quantizer's low path."""
    return torch.frexp(x)[1].to(torch.int32)


def _quantize_layers(params: torch.Tensor, orders: Sequence[int],
                     nbits: int):
    """The error-feedback quantizer on every layer of a fit: params [B, W]
    f64 holds the layers' final params side by side from column 0.
    Returns (int_coef [B, sum(orders)] i32, rshift [B, L] i32,
    round_margin [B] f64, scale_margin [B] f64), each margin the minimum
    over the layers of `_quantize_layer_plain`'s. A CPU tensor takes
    `_quantize_layers_plain`; any other launches the kernel once
    (`analysis_scans.quantize_layers_exact`, bit-equal to it) or raises."""
    if params.device.type == "cpu":
        return _quantize_layers_plain(params, orders, nbits)
    return _as.quantize_layers_exact(params, orders, nbits)


def _quantize_layers_plain(params: torch.Tensor, orders: Sequence[int],
                           nbits: int):
    """_quantize_layers as `_quantize_layer_plain` a layer, the margins
    folded with torch.minimum in the layers' order: the kernel's plain
    version."""
    B = params.shape[0]
    int_parts, rshifts = [], []
    round_margin = torch.full((B,), math.inf, dtype=_F64,
                              device=params.device)
    scale_margin = torch.full_like(round_margin, math.inf)
    col = 0
    for order in orders:
        ic, rs, rm, sm = _quantize_layer_plain(
            params[:, col:col + order], nbits)
        int_parts.append(ic)
        rshifts.append(rs)
        round_margin = torch.minimum(round_margin, rm)
        scale_margin = torch.minimum(scale_margin, sm)
        col += order
    return (torch.cat(int_parts, dim=1), torch.stack(rshifts, dim=1),
            round_margin, scale_margin)


def _quantize_layer_plain(coefs: torch.Tensor, nbits: int):
    """Error-feedback quantizer, tail-to-head (lpc.c:981-1040; oracle:
    exact/lpc.py quantize_coefficients). coefs: [B, P] final f64 params.
    Returns (int_coef [B, P] i32, rshift [B] i32, round_margin [B] f64,
    scale_margin [B] f64) — the margins are the guard's sensors for this
    stage: `round_margin` is the minimum absolute distance of any
    error-feedback step to its round-half-away boundary (in quantized-LSB
    units), `scale_margin` the relative distance of max|coef| to the
    nearest frexp power-of-two boundary and to the `low` threshold (both
    flip the transmitted rshift)."""
    B, P = coefs.shape
    qmax = 1 << (nbits - 1)
    # max |coef| with the reference's `<` update order from 0.0: NaNs never
    # win, and every candidate is >= +0.0, so amax over the NaN-cleared
    # values is the same number
    av = torch.abs(coefs)
    max_abs = torch.where(av == av, av, 0.0).amax(dim=1)
    lowthr = 2.0 ** (-(nbits - 1))
    low = max_abs <= lowthr

    ndigit = _frexp_exponent(max_abs)
    rshift = (nbits - 1) - ndigit
    scale = _exp2_int(rshift)

    # rshift boundary sensors: frexp bin edges 2^(ndigit-1) <= m < 2^ndigit
    # (masked on the low path, where ndigit is unused) and the low threshold
    fm = torch.minimum(max_abs - _exp2_int(ndigit - 1),
                       _exp2_int(ndigit) - max_abs)
    fm = fm / torch.clamp(max_abs, min=1e-300)
    lm = torch.abs(max_abs - lowthr) / lowthr
    inf = torch.full_like(max_abs, math.inf)
    scale_margin = torch.minimum(torch.where(low, inf, fm), lm)

    # Only the error feedback is serial: the products, the rounding-margin
    # sensor and the int cast are elementwise over the taps, so they run
    # once on [B, P] (a tap loop of plain torch ops costs a launch per op
    # and tap on the card). sums[:, i] is the fed-back value tap i rounds.
    prods = _ks._mulsh(coefs, scale[:, None])
    qerror = torch.zeros_like(max_abs)
    sums: List = [None] * P
    qtmps: List = [None] * P
    for ordi in range(P - 1, -1, -1):
        s = qerror + prods[:, ordi]
        # round half away from zero, then clamp to [-qmax, qmax - 1]: the
        # clamp equals the reference's two compares on integral values
        qtmp = torch.where(s >= 0.0, torch.floor(s + 0.5),
                           -torch.floor(0.5 - s))
        qtmp = torch.clamp(qtmp, -qmax, qmax - 1)
        qerror = s - qtmp
        sums[ordi] = s
        qtmps[ordi] = qtmp
    s = torch.stack(sums, dim=1)
    y = torch.where(s >= 0.0, s + 0.5, 0.5 - s)
    round_margin = torch.abs(y - torch.round(y)).amin(dim=1)
    int_coef = torch.stack(qtmps, dim=1).to(torch.int32)
    int_coef = torch.where(low[:, None], 0, int_coef)
    rshift = torch.where(low, nbits, rshift).to(torch.int32)
    # on the low path the int coefs are forced to zero regardless of the
    # rounding chain, so its boundaries are not drift-sensitive there
    round_margin = torch.where(low, inf, round_margin)
    return int_coef, rshift, round_margin, scale_margin


# ---------------------------------------------------------------------------
# one fit pass — linne_network.c:582-630 with AF iterations 0
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _window(ns: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_welch_window(ns).copy()).to(device)


def _layer_level_fits(buf: torch.Tensor, P: int, n: int,
                      regular_term: torch.Tensor, strict: bool = True):
    """Fit every admissible unit level of one layer on `buf`
    (linne_network.c:284-335). `regular_term` is a per-row [B] float64
    tensor (the ridge sweep's term of each row, or the -a N final pass's
    winning candidate).

    Returns (levels, level_params, level_preds_base, level_preds_nobase,
    level_parcor, level_zc, zc_margin [B], all_zc [B]) — lists indexed by
    level. `zc_margin` is the relative distance of every (unit, level)
    post-ridge r0 to the FLT_EPSILON zero-signal boundary (lpc.c:268), the
    byte-identity guard's sensor for this decision; `all_zc` is True where
    EVERY (unit, level) fit took the zero early-out (such rows' level
    losses are bit-equal by construction, so their argmin ties are
    deterministic and must not be flagged).
    """
    B = buf.shape[0]
    levels = _valid_levels(P, n)
    tfac = (1.0 + regular_term)[:, None]
    level_params = []
    level_preds_base = []
    level_preds_nobase = []
    level_parcor = []
    level_zc = []
    zc_margin = torch.full((B,), math.inf, dtype=_F64, device=buf.device)
    all_zc = torch.ones((B,), dtype=torch.bool, device=buf.device)
    for u in levels:
        npu = P // u
        ns = n // u
        seg = buf.reshape(B, u, ns) * _window(ns, buf.device)
        ac = _autocorr(seg, npu + 1, strict)
        # ridge on r0 (lpc.c:358): *= 1.0 + term (exact at term == 0)
        ac[..., 0] = ac[..., 0] * tfac
        ac0 = torch.abs(ac[..., 0])  # [B, U]
        zm = torch.abs(ac0 - FLT_EPSILON) / torch.clamp(ac0, min=FLT_EPSILON)
        zc_margin = torch.minimum(zc_margin, zm.amin(dim=1))
        coefs, parcor, zc = _levinson(ac, npu, strict)
        all_zc = all_zc & zc.all(dim=1)
        # layer.params layout: per unit, time-reversed taps
        params = torch.flip(coefs, dims=[2]).reshape(B, P)
        pb, pn = _chain_predict(buf, params.reshape(B, u, npu), u, strict)
        level_params.append(params)
        level_preds_base.append(pb)
        level_preds_nobase.append(pn)
        level_parcor.append(parcor[:, -1, :])  # last unit's write
        level_zc.append(zc[:, -1])
    return (levels, level_params, level_preds_base, level_preds_nobase,
            level_parcor, level_zc, zc_margin, all_zc)


def _first_strict_min(losses: torch.Tensor):
    """First strict minimum over the level axis (linne_network.c:336-340).
    losses: [B, L]. Returns (best [B] i32, gap [B] f64) where gap is the
    relative distance from the winner to the runner-up — the guard's sensor
    for this argmin. gap is +inf for a single candidate."""
    B, L = losses.shape
    min_loss = torch.full((B,), FLT_MAX, dtype=_F64, device=losses.device)
    best = torch.zeros((B,), dtype=torch.int32, device=losses.device)
    for li in range(L):
        take = losses[:, li] < min_loss
        min_loss = torch.where(take, losses[:, li], min_loss)
        best = torch.where(take, li, best)
    gap = torch.full_like(min_loss, math.inf)
    denom = torch.clamp(min_loss, min=1e-300)
    for li in range(L):
        d = (losses[:, li] - min_loss) / denom
        gap = torch.where(best == li, gap, torch.minimum(gap, d))
    return best, gap


def _forward(buf: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """data[1:] += prediction (linne_network.c:165-210)."""
    return torch.cat([buf[:, :1], buf[:, 1:] + pred[:, 1:]], dim=1)


def _fit_pass(x: torch.Tensor, layer_num_params: tuple, n: int,
              regular_term: torch.Tensor, strict: bool = True):
    """One greedy layer-by-layer fit, each row at its own ridge term.

    Returns (units [B,L] i32, params [B, sum(P)] f64, loss [B], arena,
    sel_margin [B], pass_all_zc [B]) where arena is a per-layer list of
    (level_parcor [(B, npu) per level], level_zc [(B,) per level],
    best_level [B] i32) — the raw material for `fold_parcor_state` — and
    sel_margin is the pass's minimum decision margin (zero-signal epsilon
    distances and unit-level argmin gaps; the guard's per-pass sensor).
    """
    B = x.shape[0]
    rows = torch.arange(B, device=x.device)
    buf = x
    all_units = []
    all_params = []
    arena = []
    sel_margin = torch.full((B,), math.inf, dtype=_F64, device=x.device)
    pass_all_zc = torch.ones((B,), dtype=torch.bool, device=x.device)

    for P in layer_num_params:
        (levels, level_params, level_preds_base, level_preds_nobase,
         level_parcor, level_zc, zc_margin, all_zc) = _layer_level_fits(
            buf, P, n, regular_term, strict)

        preds = torch.stack(level_preds_base, dim=1)  # [B, L, n]
        losses = _serial_abs_mean(preds, 1, n, strict)  # [B, L]
        best, gap = _first_strict_min(losses)
        # all-zero-fit rows' level losses are bit-equal -> tie is
        # deterministic (first index), not drift-sensitive
        sel_margin = torch.minimum(sel_margin, zc_margin)
        sel_margin = torch.minimum(
            sel_margin, torch.where(all_zc, math.inf, gap))
        pass_all_zc = pass_all_zc & all_zc

        bl = best.long()
        params_sel = torch.stack(level_params, dim=1)[rows, bl]
        pred_sel = torch.stack(level_preds_nobase, dim=1)[rows, bl]
        units_sel = torch.tensor(levels, dtype=torch.int32,
                                 device=x.device)[bl]
        buf = _forward(buf, pred_sel)
        all_units.append(units_sel)
        all_params.append(params_sel)
        arena.append((level_parcor, level_zc, best))

    loss = _serial_abs_mean(buf, 0, n, strict)
    return (torch.stack(all_units, dim=1), torch.cat(all_params, dim=1),
            loss, arena, sel_margin, pass_all_zc)


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------


def build_fit_fn(layer_num_params: tuple, ridge_terms: tuple, n: int,
                 bits_per_sample: int, coef_bits: int, strict=None):
    """The full preset fit for one block shape. `strict` selects the
    bit-exact serial graph or the fast graph (None = strict; module
    docstring)."""
    return _build_fit_fn(tuple(layer_num_params), tuple(ridge_terms), n,
                         bits_per_sample, coef_bits, _resolve_strict(strict))


@functools.lru_cache(maxsize=16)
def _build_fit_fn(layer_num_params: tuple, ridge_terms: tuple, n: int,
                  bits_per_sample: int, coef_bits: int, strict: bool):
    """Returns fit: int32 signals [B, n] (post MS + pre-emphasis, on the
    device to compute on) -> dict of tensors on that device:
      units     [B, L] i32      — chosen unit count per layer
      params    [B, sum(P)] f64 — final layer params (time-reversed layout)
      int_coefs [B, sum(P)] i32 — error-feedback-quantized coefficients
      rshifts   [B, L] i32      — per-layer right shifts
      best_term [B] i32         — winning ridge-candidate index
      arena_parcor [B, AW] f64, arena_zc [B, AZ] bool,
      arena_best [B, T*L] i32   — the per-term/layer/level parcor arena
                writes flattened in (term, layer, level) column order for
                `fold_parcor_state`
      margins   [B, 3] f64      — the guard's sensors: [:, 0] selection
                margins (relative: zero-eps, level/term argmin gaps),
                [:, 1] rshift-scale margins (relative), [:, 2] rounding
                margins (absolute, quantized-LSB units)

    The ridge term enters the math at exactly one multiply (ac[0] *= 1 +
    term), so the sweep over the T terms is ONE fit pass over T * B rows,
    term-major (the JAX package's vmap over terms, written out); every row
    takes the same per-row ops, so the bits are those of T separate passes.

    AF iterations must be 0: with 0 iterations the reference's final refit
    recomputes exactly the winning sweep pass (fits are arena-read-free at
    even sub-lengths), so one pass per ridge term suffices for
    bit-identity (linne_network.c:605-630). Raises ValueError on shapes
    `supported` rejects.
    """
    if not supported(layer_num_params, n):
        raise ValueError(f"unsupported shape for device-exact fit: "
                         f"{layer_num_params} n={n}")
    if not ridge_terms:
        raise ValueError("empty ridge list")

    scale = 2.0 ** (-(bits_per_sample - 1))
    T = len(ridge_terms)

    def fit(signals: torch.Tensor) -> dict:
        x = signals.to(_F64) * scale  # exact: int -> f64, * 2^-k
        B = x.shape[0]
        dev = x.device
        terms = torch.tensor(ridge_terms, dtype=_F64,
                             device=dev).repeat_interleave(B)
        units_t, params_t, loss_t, arena_t, selm_t, allzc_t = _fit_pass(
            x.repeat(T, 1), layer_num_params, n, terms, strict)
        units_t = units_t.reshape(T, B, -1)
        params_t = params_t.reshape(T, B, -1)
        loss_t = loss_t.reshape(T, B)
        # guard sensor: min per-pass decision margin across the sweep
        sel_margin = selm_t.reshape(T, B).amin(dim=0)
        if T == 1:
            units, params = units_t[0], params_t[0]
            best_term = torch.zeros((B,), dtype=torch.int32, device=dev)
        else:
            # first strict minimum over ridge candidates
            # (linne_network.c:612-618)
            min_loss = torch.full((B,), FLT_MAX, dtype=_F64, device=dev)
            best_term = torch.zeros((B,), dtype=torch.int32, device=dev)
            for i in range(T):
                take = loss_t[i] < min_loss
                min_loss = torch.where(take, loss_t[i], min_loss)
                best_term = torch.where(take, i, best_term)
            units, params = units_t[0], params_t[0]
            for i in range(1, T):
                m = (best_term == i)[:, None]
                units = torch.where(m, units_t[i], units)
                params = torch.where(m, params_t[i], params)
            # term-argmin gap (all-zero-fit rows' passes are bit-equal ->
            # their tie is deterministic, like the level argmin)
            term_gap = torch.full((B,), math.inf, dtype=_F64, device=dev)
            denom = torch.clamp(min_loss, min=1e-300)
            for i in range(T):
                d = (loss_t[i] - min_loss) / denom
                term_gap = torch.where(best_term == i, term_gap,
                                       torch.minimum(term_gap, d))
            term_gap = torch.where(allzc_t.reshape(T, B).all(dim=0),
                                   math.inf, term_gap)
            sel_margin = torch.minimum(sel_margin, term_gap)

        int_coefs, rshifts, round_margin, scale_margin = _quantize_layers(
            params, layer_num_params, coef_bits)

        # flatten the arena in (term, layer, level) order
        ap_cols: List = []
        zc_cols: List = []
        best_cols: List = []
        for ti in range(T):
            sl = slice(ti * B, (ti + 1) * B)
            for level_parcor, level_zc, best in arena_t:
                ap_cols.extend(lp[sl] for lp in level_parcor)
                zc_cols.extend(z[sl] for z in level_zc)
                best_cols.append(best[sl])
        return {
            "units": units,
            "params": params,
            "int_coefs": int_coefs,
            "rshifts": rshifts,
            "best_term": best_term,
            "arena_parcor": torch.cat(ap_cols, dim=1),
            "arena_zc": torch.stack(zc_cols, dim=1),
            "arena_best": torch.stack(best_cols, dim=1),
            "margins": torch.stack(
                [sel_margin, scale_margin, round_margin], dim=1),
        }

    return fit


@functools.lru_cache(maxsize=64)
def _packed_fit_layout(layer_num_params: tuple, ridge_terms: tuple, n: int):
    """Column widths of the two packed fit buffers (see
    `build_packed_fit_fn`): returns (f64 split offsets, i32 split offsets,
    n_layers, sum_params)."""
    entries, L = arena_layout(layer_num_params, ridge_terms, n)
    sum_p = int(sum(layer_num_params))
    aw = max(off + w for off, w, _ in entries.values())
    az = max(z for _, _, z in entries.values()) + 1
    tl = len(ridge_terms) * L
    f64_offs = np.cumsum([0, sum_p, aw, 3])  # params, arena_parcor, margins
    i32_offs = np.cumsum([0, L, sum_p, L, 1, tl, az])
    #          units, int_coefs, rshifts, best_term, arena_best, arena_zc
    return f64_offs, i32_offs, L, sum_p


def build_packed_fit_fn(layer_num_params: tuple, ridge_terms: tuple, n: int,
                        bits_per_sample: int, coef_bits: int, strict=None):
    """`build_fit_fn` with every output packed into TWO tensors ([B, F]
    f64 and [B, I] i32), plus an `unpack(f64_np, i32_np) -> dict` that
    recovers the canonical dict on the host: one device-to-host copy per
    buffer and chunk instead of nine."""
    return _build_packed_fit_fn(
        tuple(layer_num_params), tuple(ridge_terms), n, bits_per_sample,
        coef_bits, _resolve_strict(strict))


@functools.lru_cache(maxsize=16)
def _build_packed_fit_fn(layer_num_params: tuple, ridge_terms: tuple, n: int,
                         bits_per_sample: int, coef_bits: int, strict: bool):
    base = _build_fit_fn(layer_num_params, ridge_terms, n,
                         bits_per_sample, coef_bits, strict)
    fo, io, _L, _sum_p = _packed_fit_layout(layer_num_params, ridge_terms, n)

    def packed(signals: torch.Tensor):
        out = base(signals)
        f64 = torch.cat(
            [out["params"], out["arena_parcor"], out["margins"]], dim=1)
        i32 = torch.cat(
            [out["units"], out["int_coefs"], out["rshifts"],
             out["best_term"][:, None], out["arena_best"],
             out["arena_zc"].to(torch.int32)], dim=1)
        return f64, i32

    def unpack(f64: np.ndarray, i32: np.ndarray) -> dict:
        return {
            "params": f64[:, fo[0] : fo[1]],
            "arena_parcor": f64[:, fo[1] : fo[2]],
            "margins": f64[:, fo[2] : fo[3]],
            "units": i32[:, io[0] : io[1]],
            "int_coefs": i32[:, io[1] : io[2]],
            "rshifts": i32[:, io[2] : io[3]],
            "best_term": i32[:, io[3]],
            "arena_best": i32[:, io[4] : io[5]],
            "arena_zc": i32[:, io[5] : io[6]] != 0,
        }

    return packed, unpack


# ---------------------------------------------------------------------------
# -a N final pass (device search/forward + host AF refit hybrid)
# ---------------------------------------------------------------------------
#
# With num_afmethod_iterations > 0 the reference's final refit pass
# (linne_network.c:628-629) is NOT a replay of the winning sweep pass: each
# layer re-runs the unit-count search (AF iterations 0) on the current
# residual, then refits the chosen split with N auxiliary-function (IRLS)
# iterations (lpc.c:578-661) before forwarding. The IRLS solve uses libm
# `pow(s, -0.5)` inside the Cholesky (lpc.c:402-448), which is not
# correctly rounded on glibc, so the refit itself runs on the HOST (the
# oracle's libm), while the device runs the searches and forwards that
# surround it:
#
#   to_f64, searches, forwards = build_final_pass_fns(...)
#   buf = to_f64(signals)
#   for li in layers:
#       s = searches[li](buf, term_row)      # device: level search
#       params = <host AF refit at s["units"]>
#       buf = forwards[li](buf, params, s["best"])   # device: forward


def _search_impl(buf: torch.Tensor, term_row: torch.Tensor, P: int, n: int,
                 strict: bool = True) -> dict:
    """Final-pass unit-count search for one layer: AF-iteration-0 fits of
    every admissible level at each row's winning ridge term
    (linne_network.c:268-347).

    Returns dict(best [B] i32, units [B] i32,
    parcor [B, sum(npu over levels)] f64, zc [B, n_levels] bool,
    margin [B] f64) — parcor/zc are the per-level arena deposits for
    `fold_final_pass`; margin is this search's guard sensor (zero-eps
    distances + the level-argmin gap, tie-gated like the sweep's).
    """
    (levels, _level_params, level_preds_base, _level_preds_nobase,
     level_parcor, level_zc, zc_margin, all_zc) = _layer_level_fits(
        buf, P, n, term_row, strict)
    preds = torch.stack(level_preds_base, dim=1)
    losses = _serial_abs_mean(preds, 1, n, strict)
    best, gap = _first_strict_min(losses)
    margin = torch.minimum(zc_margin, torch.where(all_zc, math.inf, gap))
    return {
        "best": best,
        "units": torch.tensor(levels, dtype=torch.int32,
                              device=buf.device)[best.long()],
        "parcor": torch.cat(level_parcor, dim=1),
        "zc": torch.stack(level_zc, dim=1),
        "margin": margin,
    }


def _forward_impl(buf: torch.Tensor, params: torch.Tensor,
                  best: torch.Tensor, P: int, n: int,
                  strict: bool = True) -> torch.Tensor:
    """Forward one layer with host-refined params at the (data-dependent)
    chosen unit level (linne_network.c:165-210): predictions are computed at
    every admissible level from the same [B, P] parameter block and the
    chosen level's is selected — non-chosen lanes are discarded."""
    B = buf.shape[0]
    preds = []
    for u in _valid_levels(P, n):
        npu = P // u
        _pb, pn = _chain_predict(buf, params.reshape(B, u, npu), u, strict)
        preds.append(pn)
    rows = torch.arange(B, device=buf.device)
    pred_sel = torch.stack(preds, dim=1)[rows, best.long()]
    return _forward(buf, pred_sel)


def build_final_pass_fns(layer_num_params: tuple, n: int,
                         bits_per_sample: int, strict=None):
    """Stages of the -a N final refit pass (see block comment above).

    Returns (to_f64, searches, forwards): `to_f64` maps int32 signals [B, n]
    to the oracle's scaled f64; `searches[li]`/`forwards[li]` are the
    per-layer stages. Raises ValueError on unsupported shapes like
    `build_fit_fn`. `strict` as in `build_fit_fn`.
    """
    return _build_final_pass_fns(tuple(layer_num_params), n,
                                 bits_per_sample, _resolve_strict(strict))


@functools.lru_cache(maxsize=16)
def _build_final_pass_fns(layer_num_params: tuple, n: int,
                          bits_per_sample: int, strict: bool):
    if not supported(layer_num_params, n):
        raise ValueError(f"unsupported shape for device-exact fit: "
                         f"{layer_num_params} n={n}")
    scale = 2.0 ** (-(bits_per_sample - 1))

    def to_f64(s: torch.Tensor) -> torch.Tensor:
        return s.to(_F64) * scale

    searches = tuple(
        functools.partial(_search_impl, P=P, n=n, strict=strict)
        for P in layer_num_params)
    forwards = tuple(
        functools.partial(_forward_impl, P=P, n=n, strict=strict)
        for P in layer_num_params)
    return to_f64, searches, forwards


# ---------------------------------------------------------------------------
# host (numpy) helpers: arena replay and the -a N guard sensors
# ---------------------------------------------------------------------------


def final_level_layout(P: int, n: int):
    """(offset, npu) per level into the concatenated final-pass parcor
    columns emitted by `_search_impl`."""
    offs = []
    off = 0
    for u in _valid_levels(P, n):
        npu = P // u
        offs.append((off, npu))
        off += npu
    return offs


def fold_final_pass(parcor_coef: np.ndarray, final_layers: Sequence[dict],
                    layer_num_params: Sequence[int], n: int) -> None:
    """Replay the -a N final pass's parcor arena writes for ONE channel row:
    per layer, each level's search deposit in order, then the chosen level's
    refit re-deposit (the AF iterations themselves never write parcor —
    lpc.c:578-661 only rewrites lpc_coef). `final_layers[li]` is a dict with
    1-D "parcor" (concatenated level columns), "zc" [n_levels] and scalar
    "best"."""
    for li, P in enumerate(layer_num_params):
        offs = final_level_layout(P, n)
        fl = final_layers[li]
        parc = np.asarray(fl["parcor"])
        zc = np.asarray(fl["zc"])

        def deposit(lvl: int) -> None:
            off, npu = offs[lvl]
            parcor_coef[:npu] = parc[off : off + npu]
            if bool(zc[lvl]):
                parcor_coef[npu] = 0.0

        for lvl in range(len(offs)):
            deposit(lvl)
        deposit(int(fl["best"]))


def quantize_margins_np(coefs: np.ndarray, nbits: int):
    """Host (numpy) twin of `_quantize_layer_plain`'s guard sensors, for the -a N
    path where quantization runs host-side (exact/lpc.py
    quantize_coefficients). `coefs`: [P] final f64 params of one layer row.
    Returns (round_margin, scale_margin) floats with the same semantics as
    the device margins."""
    P = coefs.shape[0]
    max_abs = 0.0
    for v in coefs.tolist():
        av = abs(v)
        if max_abs < av:
            max_abs = av
    lowthr = math.pow(2.0, -(nbits - 1))
    lm = abs(max_abs - lowthr) / lowthr
    if max_abs <= lowthr:
        return float("inf"), lm
    _, ndigit = math.frexp(max_abs)
    fm = min(max_abs - math.pow(2.0, ndigit - 1),
             math.pow(2.0, ndigit) - max_abs) / max_abs
    scale_margin = min(fm, lm)
    scale = math.pow(2.0, (nbits - 1) - ndigit)
    qmax = 1 << (nbits - 1)
    qerror = 0.0
    round_margin = float("inf")
    for ordi in range(P - 1, -1, -1):
        qerror += float(coefs[ordi]) * scale
        y = qerror + 0.5 if qerror >= 0.0 else -qerror + 0.5
        round_margin = min(round_margin, abs(y - round(y)))
        qtmp = int(math.floor(y)) if qerror >= 0.0 else -int(math.floor(y))
        if qtmp >= qmax:
            qtmp = qmax - 1
        elif qtmp < -qmax:
            qtmp = -qmax
        qerror -= qtmp
    return round_margin, scale_margin


def arena_layout(layer_num_params: Sequence[int], ridge_terms: Sequence[float],
                 n: int):
    """Column layout of the flattened arena arrays, in the same
    (term, layer, level) order `build_fit_fn` emits: returns
    (entries, n_layers) with entries[(ti, li, lvl)] = (parcor_off, npu_w,
    zc_col)."""
    return _arena_layout(tuple(layer_num_params), tuple(ridge_terms), n)


@functools.lru_cache(maxsize=64)
def _arena_layout(layer_num_params: tuple, ridge_terms: tuple, n: int):
    entries = {}
    off = 0
    zc = 0
    for ti in range(len(ridge_terms)):
        for li, P in enumerate(layer_num_params):
            for lvl, u in enumerate(_valid_levels(P, n)):
                npu = P // u
                entries[(ti, li, lvl)] = (off, npu, zc)
                off += npu
                zc += 1
    return entries, len(layer_num_params)


def fold_parcor_state(parcor_coef: np.ndarray, out: dict, num_channels: int,
                      layer_num_params: Sequence[int],
                      ridge_terms: Sequence[float], n: int,
                      include_final: bool = True) -> None:
    """Replay the fit's parcor_coef arena writes into the host array, in the
    reference's order: per channel, every sweep pass (each ridge term), then
    the final refit pass with the winning term (linne_network.c:605-630).

    Within one pass: per layer, each level deposits its last unit's parcor
    into [0:npu] (plus [npu] = 0 on the zero-signal early-out,
    lpc.c:268-275), then the refit at the chosen level re-deposits that
    level's write. `parcor_coef` is mutated in place. Channel ch reads row
    ch of the arena arrays.

    With AF iterations = 0 the final refit recomputes exactly the winning
    sweep pass, so its replay reuses that pass's data; with -a N the caller
    passes include_final=False and replays the final pass's own deposits via
    `fold_final_pass`.
    """
    entries, L = arena_layout(layer_num_params, ridge_terms, n)
    ap = np.asarray(out["arena_parcor"])
    az = np.asarray(out["arena_zc"])
    ab = np.asarray(out["arena_best"])
    best_term = np.asarray(out["best_term"])
    n_levels = [len(_valid_levels(P, n)) for P in layer_num_params]

    # Only the arena's FINAL state is observable (the next block-type
    # estimate is the sole consumer, lpc.c:846-848), so walk the deposit
    # sequence BACKWARD and fill each index once: a deposit writes the
    # prefix [0:npu] then (on the zero-signal case) the single cell
    # [npu] = 0, so processing in reverse with a covered-prefix watermark
    # and a set of later point writes reproduces the same final array.
    for ch in range(num_channels):
        seq = []  # deposits in execution order
        terms = list(range(len(ridge_terms)))
        if include_final:
            terms.append(int(best_term[ch]))
        for ti in terms:
            for li in range(L):
                for lvl in range(n_levels[li]):
                    seq.append(entries[(ti, li, lvl)])
                seq.append(entries[(ti, li, int(ab[ch, ti * L + li]))])
        covered = 0
        pts: set = set()
        for off, npu_w, zc in reversed(seq):
            if bool(az[ch, zc]) and npu_w >= covered and npu_w not in pts:
                parcor_coef[npu_w] = 0.0
                pts.add(npu_w)
            if npu_w > covered:
                parcor_coef[covered:npu_w] = ap[ch, off + covered : off + npu_w]
                for i in pts:
                    if covered <= i < npu_w:
                        parcor_coef[i] = 0.0
                covered = npu_w
