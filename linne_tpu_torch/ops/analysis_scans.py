"""The serial loops of the batched encode, its layer fits' windowed
autocorrelation and residual pass, and the byte-exact fit's quantizer, as
CUDA kernels.

The JAX package runs three recursions of its default encode as
`lax.scan` loops inside jitted stages (linne_tpu/ops/analysis.py
`levinson_durbin`, `quantize_coefficients`; linne_tpu/ops/intops.py
`_predict_dense`), each layer's Welch-windowed autocorrelation and the
residual pass of its unit-count sweep as XLA ops (linne_tpu/ops/analysis.py
`fit_unit_lpc` and `autocorrelation`: every candidate split's windowing
and lags; `fit_layer`: every candidate split's residual, its loss and the
first-minimum pick), and the byte-exact fit's quantizer as a loop over the
taps (linne_tpu/ops/exact_device.py `_quantize_layer`). Eager torch would
dispatch a dozen ops for every step of each; here each is one launch of a
hand-written kernel (csrc/analysis_scans.cu). The plain torch versions
stay in ops/analysis.py (`_levinson_durbin_plain`,
`_quantize_coefficients_plain`, `_quantize_layers_plain`,
`_unit_autocorrelations_plain`, `_unit_residual_select_plain`), ops/intops.py
(`_predict_dense_plain`) and ops/exact_device.py (`_quantize_layer_plain`,
`_quantize_layers_plain`), whose public functions send a CPU tensor to the
plain version and a CUDA tensor here. There is no fallback from one to the
other.

The wrappers take the flat [rows, ...] layout on a CUDA device
(contiguous, except where a wrapper says which strides it takes), and
raise ValueError on anything else (the device is checked last). They
launch on the tensor's own device and its current stream.
`KERNEL_LAUNCHES[name]` counts each kernel's launches: the quantizer's
two variants count apart, the batched encoder's as
"quantize_coefficients" (`quantize_layers`, and `quantize_coefficients`
for one layer), the byte-exact fit's as "quantize_layer"
(`quantize_layers_exact`).

The quantizer and the predict cascade are bit-equal to their plain
versions, and so are the residual pass's residuals to the loop route's
(ops/analysis.py `_unit_forward_loop`); its loss sums the same terms in
another order. The autocorrelation's windowed samples are the plain
version's bits and its lags sum them in another order. The recursion takes each step's numerator in Schur form (the
forward and backward correlations updated elementwise, no sum), so it
agrees with its plain version to rounding, deterministically and wherever
a row sits in the batch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _kernels

# the batched encoder's kernels, then the byte-exact fit's quantizer
KERNELS = ("levinson_durbin", "quantize_coefficients", "predict_dense",
           "unit_residual_select", "lpc_autocorr", "quantize_layer")

# Launches of each kernel since import (or since a caller reset them);
# incremented only where the kernel is launched.
KERNEL_LAUNCHES = dict.fromkeys(KERNELS, 0)

# The format's largest layer order: the recursion, the quantizer and the
# predict cascade take orders 1..128.
KERNEL_MAX_ORDER = 128

# The layers one quantizer launch takes (the format's presets have 2-3).
QUANTIZE_MAX_LAYERS = 4

# The candidate splits one residual pass or autocorrelation launch takes:
# unit counts 1, 2, ..., 128.
UNIT_MAX_CANDIDATES = 8

# The lags one autocorrelation launch forms a unit: lags 0..128.
AUTOCORR_MAX_LAGS = KERNEL_MAX_ORDER + 1

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    "levinson_durbin": [_P, _P, _P, _L, _I, _P],
    "quantize_layers": [_I, _P, _P, _P, _P, _P, _L, _P, _L, _L, _P, _P, _L,
                        _I, _I, _P],
    "predict_dense": [_P, _P, _P, _P, _P, _L, _I, _I, _L, _P],
    "unit_residual_select": [_P, _L, _L, _P, _P, _I, _I, _I, _L, _P, _P, _P,
                             _P, _P],
    "lpc_autocorr": [_P, _L, _L, _I, _P, _P, _P, _I, _P, _P],
    "ddiv_probe": [ctypes.c_double, _I, _P, _P, _P],
}
_fns: dict = {}


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_kernels.load("analysis_scans"), f"linne_{name}")
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(dtype: torch.dtype, **tensors) -> None:
    device = None
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name} must be a torch.Tensor")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        device = device or t.device
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_device(device: torch.device) -> None:
    """Last of a wrapper's checks, so that the others can be tested on a
    machine without a card."""
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}: the kernels run on "
                         "CUDA tensors only")


def _check_order(order: int) -> None:
    if not 1 <= order <= KERNEL_MAX_ORDER:
        raise ValueError(f"order {order} outside the kernels' 1.."
                         f"{KERNEL_MAX_ORDER}")


def _launch(name: str, device: torch.device, *args,
            entry: str | None = None) -> None:
    """Launch kernel `name` through the C entry `entry` (default: the
    same name) and count it."""
    fn = _fn(entry or name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES[name] += 1


def levinson_durbin(ac: torch.Tensor, order: int, with_parcor: bool = False):
    """ac [rows, order + 1] float64 (ridge applied) -> lpc [rows, order],
    and parcor [rows, order] if with_parcor: the batched recursion of
    ops/analysis.py:_levinson_durbin_plain."""
    _check(torch.float64, ac=ac)
    _check_order(order)
    if ac.dim() != 2 or ac.shape[1] != order + 1:
        raise ValueError(f"ac must be [rows, {order + 1}], got "
                         f"{tuple(ac.shape)}")
    _check_device(ac.device)
    rows = ac.shape[0]
    lpc = torch.empty((rows, order), dtype=ac.dtype, device=ac.device)
    parcor = torch.empty_like(lpc) if with_parcor else None
    if rows:
        _launch("levinson_durbin", ac.device, ac.data_ptr(), lpc.data_ptr(),
                parcor.data_ptr() if with_parcor else None, rows, order)
    return (lpc, parcor) if with_parcor else lpc


def _check_nbits(nbits: int) -> None:
    if not 1 <= nbits <= 31:
        raise ValueError(f"nbits {nbits} outside 1..31")


def _check_layers(count: int) -> None:
    if not 1 <= count <= QUANTIZE_MAX_LAYERS:
        raise ValueError(f"{count} layers: a quantizer launch takes 1.."
                         f"{QUANTIZE_MAX_LAYERS}")


def _quantize_launch(name, device, layers, rows, nbits, int_coef, rshift,
                     rs_strides, margins=(None, None)) -> None:
    """One launch of the quantizer over `layers`, (source, row stride,
    order, output column) each."""
    count = len(layers)
    srcs = (ctypes.c_void_p * count)(*(src for src, _, _, _ in layers))
    strides = (ctypes.c_int64 * count)(*(st for _, st, _, _ in layers))
    orders = (ctypes.c_int * count)(*(o for _, _, o, _ in layers))
    cols = (ctypes.c_int * count)(*(c for _, _, _, c in layers))
    round_margin, scale_margin = margins
    _launch(name, device, count, srcs, strides, orders, cols,
            int_coef.data_ptr(), int_coef.stride(0), rshift.data_ptr(),
            *rs_strides,
            round_margin.data_ptr() if round_margin is not None else None,
            scale_margin.data_ptr() if scale_margin is not None else None,
            rows, nbits, int(round_margin is not None),
            entry="quantize_layers")


def quantize_layers(coefs, nbits: int = 8):
    """coefs: 1..4 layers [rows, order_l] float64 (the same rows; each
    row's taps contiguous, rows at any stride) -> (int_coef [rows, sum of
    orders], rshift [layers, rows]) int32: the error-feedback quantizer of
    ops/analysis.py:_quantize_coefficients_plain on every layer, in one
    launch, bit for bit. int_coef holds the layers side by side in the
    given order."""
    coefs = list(coefs)
    _check_layers(len(coefs))
    _check_nbits(nbits)
    for li, c in enumerate(coefs):
        if not isinstance(c, torch.Tensor):
            raise ValueError(f"layer {li} must be a torch.Tensor")
        if c.dtype != torch.float64:
            raise ValueError(f"layer {li} must be torch.float64, got "
                             f"{c.dtype}")
        if c.dim() != 2:
            raise ValueError(f"layer {li} must be [rows, order], got "
                             f"{tuple(c.shape)}")
        _check_order(c.shape[1])
        if c.device != coefs[0].device:
            raise ValueError(f"layer {li} is on {c.device}, expected "
                             f"{coefs[0].device}")
        if c.shape[0] != coefs[0].shape[0]:
            raise ValueError(f"row counts differ: layer {li} has "
                             f"{c.shape[0]}, layer 0 {coefs[0].shape[0]}")
        if c.stride(1) != 1 and c.shape[1] > 1:
            raise ValueError(f"layer {li}: a row's taps must be contiguous")
    device = coefs[0].device
    _check_device(device)
    rows = coefs[0].shape[0]
    total = sum(c.shape[1] for c in coefs)
    int_coef = torch.empty((rows, total), dtype=torch.int32, device=device)
    rshift = torch.empty((len(coefs), rows), dtype=torch.int32,
                         device=device)
    if rows:
        layers, col = [], 0
        for c in coefs:
            layers.append((c.data_ptr(), c.stride(0), c.shape[1], col))
            col += c.shape[1]
        _quantize_launch("quantize_coefficients", device, layers, rows,
                         nbits, int_coef, rshift, (rows, 1))
    return int_coef, rshift


def quantize_coefficients(coefs: torch.Tensor, nbits: int = 8):
    """coefs [rows, order] float64 -> (int_coef [rows, order], rshift
    [rows]) int32: quantize_layers for one layer."""
    _check(torch.float64, coefs=coefs)
    if coefs.dim() != 2:
        raise ValueError(f"coefs must be [rows, order], got "
                         f"{tuple(coefs.shape)}")
    int_coef, rshift = quantize_layers([coefs], nbits)
    return int_coef, rshift[0]


def quantize_layers_exact(params: torch.Tensor, orders, nbits: int):
    """params [rows, width] float64 (each row's taps contiguous, rows at any
    stride; the byte-exact fit's arena), whose first sum(orders) columns
    hold 1..4 layers side by side -> (int_coef [rows, sum of orders] int32,
    rshift [rows, layers] int32, round_margin [rows] float64, scale_margin
    [rows] float64): ops/exact_device.py:_quantize_layers_plain, the
    byte-exact fit's quantizer with the guard's margins folded over the
    layers, in one launch, bit for bit."""
    orders = [int(o) for o in orders]
    _check_layers(len(orders))
    for o in orders:
        _check_order(o)
    _check_nbits(nbits)
    if not isinstance(params, torch.Tensor):
        raise ValueError("params must be a torch.Tensor")
    if params.dtype != torch.float64:
        raise ValueError(f"params must be torch.float64, got {params.dtype}")
    if params.dim() != 2 or params.shape[1] < sum(orders):
        raise ValueError(f"params must be [rows, >= {sum(orders)}], got "
                         f"{tuple(params.shape)}")
    if params.stride(1) != 1 and params.shape[1] > 1:
        raise ValueError("params: a row's taps must be contiguous")
    _check_device(params.device)
    rows = params.shape[0]
    dev = params.device
    int_coef = torch.empty((rows, sum(orders)), dtype=torch.int32,
                           device=dev)
    rshift = torch.empty((rows, len(orders)), dtype=torch.int32, device=dev)
    margins = torch.empty((2, rows), dtype=torch.float64, device=dev)
    if rows:
        layers, col = [], 0
        for o in orders:
            layers.append((params.data_ptr() + 8 * col, params.stride(0), o,
                           col))
            col += o
        _quantize_launch("quantize_layer", dev, layers, rows, nbits,
                         int_coef, rshift, (1, len(orders)),
                         (margins[0], margins[1]))
    return int_coef, rshift, margins[0], margins[1]


def predict_dense(x: torch.Tensor, coefs: torch.Tensor, log2u: torch.Tensor,
                  rshift: torch.Tensor, u_max: int) -> torch.Tensor:
    """x [rows, n], coefs [rows, order], log2u [rows], rshift [rows] int32
    -> [rows, n] int32: the masked full-order FIR with per-unit passthrough
    of ops/intops.py:_predict_dense_plain, bit for bit. u_max (a power of
    two) must divide n, and every log2u be at most log2(u_max). coefs'
    rows may lie at any stride (a layer's columns of the quantizer's
    grouped output); each row's taps are contiguous."""
    _check(torch.int32, x=x, log2u=log2u, rshift=rshift)
    if not isinstance(coefs, torch.Tensor) or coefs.dtype != torch.int32:
        raise ValueError("coefs must be a torch.int32 tensor")
    if coefs.device != x.device:
        raise ValueError(f"coefs is on {coefs.device}, expected {x.device}")
    if x.dim() != 2 or coefs.dim() != 2 or log2u.dim() != 1 \
            or rshift.dim() != 1:
        raise ValueError("expected x [rows, n], coefs [rows, order], log2u "
                         "[rows], rshift [rows]")
    rows, n = x.shape
    order = coefs.shape[1]
    _check_order(order)
    if coefs.stride(-1) != 1 and order > 1:
        raise ValueError("coefs: a row's taps must be contiguous")
    if coefs.shape[0] != rows or log2u.shape[0] != rows \
            or rshift.shape[0] != rows:
        raise ValueError(f"row counts differ: x {tuple(x.shape)}, coefs "
                         f"{tuple(coefs.shape)}, log2u {tuple(log2u.shape)}, "
                         f"rshift {tuple(rshift.shape)}")
    if u_max < 1 or u_max & (u_max - 1) or n % u_max:
        raise ValueError(f"u_max {u_max} must be a power of two dividing "
                         f"n = {n}")
    _check_device(x.device)
    out = torch.empty_like(x)
    if out.numel():
        _launch("predict_dense", x.device, x.data_ptr(), coefs.data_ptr(),
                log2u.data_ptr(), rshift.data_ptr(), out.data_ptr(), rows, n,
                order, coefs.stride(0))
    return out


def unit_residual_select(x: torch.Tensor, params, log2u):
    """x [ridges, rows, n] float64 (each row's samples contiguous, the rows
    of a ridge at stride n, the ridges at any stride: 0 for an expanded
    input, which is read and not copied); params: 1..8 candidates [ridges
    * rows, order] float64 contiguous (u = 2^log2u[i] units of order / u
    taps, ops/analysis.py:fit_unit_lpc's layout) -> (log2u [ridges * rows]
    int32, flat [ridges * rows, order], residual [ridges * rows, n], loss
    [ridges * rows] float64) of each row's first-minimum candidate: the
    residual pass of ops/analysis.py:_unit_residual_select_plain in one
    launch, its residuals `_unit_forward_loop`'s bits, its loss within
    rounding."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float64:
        raise ValueError("x must be a torch.float64 tensor")
    if x.dim() != 3:
        raise ValueError(f"x must be [ridges, rows, n], got {tuple(x.shape)}")
    ridges, per_ridge, n = x.shape
    if (n > 1 and x.stride(2) != 1) or (per_ridge > 1 and x.stride(1) != n) \
            or x.stride(0) < 0:
        raise ValueError("x: a ridge's rows must be contiguous")
    if not 1 <= n <= 1 << 30:
        raise ValueError(f"n = {n} outside 1..2^30")
    params, log2u = list(params), [int(v) for v in log2u]
    if not 1 <= len(params) <= UNIT_MAX_CANDIDATES \
            or len(log2u) != len(params):
        raise ValueError(f"{len(params)} candidates with {len(log2u)} unit "
                         f"counts: a launch takes 1..{UNIT_MAX_CANDIDATES}")
    rows = ridges * per_ridge
    order = None
    for i, p in enumerate(params):
        if not isinstance(p, torch.Tensor) or p.dtype != torch.float64:
            raise ValueError(f"candidate {i} must be a torch.float64 tensor")
        if p.dim() != 2 or p.shape[0] != rows:
            raise ValueError(f"candidate {i} must be [{rows}, order], got "
                             f"{tuple(p.shape)}")
        if p.device != x.device:
            raise ValueError(f"candidate {i} is on {p.device}, expected "
                             f"{x.device}")
        if not p.is_contiguous():
            raise ValueError(f"candidate {i} must be contiguous")
        order = p.shape[1] if order is None else order
        if p.shape[1] != order:
            raise ValueError(f"candidate {i} has {p.shape[1]} taps, "
                             f"candidate 0 {order}")
    _check_order(order)
    for v in log2u:
        if not 0 <= v <= 7 or order % (1 << v) or n % (1 << v):
            raise ValueError(f"log2u {v}: 2^{v} units must divide order "
                             f"{order} and n = {n}")
    _check_device(x.device)
    dev = x.device
    res = torch.empty((rows, n), dtype=x.dtype, device=dev)
    flat = torch.empty((rows, order), dtype=x.dtype, device=dev)
    loss = torch.empty(rows, dtype=x.dtype, device=dev)
    best = torch.empty(rows, dtype=torch.int32, device=dev)
    if rows:
        count = len(params)
        ptrs = (ctypes.c_void_p * count)(*(p.data_ptr() for p in params))
        l2 = (ctypes.c_int * count)(*log2u)
        _launch("unit_residual_select", dev, x.data_ptr(), x.stride(0),
                per_ridge, ptrs, l2, count, order, n, rows, res.data_ptr(),
                flat.data_ptr(), loss.data_ptr(), best.data_ptr())
    return best, flat, res, loss


def lpc_autocorr(x: torch.Tensor, splits):
    """x [rows, n] float64 (each row's samples contiguous, the rows at any
    stride); splits: 1..8 candidates (log2u, lags, window), 2^log2u units
    (log2u 0..7, dividing n) of n >> log2u samples, each multiplied by
    `window` (float64 [n >> log2u] contiguous on x's device, or None: no
    window), and lags 1..129 -> one [rows, 2^log2u, lags] float64 tensor a
    candidate (views of one output): every unit's ac[l] = sum_t xw[t] *
    xw[t + l], all candidates in one launch. The windowed samples are the
    bits of `seg * window`; the sums are within rounding of
    ops/analysis.py:_unit_autocorrelations_plain, the same bits run to run
    and wherever a row sits."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float64:
        raise ValueError("x must be a torch.float64 tensor")
    if x.dim() != 2:
        raise ValueError(f"x must be [rows, n], got {tuple(x.shape)}")
    rows, n = x.shape
    if (n > 1 and x.stride(1) != 1) or x.stride(0) < 0:
        raise ValueError("x: a row's samples must be contiguous")
    if not 1 <= n <= 1 << 30:
        raise ValueError(f"n = {n} outside 1..2^30")
    splits = [(int(l2), int(lags), w) for l2, lags, w in splits]
    if not 1 <= len(splits) <= UNIT_MAX_CANDIDATES:
        raise ValueError(f"{len(splits)} candidates: a launch takes "
                         f"1..{UNIT_MAX_CANDIDATES}")
    for i, (l2, lags, w) in enumerate(splits):
        if not 0 <= l2 <= 7 or n % (1 << l2):
            raise ValueError(f"candidate {i}: 2^{l2} units must divide n = "
                             f"{n}")
        if not 1 <= lags <= AUTOCORR_MAX_LAGS:
            raise ValueError(f"candidate {i}: {lags} lags outside 1.."
                             f"{AUTOCORR_MAX_LAGS}")
        if w is None:
            continue
        if not isinstance(w, torch.Tensor) or w.dtype != torch.float64:
            raise ValueError(f"window {i} must be a torch.float64 tensor")
        if w.shape != (n >> l2,) or not w.is_contiguous():
            raise ValueError(f"window {i} must be [{n >> l2}] contiguous, "
                             f"got {tuple(w.shape)}")
        if w.device != x.device:
            raise ValueError(f"window {i} is on {w.device}, expected "
                             f"{x.device}")
    _check_device(x.device)
    widths = [(1 << l2) * lags for l2, lags, _ in splits]
    out = torch.empty((rows, sum(widths)), dtype=x.dtype, device=x.device)
    if rows:
        count = len(splits)
        wins = (ctypes.c_void_p * count)(
            *(None if w is None else w.data_ptr() for _, _, w in splits))
        l2s = (ctypes.c_int * count)(*(l2 for l2, _, _ in splits))
        lag_counts = (ctypes.c_int * count)(*(lg for _, lg, _ in splits))
        _launch("lpc_autocorr", x.device, x.data_ptr(), x.stride(0), rows,
                n, wins, l2s, lag_counts, count, out.data_ptr())
    views, col = [], 0
    for (l2, lags, _), width in zip(splits, widths):
        views.append(out[:, col:col + width].unflatten(1, (1 << l2, lags)))
        col += width
    return views


def levinson_lanes(order: int) -> int:
    """The lanes a row of the recursion's kernel: the least power of two G
    with 5 G >= order + 1 (a lane holds five coefficients); a CTA runs
    128 / G rows."""
    _check_order(order)
    lanes = 1
    while 5 * lanes < order + 1:
        lanes *= 2
    return lanes


def ddiv_cycles(device="cuda") -> float:
    """The card's dependent float64 divide latency in SM cycles: one warp
    runs chains of 2^10 and 2^14 dependent __ddiv_rn, each timed with
    clock64; the slope between the two."""
    device = torch.device(device)
    _check_device(device)
    cycles = torch.zeros(1, dtype=torch.int64, device=device)
    out = torch.empty(32, dtype=torch.float64, device=device)
    counts = []
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for n in (1 << 10, 1 << 14):
            err = _fn("ddiv_probe")(2.0, n, cycles.data_ptr(),
                                    out.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"ddiv_probe failed: CUDA error {err}")
            counts.append((n, int(cycles.item())))
    (n1, c1), (n2, c2) = counts
    return (c2 - c1) / (n2 - n1)
