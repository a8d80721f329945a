"""The strict float64 serial chains of the byte-exact device encoder.

The JAX package ran these sums as `lax.scan` loops
(linne_tpu/ops/exact_device.py `_autocorr_serial`, `_levinson_serial`,
`_serial_abs_mean`, `_chain_predict`). Here each is a hand-written CUDA
kernel (csrc/exact_serial.cu: the reference's loop in the reference's
order, every operation rounded on its own) with a plain torch version
beside it that takes the same operations one tensor op at a time. The
autocorrelation kernel stages its segments through shared-memory tiles
with TMA bulk copies and runs 1, 2 or 4 lags a thread, each lag's sum one
serial chain of adds in a register; the abs-mean kernel stages up to 32
rows a warp the same way, one row a lane; the recursion runs one thread a
segment up to order 32 and one warp a segment above; the tap chains run
one thread per output sample.

Each wrapper launches its kernel on CUDA tensors and runs its plain
version on CPU tensors. There is no fallback from one to the other.
`KERNEL_LAUNCHES[name]` counts the kernel's launches.

Where the JAX graph shields a product from FMA contraction (`_mulsh`), the
plain versions keep its `where(p == p, p, 0)`: eager torch rounds every op
on its own and needs no shield, but a NaN product still becomes 0 there,
so the NaN lanes match. No plain version uses a fused op.
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import FLT_EPSILON
from . import _kernels

KERNELS = ("autocorr_serial", "levinson_serial", "serial_abs_mean",
           "chain_predict")

# Launches of each kernel since import (or since a caller reset them);
# incremented only where the kernel is launched.
KERNEL_LAUNCHES = dict.fromkeys(KERNELS, 0)

# Launches of each kernel by shape since import (or since a caller reset
# them): {shape: count}, a shape being (segments, samples, lags) for
# autocorr_serial, (segments, order) for levinson_serial, (rows, row
# length, start, n) for serial_abs_mean and (rows, samples, units, taps)
# for chain_predict.
LAUNCH_SHAPES = {name: {} for name in KERNELS}

# The recursion kernels hold the format's largest layer order.
KERNEL_MAX_ORDER = 128

# Chains a thread of the autocorrelation kernel runs (1, 2 or 4); None
# lets the kernel choose by call shape. Set only to compare
# the choices: every choice gives the same bits.
_AUTOCORR_K_OVERRIDE = None
AUTOCORR_K_CHOICES = (1, 2, 4)

_F64 = torch.float64
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    "autocorr_serial": [_P, _P, _L, _I, _I, _P],
    "autocorr_serial_k": [_P, _P, _L, _I, _I, _I, _P],
    "autocorr_plan": [_L, _I, _I, _I, _P],
    "dadd_probe": [ctypes.c_double, _I, _P, _P, _P],
    "levinson_serial": [_P, _P, _P, _P, _L, _I, _P],
    "levinson_plan": [_L, _I, _P],
    "serial_abs_mean": [_P, _P, _L, _I, _I, _I, _P],
    "abs_mean_plan": [_L, _I, _I, _P],
    "chain_predict": [_P, _P, _P, _P, _L, _I, _I, _I, _P],
}
_fns: dict = {}


def _mulsh(x, y):
    """x * y with a NaN product replaced by 0 (the JAX graph's FMA
    shield, linne_tpu/ops/exact_device.py:_mulsh)."""
    p = x * y
    return torch.where(p == p, p, 0.0)


# ---------------------------------------------------------------------------
# plain torch versions
# ---------------------------------------------------------------------------


def autocorr_serial_ref(seg: torch.Tensor, nlags: int) -> torch.Tensor:
    """ac[..., lag] = sum_i seg[..., i] * seg[..., i + lag], serial in i
    from +0.0 (reference: lpc.c:215-249), over a zero-padded window as the
    JAX scan takes it. seg [..., ns] -> [..., nlags]."""
    ns = seg.shape[-1]
    lead = seg.shape[:-1]
    segp = torch.cat([seg, seg.new_zeros(lead + (nlags - 1,))], dim=-1)
    acc = seg.new_zeros(lead + (nlags,))
    for i in range(ns):
        acc = acc + _mulsh(seg[..., i : i + 1], segp[..., i : i + nlags])
    return acc


def levinson_serial_ref(ac: torch.Tensor, order: int):
    """Levinson-Durbin with the reference's op order (lpc.c:252-324), the
    unrolled form of linne_tpu/ops/exact_device.py:_levinson_serial at
    every order. ac [..., order + 1], post-ridge. Returns (lpc_coef
    [..., order], parcor [..., order], zerocase [...] bool); zero-signal
    segments (|r0| < FLT_EPSILON) give zeros."""
    zerocase = torch.abs(ac[..., 0]) < FLT_EPSILON
    zero = ac.new_zeros(ac.shape[:-1])
    one = torch.ones_like(zero)
    a = [zero] * (order + 2)
    parcor = [zero] * order
    a[0] = one
    ek = ac[..., 0]
    a[1] = -ac[..., 1] / ac[..., 0]
    parcor[0] = ac[..., 1] / ek
    ek = ek + _mulsh(ac[..., 1], a[1])
    for k in range(1, order):
        g = zero
        for i in range(k + 1):
            g = g + _mulsh(a[i], ac[..., k + 1 - i])
        gamma = g / (-ek)
        ek = ek * (1.0 - _mulsh(gamma, gamma))
        u = [one] + a[1 : k + 1] + [zero]
        v = [zero] + a[k:0:-1] + [one]
        a = [u[i] + _mulsh(gamma, v[i]) for i in range(k + 2)] + a[k + 2 :]
        parcor[k] = -gamma
    nz = (~zerocase)[..., None]
    coefs = torch.where(nz, torch.stack(a[1 : order + 1], dim=-1), 0.0)
    parc = torch.where(nz, torch.stack(parcor, dim=-1), 0.0)
    return coefs, parc, zerocase


def serial_abs_mean_ref(rows: torch.Tensor, start: int, n: int
                        ) -> torch.Tensor:
    """sum(|rows[..., start:n]|) / n, serial in t from +0.0
    (linne_network.c:50-63). rows [..., len] -> [...]."""
    x = torch.abs(rows[..., start:n])
    acc = rows.new_zeros(rows.shape[:-1])
    for t in range(n - start):
        acc = acc + x[..., t]
    return _div(acc, n)


def _div(x: torch.Tensor, n: int) -> torch.Tensor:
    """x / n with IEEE division on every device: on CUDA, torch divides
    by a Python scalar as a multiply by its rounded reciprocal."""
    return x / torch.full_like(x, n)


def chain_predict_ref(x: torch.Tensor, params: torch.Tensor):
    """Per-sample serial tap chains, vectorised over time
    (linne_network.c:165-210,319-335). x [B, n]; params [B, units, npu],
    taps time-reversed per unit like layer.params. Returns (with_base,
    no_base), each [B, n]: with_base[t] = ((x[t] + p0*w0) + p1*w1)...,
    no_base the same chain from 0.0."""
    B, n = x.shape
    units, npu = params.shape[1], params.shape[2]
    ns = n // units
    xp = torch.cat([x.new_zeros((B, npu)), x], dim=1)
    base = x.reshape(B, units, ns)
    nobase = x.new_zeros((B, units, ns))
    for j in range(npu):
        w = xp[:, j : j + n].reshape(B, units, ns)
        term = _mulsh(params[:, :, j : j + 1], w)
        base = base + term
        nobase = nobase + term
    return base.reshape(B, n), nobase.reshape(B, n)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_kernels.load("exact_serial"), f"linne_{name}")
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(device: torch.device, **tensors) -> None:
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != _F64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(name: str, device: torch.device, shape: tuple, *args,
            entry=None) -> None:
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    fn = _fn(entry or name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES[name] += 1
    shapes = LAUNCH_SHAPES[name]
    shapes[shape] = shapes.get(shape, 0) + 1


def autocorr_serial(seg: torch.Tensor, nlags: int) -> torch.Tensor:
    """seg [..., ns] float64 -> ac [..., nlags] (see autocorr_serial_ref),
    1 <= nlags <= ns."""
    _check(seg.device, seg=seg)
    ns = seg.shape[-1]
    if not 1 <= nlags <= ns:
        raise ValueError(f"nlags {nlags} out of [1, {ns}]")
    if seg.device.type == "cpu":
        return autocorr_serial_ref(seg, nlags)
    out = seg.new_empty(seg.shape[:-1] + (nlags,))
    if out.numel():
        k = _AUTOCORR_K_OVERRIDE
        nseg = out.numel() // nlags
        shape = (nseg, ns, nlags)
        if k is None:
            _launch("autocorr_serial", seg.device, shape, seg.data_ptr(),
                    out.data_ptr(), nseg, ns, nlags)
        else:
            _launch("autocorr_serial", seg.device, shape, seg.data_ptr(),
                    out.data_ptr(), nseg, ns, nlags, k,
                    entry="autocorr_serial_k")
    return out


_PLAN_KEYS = ("k", "threads", "groups", "tile", "stages", "segs_per_cta",
              "ctas", "smem_bytes", "ctas_per_sm", "sms")


def autocorr_plan(nseg: int, ns: int, nlags: int, k: int | None = None,
                  device="cuda") -> dict:
    """How the autocorrelation kernel runs a call shape on the card: chains
    a thread, threads a CTA, lag groups a segment, tile, ring stages,
    segments a CTA, CTAs, shared bytes a CTA, CTAs an SM holds at once, and
    the card's SMs."""
    return _plan("autocorr_plan", _PLAN_KEYS, device, nseg, ns, nlags, k or 0)


_LEVINSON_PLAN_KEYS = ("warp", "max_order", "threads", "segs_per_cta",
                       "ctas", "smem_bytes", "ctas_per_sm", "sms")
_ABS_MEAN_PLAN_KEYS = ("rows_per_cta", "tile", "stages", "tiles", "ctas",
                       "smem_bytes", "ctas_per_sm", "sms")


def _plan(entry: str, keys: tuple, device, *args) -> dict:
    out = torch.zeros(len(keys), dtype=torch.int64)
    with torch.cuda.device(torch.device(device)):
        err = _fn(entry)(*args, out.data_ptr())
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")
    return dict(zip(keys, out.tolist()))


def levinson_plan(nseg: int, order: int, device="cuda") -> dict:
    """How the recursion kernel runs a call shape on the card: one warp a
    segment (warp 1) or one thread (warp 0, with the template's largest
    order), threads and segments a CTA, CTAs, shared bytes a CTA, CTAs an
    SM holds at once, and the card's SMs."""
    return _plan("levinson_plan", _LEVINSON_PLAN_KEYS, device, nseg, order)


def abs_mean_plan(nrows: int, start: int, n: int, device="cuda") -> dict:
    """How the abs-mean kernel runs a call shape on the card: rows a CTA
    (one warp), tile, ring stages, tiles a row, CTAs, shared bytes a CTA,
    CTAs an SM holds at once, and the card's SMs."""
    return _plan("abs_mean_plan", _ABS_MEAN_PLAN_KEYS, device, nrows, start,
                 n)


def dadd_cycles(device="cuda") -> float:
    """The card's dependent DADD latency in SM cycles: one warp runs chains
    of 2^12 and 2^16 dependent __dadd_rn, each timed with clock64; the
    slope between the two."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    cycles = torch.zeros(1, dtype=torch.int64, device=device)
    out = torch.empty(32, dtype=_F64, device=device)
    counts = []
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for n in (1 << 12, 1 << 16):
            err = _fn("dadd_probe")(1e-300, n, cycles.data_ptr(),
                                    out.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"dadd_probe failed: CUDA error {err}")
            counts.append((n, int(cycles.item())))
    (n1, c1), (n2, c2) = counts
    return (c2 - c1) / (n2 - n1)


def levinson_serial(ac: torch.Tensor, order: int):
    """ac [..., order + 1] float64 -> (lpc_coef, parcor, zerocase) (see
    levinson_serial_ref), 1 <= order <= KERNEL_MAX_ORDER on the card."""
    _check(ac.device, ac=ac)
    if order < 1 or ac.shape[-1] != order + 1:
        raise ValueError(f"ac has {ac.shape[-1]} lags for order {order}")
    if ac.device.type == "cpu":
        return levinson_serial_ref(ac, order)
    if order > KERNEL_MAX_ORDER:
        raise ValueError(f"order {order} exceeds the kernel's "
                         f"{KERNEL_MAX_ORDER}")
    lead = ac.shape[:-1]
    coef = ac.new_empty(lead + (order,))
    parcor = ac.new_empty(lead + (order,))
    # the kernel writes each flag as a byte 0 or 1: a bool tensor's layout
    zc = torch.empty(lead, dtype=torch.bool, device=ac.device)
    if zc.numel():
        _launch("levinson_serial", ac.device, (zc.numel(), order),
                ac.data_ptr(), coef.data_ptr(), parcor.data_ptr(),
                zc.data_ptr(), zc.numel(), order)
    return coef, parcor, zc


def serial_abs_mean(rows: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """rows [..., len] float64 -> sum(|rows[..., start:n]|) / n, serial in
    t; 0 <= start <= n <= len."""
    _check(rows.device, rows=rows)
    row_len = rows.shape[-1]
    if not (0 <= start <= n <= row_len and n >= 1):
        raise ValueError(f"bad range start={start} n={n} len={row_len}")
    if rows.device.type == "cpu":
        return serial_abs_mean_ref(rows, start, n)
    out = rows.new_empty(rows.shape[:-1])
    if out.numel():
        _launch("serial_abs_mean", rows.device,
                (out.numel(), row_len, start, n), rows.data_ptr(),
                out.data_ptr(), out.numel(), row_len, start, n)
    return out


def chain_predict(x: torch.Tensor, params: torch.Tensor):
    """x [B, n], params [B, units, npu] float64 -> (with_base, no_base)
    (see chain_predict_ref); units divides n."""
    _check(x.device, x=x, params=params)
    if x.dim() != 2 or params.dim() != 3 or params.shape[0] != x.shape[0]:
        raise ValueError(f"expected x [B, n] and params [B, units, npu], got "
                         f"{tuple(x.shape)} and {tuple(params.shape)}")
    B, n = x.shape
    units, npu = params.shape[1], params.shape[2]
    if units < 1 or npu < 1 or n % units:
        raise ValueError(f"{units} units of {npu} taps do not split {n}")
    if x.device.type == "cpu":
        return chain_predict_ref(x, params)
    base = torch.empty_like(x)
    nobase = torch.empty_like(x)
    if x.numel():
        _launch("chain_predict", x.device, (B, n, units, npu),
                x.data_ptr(), params.data_ptr(), base.data_ptr(),
                nobase.data_ptr(), B, n, units, npu)
    return base, nobase
