"""The serial loops of the batched encode as CUDA kernels.

The JAX package runs three recursions of its default encode as
`lax.scan` loops inside jitted stages (linne_tpu/ops/analysis.py
`levinson_durbin`, `quantize_coefficients`; linne_tpu/ops/intops.py
`_predict_dense`). Eager torch would dispatch a dozen ops for every step of
each; here each is one launch of a hand-written kernel
(csrc/analysis_scans.cu). The plain torch versions stay in
ops/analysis.py (`_levinson_durbin_plain`, `_quantize_coefficients_plain`)
and ops/intops.py (`_predict_dense_plain`), whose public functions send a
CPU tensor to the plain version and a CUDA tensor here. There is no
fallback from one to the other.

The wrappers take the flat [rows, ...] layout, contiguous, on a CUDA
device, and raise ValueError on anything else (the device is checked
last). They launch on the
tensor's own device and its current stream. `KERNEL_LAUNCHES[name]` counts
each kernel's launches.

The quantizer and the predict cascade are bit-equal to their plain
versions. The recursion sums a . s in its own order (serial in a thread,
a fixed shuffle tree in a warp), so it agrees with its plain version to
rounding, deterministically and wherever a row sits in the batch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _kernels

KERNELS = ("levinson_durbin", "quantize_coefficients", "predict_dense")

# Launches of each kernel since import (or since a caller reset them);
# incremented only where the kernel is launched.
KERNEL_LAUNCHES = dict.fromkeys(KERNELS, 0)

# The format's largest layer order: the recursion, the quantizer and the
# predict cascade take orders 1..128.
KERNEL_MAX_ORDER = 128

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    "levinson_durbin": [_P, _P, _P, _L, _I, _P],
    "quantize_coefficients": [_P, _P, _P, _L, _I, _I, _P],
    "predict_dense": [_P, _P, _P, _P, _P, _L, _I, _I, _P],
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


def _launch(name: str, device: torch.device, *args) -> None:
    fn = _fn(name)
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


def quantize_coefficients(coefs: torch.Tensor, nbits: int = 8):
    """coefs [rows, order] float64 -> (int_coef [rows, order], rshift
    [rows]) int32: the error-feedback quantizer of
    ops/analysis.py:_quantize_coefficients_plain, bit for bit."""
    _check(torch.float64, coefs=coefs)
    if coefs.dim() != 2:
        raise ValueError(f"coefs must be [rows, order], got "
                         f"{tuple(coefs.shape)}")
    _check_order(coefs.shape[1])
    if not 1 <= nbits <= 31:
        raise ValueError(f"nbits {nbits} outside 1..31")
    _check_device(coefs.device)
    rows, order = coefs.shape
    int_coef = torch.empty((rows, order), dtype=torch.int32,
                           device=coefs.device)
    rshift = torch.empty((rows,), dtype=torch.int32, device=coefs.device)
    if rows:
        _launch("quantize_coefficients", coefs.device, coefs.data_ptr(),
                int_coef.data_ptr(), rshift.data_ptr(), rows, order, nbits)
    return int_coef, rshift


def predict_dense(x: torch.Tensor, coefs: torch.Tensor, log2u: torch.Tensor,
                  rshift: torch.Tensor, u_max: int) -> torch.Tensor:
    """x [rows, n], coefs [rows, order], log2u [rows], rshift [rows] int32
    -> [rows, n] int32: the masked full-order FIR with per-unit passthrough
    of ops/intops.py:_predict_dense_plain, bit for bit. u_max (a power of
    two) must divide n, and every log2u be at most log2(u_max)."""
    _check(torch.int32, x=x, coefs=coefs, log2u=log2u, rshift=rshift)
    if x.dim() != 2 or coefs.dim() != 2 or log2u.dim() != 1 \
            or rshift.dim() != 1:
        raise ValueError("expected x [rows, n], coefs [rows, order], log2u "
                         "[rows], rshift [rows]")
    rows, n = x.shape
    order = coefs.shape[1]
    _check_order(order)
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
                order)
    return out


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
