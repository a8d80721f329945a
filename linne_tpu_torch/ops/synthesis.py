"""Batched integer LPC synthesis — the decode-side recurrence.
Counterpart of linne_tpu/ops/synthesis.py.

The reconstruction IIR (reference: libs/linne_decoder/src/
linne_lpc_synthesize.c:8-83) is the one irreducibly serial loop of the
codec: y[t] = x[t] - ((half + sum_j c[j]*y[t-npu+j]) >> rshift), and the
per-step arithmetic shift makes state-space blocking impossible bit-exactly.

`synthesize_rows` launches the hand-written CUDA kernel
(csrc/synthesis.cu: one warp per row, 32 steps per chunk, the sum split
into the terms that are final and those of the chunk in flight) on CUDA
tensors and runs `synthesize_rows_ref`, the plain torch version, on CPU
tensors. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from . import _kernels

# Launches of the CUDA kernel since import (or since a caller reset it);
# incremented only where the kernel is launched.
KERNEL_LAUNCHES = 0

# Taps per unit the kernel takes: the format's largest layer order.
KERNEL_MAX_NPU = 128

_synth_fn = None


def synthesize_rows_ref(x: torch.Tensor, coefs: torch.Tensor,
                        rshift: torch.Tensor) -> torch.Tensor:
    """Plain torch recurrence on any device: a Python loop over time.
    x: [rows, ns] int32; coefs: [rows, npu] int32 (wire order: c[j] pairs
    with y[t-npu+j]); rshift: [rows] int32. Returns [rows, ns] int32."""
    rows, ns = x.shape
    npu = coefs.shape[-1]
    if ns <= npu:
        return x.clone()
    # rshift=0 guard, as in the TPU kernel and the native runtime
    half = torch.where(rshift >= 1,
                       torch.ones_like(rshift) << (rshift - 1), 0)
    out = x.clone()
    win = x[:, :npu].clone()  # the last npu outputs
    for t in range(npu, ns):
        # dtype=int32 keeps the wire format's wrap: a plain torch.sum of
        # int32 returns int64
        pred = torch.sum(coefs * win, dim=-1, dtype=torch.int32) + half
        yt = x[:, t] - (pred >> rshift)
        out[:, t] = yt
        win = torch.cat([win[:, 1:], yt.unsqueeze(1)], dim=1)
    return out


def _kernel_fn():
    global _synth_fn
    if _synth_fn is None:
        fn = _kernels.load("synthesis").linne_synthesize_rows
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _synth_fn = fn
    return _synth_fn


def _check(x: torch.Tensor, coefs: torch.Tensor, rshift: torch.Tensor):
    for name, t in (("x", x), ("coefs", coefs), ("rshift", rshift)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 2 or coefs.dim() != 2 or rshift.dim() != 1:
        raise ValueError("expected x [rows, ns], coefs [rows, npu], "
                         "rshift [rows]")
    rows = x.shape[0]
    if coefs.shape[0] != rows or rshift.shape[0] != rows:
        raise ValueError(f"row counts differ: x {tuple(x.shape)}, coefs "
                         f"{tuple(coefs.shape)}, rshift {tuple(rshift.shape)}")
    if coefs.shape[1] < 1:
        raise ValueError("npu must be at least 1")


def synthesize_rows(x: torch.Tensor, coefs: torch.Tensor,
                    rshift: torch.Tensor) -> torch.Tensor:
    """Reconstruct [rows, ns] int32 rows (see synthesize_rows_ref for the
    layout). rshift is the 4-bit wire field, 0..15. CUDA tensors launch
    the kernel; CPU tensors take synthesize_rows_ref."""
    global KERNEL_LAUNCHES
    _check(x, coefs, rshift)
    if x.device.type == "cpu":
        return synthesize_rows_ref(x, coefs, rshift)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if coefs.shape[1] > KERNEL_MAX_NPU:
        raise ValueError(f"npu {coefs.shape[1]} exceeds the kernel's "
                         f"{KERNEL_MAX_NPU} taps")
    out = torch.empty_like(x)
    rows, ns = x.shape
    if out.numel() == 0:
        return out
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), coefs.data_ptr(), rshift.data_ptr(),
                 out.data_ptr(), rows, ns, coefs.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"synthesis kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES += 1
    return out
