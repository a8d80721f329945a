"""Integer channel-decorrelation and pre-/de-emphasis filters (host oracle).

All arithmetic is int32 with arithmetic right shifts, exactly as specified by
the format (reference: libs/linne_internal/src/linne_utility.c:120-241).
Python/numpy int32 ops wrap modulo 2^32, matching the reference's behaviour
on two's-complement targets.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from .. import native as _native
from ..constants import PREEMPH_COEF_SHIFT


def ms_conversion(ch0: np.ndarray, ch1: np.ndarray) -> None:
    """L/R -> mid/side in place: s = r - l; m = l + (s >> 1)."""
    np.subtract(ch1, ch0, out=ch1)
    np.add(ch0, ch1 >> 1, out=ch0)


def lr_conversion(ch0: np.ndarray, ch1: np.ndarray) -> None:
    """mid/side -> L/R in place (inverse of ms_conversion)."""
    np.subtract(ch0, ch1 >> 1, out=ch0)
    np.add(ch1, ch0, out=ch1)


def preemphasis_calculate_coefficient(buffer: np.ndarray, n: int) -> int:
    """4-bit fixed-point pre-emphasis coefficient from the lag-1
    autocorrelation (reference: linne_utility.c:158-193). Serial float64
    accumulation order preserved via cumsum; the native helper fuses both
    correlation chains into one pass over the int32 samples (bit-identical,
    pinned by tests/test_exact_native_helpers.py)."""
    if _native.available():
        return _native.preemph_coef(buffer, n)
    d = buffer[:n].astype(np.float64)
    curr = d[:-1]
    succ = d[1:]
    corr0 = float(np.cumsum(curr * curr)[-1]) if n > 1 else 0.0
    corr1 = float(np.cumsum(curr * succ)[-1]) if n > 1 else 0.0
    # The reference divides before checking; with corr0 == 0 the quotient is
    # inf/NaN but the corr0 < 1e-6 test short-circuits to coef = 0 anyway.
    if corr0 < 1e-6:
        return 0
    corr1 = corr1 / corr0
    if corr1 < 0.0:
        return 0
    coef = int(_c_round(corr1 * 32.0))  # pow(2.0f, 5) == 32
    if coef >= (1 << (PREEMPH_COEF_SHIFT - 1)):
        coef = (1 << (PREEMPH_COEF_SHIFT - 1)) - 1
    return coef


def _c_round(d: float) -> float:
    return math.floor(d + 0.5) if d >= 0.0 else -math.floor(-d + 0.5)


def preemphasis(buffer: np.ndarray, n: int, prev: int, coef: int) -> None:
    """First-order fixed-point pre-emphasis, in place:
    y[s] = x[s] - ((x[s-1] * coef) >> 5), x[-1] = prev. Non-recursive, so it
    vectorizes (reference applies it serially, linne_utility.c:196-212)."""
    x = buffer[:n]
    shifted = np.empty(n, dtype=np.int32)
    shifted[0] = prev
    shifted[1:] = x[:-1]
    x -= (shifted * np.int32(coef)) >> PREEMPH_COEF_SHIFT


def multistage_deemphasis(
    buffer: np.ndarray,
    n: int,
    preem: Tuple[Tuple[int, int], Tuple[int, int]],
) -> None:
    """Inverse of the two pre-emphasis stages, in place.

    The reference fuses both stages into one interleaved loop
    (linne_utility.c:215-241); that loop is arithmetically identical to a
    full stage-1 inverse pass followed by a full stage-0 inverse pass, each a
    first-order integer recursion seeded by its transmitted `prev`:

        y[s] = z[s] + ((y[s-1] * c1) >> 5),  y[-1] = preem[1].prev
        x[s] = y[s] + ((x[s-1] * c0) >> 5),  x[-1] = preem[0].prev
    """
    (prev0, c0), (prev1, c1) = preem
    if c0 == 0 and c1 == 0:
        return
    # Both recursions interleaved in ONE python-int pass (the reference's
    # own fused structure, linne_utility.c:215-241) with the int32 wraps
    # inlined — a zero coefficient makes its stage an exact identity, so
    # the general loop covers every case.
    y1 = prev1
    y0 = prev0
    buf = buffer[:n].tolist()
    for s in range(n):
        t = (y1 * c1) & 0xFFFFFFFF
        if t >= 0x80000000:
            t -= 0x100000000
        y1 = (buf[s] + (t >> PREEMPH_COEF_SHIFT)) & 0xFFFFFFFF
        if y1 >= 0x80000000:
            y1 -= 0x100000000
        t = (y0 * c0) & 0xFFFFFFFF
        if t >= 0x80000000:
            t -= 0x100000000
        y0 = (y1 + (t >> PREEMPH_COEF_SHIFT)) & 0xFFFFFFFF
        if y0 >= 0x80000000:
            y0 -= 0x100000000
        buf[s] = y0
    buffer[:n] = np.array(buf, dtype=np.int64).astype(np.int32)
