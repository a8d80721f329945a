"""Analysis window weights (host-computed constants, device-applied).

A copy of linne_tpu/ops/windows.py: that module cannot be imported without
jax, because its package `linne_tpu.ops` enables jax's x64 mode on import.

Weight definitions follow the format's analysis conventions
(reference: libs/lpc/src/lpc.c:176-212): the sin window sin(pi*s/(n-1)) and
the Welch window 4*s*(n-1-s)/(n-1)^2 mirrored from both ends (the middle
sample of an odd-length Welch window is unweighted in the reference; the
fast path uses the true weight there — analysis-only, does not affect
losslessness).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

WINDOW_RECTANGULAR = 0
WINDOW_SIN = 1
WINDOW_WELCH = 2


@lru_cache(maxsize=256)
def window_weights(window_type: int, n: int) -> np.ndarray:
    if window_type == WINDOW_RECTANGULAR:
        return np.ones(n, dtype=np.float64)
    if window_type == WINDOW_SIN:
        return np.array(
            [math.sin((math.pi * s) / (n - 1)) for s in range(n)],
            dtype=np.float64)
    if window_type == WINDOW_WELCH:
        divisor = 4.0 * math.pow(n - 1, -2.0)
        w = np.empty(n, dtype=np.float64)
        for s in range(n):
            w[s] = divisor * s * (n - 1 - s)
        return w
    raise ValueError(f"unknown window type {window_type}")
