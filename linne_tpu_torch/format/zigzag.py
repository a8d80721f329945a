"""Zigzag (signed <-> unsigned) mapping used throughout the format.

Wire rule (reference: libs/linne_internal/include/linne_utility.h:30-32):
negative v -> -2v - 1 (odd), non-negative v -> 2v (even).
"""

from __future__ import annotations

import numpy as np


def zigzag_encode_scalar(v: int) -> int:
    return (-(v << 1)) - 1 if v < 0 else (v << 1)


def zigzag_decode_scalar(u: int) -> int:
    return (u >> 1) ^ -(u & 1)


def zigzag_encode_array(v: np.ndarray) -> np.ndarray:
    """int32 array -> uint32 array (modular arithmetic matches the C macro's
    32-bit wraparound for the full int32 range)."""
    v = v.astype(np.int64)
    u = np.where(v < 0, (-(v << 1)) - 1, v << 1)
    return (u & 0xFFFFFFFF).astype(np.uint32)


def zigzag_decode_array(u: np.ndarray) -> np.ndarray:
    u = u.astype(np.uint32)
    out = (u >> np.uint32(1)).astype(np.int32) ^ -((u & np.uint32(1)).astype(np.int32))
    return out
