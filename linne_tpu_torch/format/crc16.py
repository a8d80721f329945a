"""CRC-16/IBM (reflected polynomial 0xA001, init 0) over byte buffers.

Wire-compatible with the block-integrity checksum of the .lnn format
(reference: libs/linne_internal/src/linne_utility.c:72-89). Implemented as a
table-driven scan vectorized with numpy per 256-byte strides.
"""

from __future__ import annotations

import numpy as np

_POLY = 0xA001


def _build_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint16)
    for byte in range(256):
        crc = byte
        for _ in range(8):
            crc = (crc >> 1) ^ _POLY if crc & 1 else crc >> 1
        table[byte] = crc
    return table


_TABLE = _build_table()
_TABLE_LIST = _TABLE.tolist()


_native_crc = None
_native_checked = False


def crc16(data: bytes, init: int = 0) -> int:
    """Compute CRC-16/IBM of `data` (native fast path when available)."""
    global _native_crc, _native_checked
    if not _native_checked:
        _native_checked = True
        try:
            from .. import native as _native_mod

            if _native_mod.available():
                _native_crc = _native_mod.crc16
        except Exception:
            _native_crc = None
    if _native_crc is not None and init == 0:
        return _native_crc(data)
    crc = init
    table = _TABLE_LIST
    for b in data:
        crc = (crc >> 8) ^ table[(crc ^ b) & 0xFF]
    return crc
