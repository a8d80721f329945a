"""MSB-first bit reader/writer over byte buffers.

Wire-compatible with the reference bit stream layer
(reference: libs/bit_stream/include/bit_stream.h:240-434): values are written
most-significant-bit first, `flush` pads the current byte with zero bits and
byte-aligns the position, and zero-run codes are `run` zero bits followed by a
terminating one bit.

This is the portable host fallback; the performance path is the native C++
packer in `native/` (same wire format, word-at-a-time).
"""

from __future__ import annotations


class BitWriter:
    """Append-only MSB-first bit packer."""

    __slots__ = ("_buf", "_acc", "_nbits")

    def __init__(self) -> None:
        self._buf = bytearray()
        self._acc = 0  # pending bits, value in low `_nbits` bits
        self._nbits = 0

    def put(self, val: int, nbits: int) -> None:
        """Write the low `nbits` bits of `val` (0 <= nbits <= 32)."""
        if nbits == 0:
            return
        self._acc = (self._acc << nbits) | (val & ((1 << nbits) - 1))
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self._buf.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def put_zero_run(self, runlength: int) -> None:
        """Write `runlength` zero bits followed by a terminating 1 bit."""
        self.put_zeros(runlength)
        self.put(1, 1)

    def put_zeros(self, nzeros: int) -> None:
        self._nbits += nzeros
        self._acc <<= nzeros
        while self._nbits >= 8:
            self._nbits -= 8
            self._buf.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def flush(self) -> None:
        """Pad with zero bits to the next byte boundary."""
        if self._nbits > 0:
            pad = 8 - self._nbits
            self._acc <<= pad
            self._buf.append(self._acc & 0xFF)
            self._acc = 0
            self._nbits = 0

    def tell(self) -> int:
        """Byte position (only meaningful on a byte boundary, as in the
        reference where Tell follows Flush)."""
        return len(self._buf)

    def getvalue(self) -> bytes:
        return bytes(self._buf)


class BitReader:
    """MSB-first bit reader over a bytes-like object."""

    __slots__ = ("_data", "_pos", "_acc", "_nbits")

    def __init__(self, data) -> None:
        self._data = bytes(data)
        self._pos = 0  # next byte index to fetch
        self._acc = 0
        self._nbits = 0

    def get(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        while self._nbits < nbits:
            self._acc = (self._acc << 8) | self._data[self._pos]
            self._pos += 1
            self._nbits += 8
        self._nbits -= nbits
        val = (self._acc >> self._nbits) & ((1 << nbits) - 1)
        self._acc &= (1 << self._nbits) - 1
        return val

    def peek(self, nbits: int) -> int:
        """Return the next `nbits` bits without consuming them, zero-padded
        past end of buffer (for LUT-based decoders that overscan)."""
        data = self._data
        end = len(data)
        while self._nbits < nbits and self._pos < end:
            self._acc = (self._acc << 8) | data[self._pos]
            self._pos += 1
            self._nbits += 8
        if self._nbits >= nbits:
            return (self._acc >> (self._nbits - nbits)) & ((1 << nbits) - 1)
        return (self._acc << (nbits - self._nbits)) & ((1 << nbits) - 1)

    def skip(self, nbits: int) -> None:
        """Consume `nbits` bits (raises at end of buffer like get)."""
        self.get(nbits)

    def get_zero_run_length(self) -> int:
        """Count zero bits until (and consuming) the next 1 bit."""
        run = 0
        while True:
            while self._nbits == 0:
                self._acc = self._data[self._pos]
                self._pos += 1
                self._nbits = 8
            # scan buffered bits for a set bit
            if self._acc == 0:
                run += self._nbits
                self._nbits = 0
                continue
            top = self._acc.bit_length()
            run += self._nbits - top
            self._nbits = top - 1
            self._acc &= (1 << self._nbits) - 1
            return run

    def bit_position(self) -> int:
        """Absolute offset of the next unread bit."""
        return self._pos * 8 - self._nbits

    def seek_bit(self, bitpos: int) -> None:
        """Reposition to an absolute bit offset (re-primes the buffer)."""
        byte = bitpos >> 3
        off = bitpos & 7
        if off:
            self._acc = self._data[byte] & ((1 << (8 - off)) - 1)
            self._nbits = 8 - off
            self._pos = byte + 1
        else:
            self._acc = 0
            self._nbits = 0
            self._pos = byte

    def flush(self) -> None:
        """Discard buffered partial-byte bits; byte-align the position."""
        self._pos -= self._nbits >> 3
        self._acc = 0
        self._nbits = 0

    def tell(self) -> int:
        """Byte position (meaningful after flush, as in the reference)."""
        return self._pos

    def remaining_bytes(self) -> int:
        return len(self._data) - self._pos
