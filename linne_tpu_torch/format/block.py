"""Block framing and payload serialization of the .lnn format.

Frame layout (reference: libs/linne_encoder/src/linne_encoder.c:806-858,
libs/linne_decoder/src/linne_decoder.c:600-635):

    sync 0xFFFF u16 | block_size u32 | crc16 u16 | type u8 | nsamples u16 |
    payload...

`block_size` counts crc16+type+nsamples+payload (payload + 5 bytes);
`crc16` covers type+nsamples+payload (payload + 3 bytes).

Compress payload (reference: linne_encoder.c:698-752, linne_decoder.c:456-498):

    per ch, per pre-emphasis stage: zigzag(prev) in bps+1 bits, coef in 4 bits
    per ch, per layer: ceil(log2(num_units)) u3, rshift u4,
                       huffman(zigzag(coef)) per parameter
    per ch: partitioned recursive-Rice residual plane
    zero-pad to byte boundary

Raw payload: channel-interleaved zigzagged PCM at 8/16/24-bit big-endian.
Silent payload: empty.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np

from ..constants import (
    BLOCK_SYNC_CODE,
    BLOCK_TYPE_COMPRESS,
    BLOCK_TYPE_RAW,
    BLOCK_TYPE_SILENT,
    LOG2_NUM_UNITS_BITWIDTH,
    NUM_PREEMPH_FILTERS,
    PREEMPH_COEF_SHIFT,
    RSHIFT_BITWIDTH,
)
from .bitstream import BitReader, BitWriter
from .crc16 import crc16
from .header import FormatError
from .huffman import HuffmanCodebook
from .rice import decode_plane, encode_plane
from .zigzag import (
    zigzag_decode_array,
    zigzag_decode_scalar,
    zigzag_encode_array,
    zigzag_encode_scalar,
)

BLOCK_HEADER_SIZE = 11


@dataclass
class CompressBlockSideInfo:
    """Transmitted per-block model state for one channel set."""

    # [ch][stage] -> (prev, coef)
    preemph: List[List[Tuple[int, int]]] = field(default_factory=list)
    # [ch][layer] -> num_units (power of two)
    num_units: List[List[int]] = field(default_factory=list)
    # [ch][layer] -> right shift of the fixed-point coefficients
    rshifts: List[List[int]] = field(default_factory=list)
    # [ch][layer] -> int32 ndarray of quantized coefficients
    coefs: List[List[np.ndarray]] = field(default_factory=list)


def write_compress_payload(
    side: CompressBlockSideInfo,
    residuals: Sequence[np.ndarray],
    bits_per_sample: int,
    codebook: HuffmanCodebook,
) -> bytes:
    writer = BitWriter()
    num_channels = len(residuals)
    for ch in range(num_channels):
        for stage in range(NUM_PREEMPH_FILTERS):
            prev, coef = side.preemph[ch][stage]
            writer.put(zigzag_encode_scalar(prev), bits_per_sample + 1)
            writer.put(coef, PREEMPH_COEF_SHIFT - 1)
    for ch in range(num_channels):
        for layer, coefs in enumerate(side.coefs[ch]):
            nunits = side.num_units[ch][layer]
            writer.put((nunits - 1).bit_length(), LOG2_NUM_UNITS_BITWIDTH)
            writer.put(side.rshifts[ch][layer], RSHIFT_BITWIDTH)
            for u in zigzag_encode_array(coefs).tolist():
                codebook.put(writer, u)
    for ch in range(num_channels):
        encode_plane(writer, residuals[ch])
    writer.flush()
    return writer.getvalue()


def read_compress_payload(
    data: bytes,
    num_channels: int,
    num_samples: int,
    bits_per_sample: int,
    layer_num_params: Sequence[int],
    codebook: HuffmanCodebook,
) -> Tuple[CompressBlockSideInfo, List[np.ndarray], int]:
    """Parse a compress payload; returns (side info, residual planes,
    consumed byte count)."""
    reader = BitReader(data)
    side = CompressBlockSideInfo()
    for _ch in range(num_channels):
        stages = []
        for _stage in range(NUM_PREEMPH_FILTERS):
            prev = zigzag_decode_scalar(reader.get(bits_per_sample + 1))
            coef = reader.get(PREEMPH_COEF_SHIFT - 1)
            stages.append((prev, coef))
        side.preemph.append(stages)
    for _ch in range(num_channels):
        units_row: List[int] = []
        rshift_row: List[int] = []
        coef_row: List[np.ndarray] = []
        for nparams in layer_num_params:
            log2_units = reader.get(LOG2_NUM_UNITS_BITWIDTH)
            units_row.append(1 << log2_units)
            rshift_row.append(reader.get(RSHIFT_BITWIDTH))
            syms = np.fromiter(
                (codebook.get(reader) for _ in range(nparams)),
                dtype=np.uint32,
                count=nparams,
            )
            coef_row.append(zigzag_decode_array(syms))
        side.num_units.append(units_row)
        side.rshifts.append(rshift_row)
        side.coefs.append(coef_row)
    residuals = [decode_plane(reader, num_samples) for _ in range(num_channels)]
    reader.flush()
    return side, residuals, reader.tell()


def write_raw_payload(channels: Sequence[np.ndarray], bits_per_sample: int) -> bytes:
    num_channels = len(channels)
    interleaved = np.empty(num_channels * channels[0].shape[0], dtype=np.int64)
    for ch, plane in enumerate(channels):
        interleaved[ch::num_channels] = plane
    u = zigzag_encode_array(interleaved)
    if bits_per_sample == 8:
        return u.astype(np.uint8).tobytes()
    if bits_per_sample == 16:
        return u.astype(">u2").tobytes()
    if bits_per_sample == 24:
        b = np.empty((u.shape[0], 3), dtype=np.uint8)
        b[:, 0] = (u >> 16) & 0xFF
        b[:, 1] = (u >> 8) & 0xFF
        b[:, 2] = u & 0xFF
        return b.tobytes()
    raise FormatError(f"unsupported bits_per_sample {bits_per_sample} for raw block")


def read_raw_payload(
    data: bytes, num_channels: int, num_samples: int, bits_per_sample: int
) -> Tuple[List[np.ndarray], int]:
    total = num_channels * num_samples
    nbytes = total * (bits_per_sample // 8)
    if len(data) < nbytes:
        raise FormatError("insufficient data for raw block")
    if bits_per_sample == 8:
        u = np.frombuffer(data, dtype=np.uint8, count=total).astype(np.uint32)
    elif bits_per_sample == 16:
        u = np.frombuffer(data, dtype=">u2", count=total).astype(np.uint32)
    elif bits_per_sample == 24:
        b = np.frombuffer(data, dtype=np.uint8, count=3 * total).reshape(total, 3)
        u = (
            (b[:, 0].astype(np.uint32) << 16)
            | (b[:, 1].astype(np.uint32) << 8)
            | b[:, 2].astype(np.uint32)
        )
    else:
        raise FormatError(f"unsupported bits_per_sample {bits_per_sample} for raw block")
    v = zigzag_decode_array(u)
    return [v[ch::num_channels].copy() for ch in range(num_channels)], nbytes


def frame_block(block_type: int, num_samples: int, payload: bytes) -> bytes:
    """Wrap a payload with the sync/size/CRC block header."""
    body = struct.pack(">BH", block_type, num_samples) + payload
    crc = crc16(body)
    return (
        struct.pack(">HIH", BLOCK_SYNC_CODE, len(payload) + 5, crc) + body
    )


@dataclass
class BlockHeader:
    block_type: int
    num_samples: int
    block_size: int  # as stored: payload size + 5
    crc: int

    @property
    def payload_size(self) -> int:
        return self.block_size - 5

    @property
    def total_size(self) -> int:
        return self.block_size + 6


def parse_block_header(data: bytes, check_crc: bool = False) -> BlockHeader:
    if len(data) < BLOCK_HEADER_SIZE:
        raise FormatError("insufficient data for block header")
    sync, size, crc, btype, nsamples = struct.unpack_from(">HIHBH", data)
    if sync != BLOCK_SYNC_CODE:
        raise FormatError("bad block sync code")
    if size + 6 > len(data):
        raise FormatError("insufficient data for block body")
    if check_crc:
        actual = crc16(bytes(data[8 : 6 + size]))
        if actual != crc:
            raise CorruptionError(
                f"block CRC mismatch: stored {crc:#06x}, computed {actual:#06x}")
    if btype not in (BLOCK_TYPE_COMPRESS, BLOCK_TYPE_SILENT, BLOCK_TYPE_RAW):
        raise FormatError(f"invalid block type {btype}")
    return BlockHeader(btype, nsamples, size, crc)


class CorruptionError(FormatError):
    """Raised when a block fails its CRC-16 integrity check."""
