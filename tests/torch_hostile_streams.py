"""Hostile .lnn streams for the port's decoders, made from a valid stream:
seeded byte mutations, truncations, a corrupt num_samples header, and
compress blocks whose side info no encoder writes (layers with more units
than taps, rshift 0).

jax-free: imported by tests/test_torch_fuzz_decoder.py on the CPU and by
chip_smoke.py's hostile-stream phase on the card.
"""

from __future__ import annotations

import struct
from typing import Iterator

import numpy as np

from linne_tpu_torch.constants import (
    BLOCK_TYPE_COMPRESS,
    HEADER_SIZE,
    LOG2_NUM_UNITS_BITWIDTH,
)
from linne_tpu_torch.format.block import (
    BLOCK_HEADER_SIZE,
    frame_block,
    parse_block_header,
    read_compress_payload,
    write_compress_payload,
)
from linne_tpu_torch.format.header import LinneHeader
from linne_tpu_torch.format.huffman import get_codebook
from linne_tpu_torch.presets import PRESETS

# the most units the 3-bit log2 field can carry
MAX_UNITS = 1 << ((1 << LOG2_NUM_UNITS_BITWIDTH) - 1)


def mutations(data: bytes, count: int, seed: int, start: int = HEADER_SIZE,
              max_bytes: int = 5) -> Iterator[bytes]:
    """`count` copies of `data`, each with 1..max_bytes random bytes set
    at offsets `start` or later."""
    rng = np.random.default_rng(seed)
    for _ in range(count):
        m = bytearray(data)
        for _ in range(int(rng.integers(1, max_bytes + 1))):
            m[int(rng.integers(start, len(m)))] = int(rng.integers(0, 256))
        yield bytes(m)


def truncations(data: bytes, step: int = 97) -> Iterator[bytes]:
    """Every prefix of `data` from the header's end, `step` bytes apart."""
    for cut in range(HEADER_SIZE, len(data), step):
        yield data[:cut]


def giant_num_samples(data: bytes) -> bytes:
    """`data` with a num_samples (u32 at offset 14) that no body of its
    size can carry."""
    bad = bytearray(data)
    bad[14:18] = (0xFFFFFFF0).to_bytes(4, "big")
    return bytes(bad)


def block_offsets(data: bytes) -> list:
    """Offset of every block frame of a valid stream."""
    offsets, off = [], HEADER_SIZE
    while off + BLOCK_HEADER_SIZE <= len(data):
        offsets.append(off)
        off += parse_block_header(data[off:]).total_size
    return offsets


def block_kinds(data: bytes) -> list:
    """The block type of every block frame of a valid stream."""
    return [parse_block_header(data[off:]).block_type
            for off in block_offsets(data)]


def rewrite_side_info(data: bytes, edit) -> bytes:
    """`data` with its first compress block rewritten (CRC valid) after
    `edit(side)` has changed the block's side info in place
    (format/block.py:CompressBlockSideInfo); every residual keeps its
    value."""
    header = LinneHeader.unpack(data)
    preset = PRESETS[header.preset]
    cb = get_codebook(preset.coef_freq_table)
    for off in block_offsets(data):
        bh = parse_block_header(data[off:])
        if bh.block_type == BLOCK_TYPE_COMPRESS:
            break
    else:
        raise ValueError("the stream has no compress block")
    payload = data[off + BLOCK_HEADER_SIZE : off + bh.total_size]
    side, residuals, _ = read_compress_payload(
        payload, header.num_channels, bh.num_samples,
        header.bits_per_sample, preset.layer_num_params, cb)
    edit(side)
    block = frame_block(BLOCK_TYPE_COMPRESS, bh.num_samples,
                        write_compress_payload(side, residuals,
                                               header.bits_per_sample, cb))
    return data[:off] + block + data[off + bh.total_size:]


def units_above_order(data: bytes) -> bytes:
    """`data` with channel 0 of its first compress block splitting every
    layer into MAX_UNITS units: each layer of an order below MAX_UNITS
    then has no taps per unit (order // units == 0), which no encoder
    writes. The other channels keep their side info."""
    def edit(side):
        side.num_units[0] = [MAX_UNITS] * len(side.num_units[0])
    return rewrite_side_info(data, edit)


def rshift_zero(data: bytes) -> bytes:
    """`data` with channel 0 of its first compress block at rshift 0 in
    every layer: the coefficients, scaled for their shift, then act
    unscaled, and the recurrence grows past any sample width."""
    def edit(side):
        side.rshifts[0] = [0] * len(side.rshifts[0])
    return rewrite_side_info(data, edit)


def layer_units(data: bytes, block: int = 0) -> list:
    """[channel][layer] unit counts of compress block `block` as a decoder
    parses them."""
    header = LinneHeader.unpack(data)
    preset = PRESETS[header.preset]
    off = block_offsets(data)[block]
    bh = parse_block_header(data[off:])
    if bh.block_type != BLOCK_TYPE_COMPRESS:
        raise ValueError(f"block {block} is not a compress block")
    side, _, _ = read_compress_payload(
        data[off + BLOCK_HEADER_SIZE : off + bh.total_size],
        header.num_channels, bh.num_samples, header.bits_per_sample,
        preset.layer_num_params, get_codebook(preset.coef_freq_table))
    return side.num_units


def block_size_field(data: bytes, block: int, value: int) -> bytes:
    """`data` with block `block`'s stored block_size set to `value`."""
    bad = bytearray(data)
    struct.pack_into(">I", bad, block_offsets(data)[block] + 2, value)
    return bytes(bad)


def block_samples_field(data: bytes, block: int, value: int) -> bytes:
    """`data` with block `block`'s num_samples field set to `value`."""
    bad = bytearray(data)
    struct.pack_into(">H", bad, block_offsets(data)[block] + 9, value)
    return bytes(bad)
