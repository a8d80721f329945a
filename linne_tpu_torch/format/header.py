""".lnn file header serialization (30 bytes, big-endian).

Layout (reference: libs/linne_encoder/src/linne_encoder.c:104-137,
libs/linne_decoder/src/linne_decoder.c:80-126):

    "IBRA" | fmt_ver u32 | codec_ver u32 | channels u16 | num_samples u32 |
    sampling_rate u32 | bits_per_sample u16 | samples_per_block u32 |
    preset u8 | ch_process_method u8
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from ..constants import (
    CH_PROCESS_MS,
    CODEC_VERSION,
    FORMAT_VERSION,
    HEADER_SIZE,
    MAGIC,
    NUM_PARAMETER_PRESETS,
)
from ..presets import PRESETS

_STRUCT = struct.Struct(">4sIIHIIHIBB")
assert _STRUCT.size == HEADER_SIZE


class FormatError(ValueError):
    pass


@dataclass
class LinneHeader:
    num_channels: int
    num_samples: int
    sampling_rate: int
    bits_per_sample: int
    num_samples_per_block: int
    preset: int
    ch_process_method: int
    format_version: int = FORMAT_VERSION
    codec_version: int = CODEC_VERSION

    def validate(self) -> None:
        if self.num_channels == 0:
            raise FormatError("num_channels must be > 0")
        if self.num_samples == 0:
            raise FormatError("num_samples must be > 0")
        if self.sampling_rate == 0:
            raise FormatError("sampling_rate must be > 0")
        if self.bits_per_sample == 0:
            raise FormatError("bits_per_sample must be > 0")
        if self.num_samples_per_block == 0:
            raise FormatError("num_samples_per_block must be > 0")
        if not (0 <= self.preset < NUM_PARAMETER_PRESETS):
            raise FormatError("preset out of range")
        if self.ch_process_method not in (0, 1):
            raise FormatError("invalid ch_process_method")
        if self.ch_process_method == CH_PROCESS_MS and self.num_channels == 1:
            raise FormatError("MS processing requires >= 2 channels")

    def pack(self) -> bytes:
        self.validate()
        return _STRUCT.pack(
            MAGIC,
            FORMAT_VERSION,  # always the library versions, as in the reference
            CODEC_VERSION,
            self.num_channels,
            self.num_samples,
            self.sampling_rate,
            self.bits_per_sample,
            self.num_samples_per_block,
            self.preset,
            self.ch_process_method,
        )

    @classmethod
    def unpack(cls, data: bytes, strict_version: bool = True) -> "LinneHeader":
        if len(data) < HEADER_SIZE:
            raise FormatError("insufficient data for header")
        (magic, fmt_ver, codec_ver, nch, nsmpl, rate, bps, spb, preset,
         chproc) = _STRUCT.unpack_from(data)
        if magic != MAGIC:
            raise FormatError("bad magic")
        header = cls(
            num_channels=nch,
            num_samples=nsmpl,
            sampling_rate=rate,
            bits_per_sample=bps,
            num_samples_per_block=spb,
            preset=preset,
            ch_process_method=chproc,
            format_version=fmt_ver,
            codec_version=codec_ver,
        )
        if strict_version:
            if fmt_ver != FORMAT_VERSION:
                raise FormatError(f"unsupported format version {fmt_ver}")
            if codec_ver != CODEC_VERSION:
                raise FormatError(f"unsupported codec version {codec_ver}")
        header.validate()
        return header


def check_stream_capacity(header: LinneHeader, stream_bytes: int) -> None:
    """Reject a header whose num_samples the body cannot possibly carry,
    BEFORE output planes are allocated. The 30-byte header has no CRC on
    the wire (reference layout, linne_encoder.c:104-137), so a corrupt
    num_samples (u32) would otherwise drive an allocation of up to
    8ch x 2^32 x 4B = 128 GiB from a tiny corrupt file (found by an
    extended fuzz). Bound: every block frame occupies >= 11 bytes
    (6 frame header + 5 minimum block size) and carries <= 65535 samples
    (the ns field is u16), so a body of B bytes yields at most
    ceil(B/11) * 65535 samples. Every valid stream passes (the exact
    per-block budget is far below the bound — even all-silent streams)."""
    body = max(0, stream_bytes - HEADER_SIZE)
    max_possible = ((body + 10) // 11) * 0xFFFF
    if header.num_samples > max_possible:
        raise FormatError(
            f"header claims {header.num_samples} samples but the "
            f"{body}-byte body can carry at most {max_possible}")


def check_decoder_capacity(header: LinneHeader, config) -> None:
    """Reject a header that needs more than the decoder's configured
    capacity (codec/params.py:DecoderConfig): channels, layers of its
    preset, or the order of a layer."""
    if header.num_channels > config.max_num_channels:
        raise FormatError("decoder capacity exceeded: channels")
    preset = PRESETS[header.preset]
    if preset.num_layers > config.max_num_layers:
        raise FormatError("decoder capacity exceeded: layers")
    if preset.max_num_params > config.max_num_parameters_per_layer:
        raise FormatError("decoder capacity exceeded: layer order")
