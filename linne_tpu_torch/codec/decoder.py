"""Host decoder for .lnn streams.

Decode is deterministic integer filtering — bit-exact by construction
(reference: libs/linne_decoder/src/linne_decoder.c). This host path drives
the format layer and the integer synthesis cascade; the batched path
(`codec.torch_decoder`) replaces the per-layer synthesis with pooled
launches of the synthesis CUDA kernel. The port's own copy of
linne_tpu/codec/decoder.py.

Decoding is restartable at block granularity: every compress block carries
its complete model state including the de-emphasis history, so any block
decodes standalone (reference transmits `prev` per block,
linne_encoder.c:706-709).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..constants import (
    BLOCK_TYPE_COMPRESS,
    BLOCK_TYPE_RAW,
    BLOCK_TYPE_SILENT,
    CH_PROCESS_MS,
    HEADER_SIZE,
)
from .. import native
from ..exact.filters import lr_conversion, multistage_deemphasis
from ..exact.intlpc import synthesize
from ..format.block import (
    BLOCK_HEADER_SIZE,
    CorruptionError,
    parse_block_header,
    read_compress_payload,
    read_raw_payload,
)
from ..format.header import (
    FormatError,
    LinneHeader,
    check_decoder_capacity,
    check_stream_capacity,
)
from ..format.huffman import get_codebook
from ..presets import PRESETS
from .params import DecoderConfig


class Decoder:
    def __init__(self, config: DecoderConfig | None = None):
        self.config = config or DecoderConfig()
        self.header: LinneHeader | None = None
        self.preset = None
        self.codebook = None

    def set_header(self, header: LinneHeader) -> None:
        header.validate()
        check_decoder_capacity(header, self.config)
        preset = PRESETS[header.preset]
        self.header = header
        self.preset = preset
        self.codebook = get_codebook(preset.coef_freq_table)

    def decode_block(self, data: bytes) -> Tuple[List[np.ndarray], int]:
        """Decode one block; returns (channel planes, consumed bytes)."""
        if self.header is None:
            raise RuntimeError("header not set")
        header = self.header
        bh = parse_block_header(data, check_crc=self.config.check_crc)
        payload = data[BLOCK_HEADER_SIZE : 6 + bh.block_size]
        n = bh.num_samples
        nch = header.num_channels

        if bh.block_type == BLOCK_TYPE_SILENT:
            channels = [np.zeros(n, dtype=np.int32) for _ in range(nch)]
            return channels, bh.total_size

        if bh.block_type == BLOCK_TYPE_RAW:
            channels, _ = read_raw_payload(
                payload, nch, n, header.bits_per_sample)
            return channels, bh.total_size

        assert bh.block_type == BLOCK_TYPE_COMPRESS
        if native.available():
            return self._decode_compress_native(payload, n, nch), bh.total_size
        side, residuals, _ = read_compress_payload(
            payload, nch, n, header.bits_per_sample,
            self.preset.layer_num_params, self.codebook)
        channels = []
        for ch in range(nch):
            buf = residuals[ch]
            for l in range(self.preset.num_layers - 1, -1, -1):
                synthesize(buf, n, side.coefs[ch][l],
                           side.num_units[ch][l], side.rshifts[ch][l])
            multistage_deemphasis(buf, n, tuple(side.preemph[ch]))
            channels.append(buf)
        if header.ch_process_method == CH_PROCESS_MS:
            lr_conversion(channels[0], channels[1])
        return channels, bh.total_size

    def _decode_compress_native(self, payload: bytes, n: int,
                                nch: int) -> List[np.ndarray]:
        """Entropy decode + full integer reconstruction in the native host
        library (single pass, no Python bit loops)."""
        cb = self.codebook
        orders = np.asarray(self.preset.layer_num_params, dtype=np.int32)
        try:
            (residuals, coefs, log2u, rshifts, pprev, pcoef, _consumed) = (
                native.unpack_compress_payload(
                    payload, cb.node0_array, cb.node1_array, cb.root,
                    cb.num_symbols, nch, n, self.header.bits_per_sample,
                    orders))
        except native.StreamDecodeError as e:
            # public error contract: corrupt payloads raise FormatError
            # (matching the whole-stream native path and the pure-Python
            # format layer), never a raw RuntimeError
            raise FormatError(str(e)) from e
        native.synthesize_block(
            residuals, coefs, log2u, rshifts, pprev, pcoef, orders,
            self.header.ch_process_method == CH_PROCESS_MS)
        return [residuals[ch] for ch in range(nch)]

    def decode_whole(self, data: bytes) -> List[np.ndarray]:
        header = LinneHeader.unpack(data)
        self.set_header(header)
        check_stream_capacity(header, len(data))
        if native.available():
            return self._decode_whole_native(data)
        out = [np.zeros(header.num_samples, dtype=np.int32)
               for _ in range(header.num_channels)]
        progress = 0
        offset = HEADER_SIZE
        while progress < header.num_samples and offset < len(data):
            channels, consumed = self.decode_block(data[offset:])
            n = channels[0].shape[0]
            for ch in range(header.num_channels):
                out[ch][progress : progress + n] = channels[ch]
            progress += n
            offset += consumed
        if progress < header.num_samples:
            # same contract as the native scan: a cleanly-truncated body
            # must not report success with a silently zero-filled tail
            raise FormatError(
                f"stream body ends after {progress} of "
                f"{header.num_samples} samples")
        return out

    def _decode_whole_native(self, data: bytes) -> List[np.ndarray]:
        """Single native call: block scan + CRC + entropy decode + integer
        synthesis, threaded over independent blocks (every block carries its
        full model state, so decode order is free)."""
        header = self.header
        cb = self.codebook
        orders = np.asarray(self.preset.layer_num_params, dtype=np.int32)
        try:
            planes = native.decode_stream(
                data[HEADER_SIZE:], header.num_samples,
                cb.node0_array, cb.node1_array, cb.root, cb.num_symbols,
                header.num_channels, header.bits_per_sample, orders,
                header.ch_process_method == CH_PROCESS_MS,
                self.config.check_crc, self.config.num_threads)
        except native.StreamCrcError as e:
            raise CorruptionError(str(e)) from e
        except native.StreamDecodeError as e:
            raise FormatError(str(e)) from e
        return [planes[ch] for ch in range(header.num_channels)]


def decode_file(path: str, config: DecoderConfig | None = None) -> Tuple[LinneHeader, List[np.ndarray]]:
    with open(path, "rb") as f:
        data = f.read()
    dec = Decoder(config)
    channels = dec.decode_whole(data)
    return dec.header, channels
