"""Streaming block-at-a-time decoding — the player path.
Copy of linne_tpu/codec/streaming.py.

Functional equivalent of the reference's pull-based player core
(reference: tools/linne_player/linne_player.c:110-146): an audio callback
requests N samples; when the internal buffer runs dry the next block is
decoded on demand. Decode must beat realtime per block — the native host
synthesis path does (hundreds of x realtime), so the render thread never
starves.

`StreamingDecoder.read()` is the backend-agnostic pull API a playback
backend calls from its render callback; the bundled backends (sounddevice /
OS pipe players / file sink — the host-side counterparts of the reference's
PulseAudio/WASAPI/CoreAudio backends) live in `linne_tpu_torch.player`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..constants import HEADER_SIZE
from ..format.header import LinneHeader
from .decoder import Decoder
from .params import DecoderConfig


class StreamingDecoder:
    """Pull-based decoder over an in-memory .lnn stream."""

    def __init__(self, data: bytes, config: Optional[DecoderConfig] = None):
        self._data = data
        self._decoder = Decoder(config)
        self.header: LinneHeader = LinneHeader.unpack(data)
        self._decoder.set_header(self.header)
        self._offset = HEADER_SIZE
        self._produced = 0
        self._buffer = np.zeros((self.header.num_channels, 0), dtype=np.int32)
        self._buffer_pos = 0

    @property
    def num_channels(self) -> int:
        return self.header.num_channels

    @property
    def exhausted(self) -> bool:
        return (self._produced >= self.header.num_samples
                and self._buffer_pos >= self._buffer.shape[1])

    def _decode_next_block(self) -> bool:
        if (self._produced >= self.header.num_samples
                or self._offset >= len(self._data)):
            return False
        channels, consumed = self._decoder.decode_block(
            self._data[self._offset :])
        self._offset += consumed
        self._produced += channels[0].shape[0]
        self._buffer = np.stack(channels)
        self._buffer_pos = 0
        return True

    def read(self, num_samples: int) -> np.ndarray:
        """Pull up to `num_samples` frames; returns [ch, m] with m <=
        num_samples (m < num_samples only at end of stream). This is the
        audio-callback entry point: it decodes at most as many blocks as
        needed to satisfy the request."""
        out = np.zeros((self.num_channels, num_samples), dtype=np.int32)
        filled = 0
        while filled < num_samples:
            avail = self._buffer.shape[1] - self._buffer_pos
            if avail == 0:
                if not self._decode_next_block():
                    break
                continue
            take = min(avail, num_samples - filled)
            out[:, filled : filled + take] = self._buffer[
                :, self._buffer_pos : self._buffer_pos + take]
            self._buffer_pos += take
            filled += take
        return out[:, :filled]

    def seek(self, sample_index: int) -> None:
        """Reposition to `sample_index` (0-based frame). Every block carries
        its full model state (the reference re-transmits even the
        de-emphasis history per block, linne_encoder.c:706-709), so seeking
        is a header-only scan to the containing block plus an intra-block
        skip — no decode of preceding audio."""
        from ..format.block import parse_block_header

        if not (0 <= sample_index <= self.header.num_samples):
            raise ValueError("seek out of range")
        view = memoryview(self._data)  # zero-copy header scan
        offset = HEADER_SIZE
        produced = 0
        while produced < self.header.num_samples and offset < len(self._data):
            bh = parse_block_header(view[offset:])
            if produced + bh.num_samples > sample_index:
                break
            produced += bh.num_samples
            offset += bh.total_size
        self._offset = offset
        self._produced = produced
        self._buffer = np.zeros((self.header.num_channels, 0), dtype=np.int32)
        self._buffer_pos = 0
        skip = sample_index - produced
        if skip:
            self.read(skip)

    def play(self, chunk_frames: int = 4096, backend=None) -> None:
        """Convenience playback through a `linne_tpu_torch.player` backend
        (first available one if none is given)."""
        from ..player import Player, SounddeviceBackend, pick_backend

        backend = backend or pick_backend()
        if isinstance(backend, SounddeviceBackend):
            backend.play_stream(self, chunk_frames)
        else:
            Player(self, backend).run(chunk_frames)


def open_file(path: str, config: Optional[DecoderConfig] = None) -> StreamingDecoder:
    with open(path, "rb") as f:
        return StreamingDecoder(f.read(), config)
