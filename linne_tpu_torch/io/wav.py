"""Minimal RIFF/WAVE PCM reader/writer (numpy, host side).

Functional equivalent of the reference's self-contained WAV layer
(reference: libs/wav/src/wav.c): linear PCM only, 8/16/24/32-bit, arbitrary
channel count. Samples are exposed at native precision as int32 (the
reference stores them left-justified in 32 bits and shifts at the CLI edge,
tools/linne_codec/linne_codec.c:101-105; we fold that shift into the reader).
8-bit PCM is unsigned with a 128 bias (wav.c:389-393).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


@dataclass
class WavFormat:
    num_channels: int
    sampling_rate: int
    bits_per_sample: int
    num_samples: int


class WavError(ValueError):
    pass


def read_wav(path: str):
    """Returns (WavFormat, samples[ch, n] int32 at native precision)."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise WavError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    pcm = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            if len(body) < 16:
                raise WavError("truncated fmt chunk")
            (audio_fmt, nch, rate, _brate, _align, bps) = struct.unpack_from(
                "<HHIIHH", body)
            if audio_fmt != 1:
                raise WavError(f"unsupported WAVE format tag {audio_fmt}")
            if bps not in (8, 16, 24, 32):
                raise WavError(f"unsupported bits per sample {bps}")
            if nch == 0:
                raise WavError("zero channels")
            fmt = (nch, rate, bps)
        elif cid == b"data":
            pcm = body
            if fmt is not None:
                break
        pos += 8 + size + (size & 1)
    if fmt is None or pcm is None:
        raise WavError("missing fmt/data chunk")
    nch, rate, bps = fmt
    bytes_per = bps // 8
    total = len(pcm) // (bytes_per * nch)
    if bps == 8:
        x = np.frombuffer(pcm, dtype=np.uint8, count=total * nch).astype(np.int32) - 128
    elif bps == 16:
        x = np.frombuffer(pcm, dtype="<i2", count=total * nch).astype(np.int32)
    elif bps == 24:
        b = np.frombuffer(pcm, dtype=np.uint8, count=3 * total * nch)
        b = b.reshape(-1, 3).astype(np.uint32)
        u = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        x = u.astype(np.int32)
        x = np.where(x >= 1 << 23, x - (1 << 24), x)
    elif bps == 32:
        x = np.frombuffer(pcm, dtype="<i4", count=total * nch).astype(np.int32)
    else:
        raise WavError(f"unsupported bits_per_sample {bps}")
    samples = x.reshape(total, nch).T.copy()
    return WavFormat(nch, rate, bps, total), samples


def write_wav(path: str, samples, sampling_rate: int,
              bits_per_sample: int) -> None:
    """samples: [ch, n] int32 at native precision — a 2D array or any
    sequence of per-channel 1D arrays (views are fine; the interleave below
    is the only full copy made)."""
    chans = [np.asarray(c) for c in samples]
    nch = len(chans)
    n = chans[0].shape[0]
    bps = bits_per_sample
    if bps == 8:
        body = np.empty((n, nch), dtype=np.uint8)
        for c, ch in enumerate(chans):
            body[:, c] = ch + 128
    elif bps == 16:
        body = np.empty((n, nch), dtype="<i2")
        for c, ch in enumerate(chans):
            body[:, c] = ch
    elif bps == 24:
        body = np.empty((n, nch, 3), dtype=np.uint8)
        for c, ch in enumerate(chans):
            body[:, c, 0] = ch & 0xFF
            body[:, c, 1] = (ch >> 8) & 0xFF
            body[:, c, 2] = (ch >> 16) & 0xFF
    elif bps == 32:
        body = np.empty((n, nch), dtype="<i4")
        for c, ch in enumerate(chans):
            body[:, c] = ch
    else:
        raise WavError(f"unsupported bits_per_sample {bps}")
    block_align = nch * (bps // 8)
    fmt = struct.pack("<HHIIHH", 1, nch, sampling_rate,
                      sampling_rate * block_align, block_align, bps)
    riff_size = 4 + (8 + len(fmt)) + (8 + body.nbytes)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", riff_size) + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", len(fmt)) + fmt)
        f.write(b"data" + struct.pack("<I", body.nbytes))
        f.write(body)
