"""Streaming .lnn player with pluggable output backends.
Copy of linne_tpu/player.py.

Counterpart of the reference player (tools/linne_player/linne_player.c plus
its three OS backends linne_player_{pulseaudio,wasapi,coreaudio}.c). The
pull core lives in `codec.streaming.StreamingDecoder.read()` — equivalent to
the reference's request callback (linne_player.c:110-146) — and this module
supplies the output stage:

- `SounddeviceBackend`: cross-platform audio output through the PortAudio
  binding (declared as the `playback` extra in pyproject.toml), callback
  (pull) driven like the reference backends.
- `PipeBackend`: pipes raw PCM to an external player process (`aplay`,
  `paplay`, `pw-play`, `ffplay` — whichever the host has), push driven.
- `FileBackend`: renders to a WAV file / discards — a deterministic sink for
  tests and offline rendering.

`play_file()` / `python -m linne_tpu_torch.player song.lnn` pick the first
backend that works.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from typing import Optional, Sequence

import numpy as np

from .codec.params import DecoderConfig
from .codec.streaming import StreamingDecoder

_CHUNK_FRAMES = 4096


def _to_int16(chunk: np.ndarray, bits_per_sample: int) -> np.ndarray:
    """[ch, n] native-depth int32 -> [n, ch] int16 frames."""
    shift = 16 - bits_per_sample
    pcm = chunk.T
    pcm = pcm << shift if shift >= 0 else pcm >> -shift
    return np.ascontiguousarray(pcm.astype(np.int16))


class FileBackend:
    """Deterministic sink: collects rendered int16 frames; optionally writes
    a WAV file on close. Used by tests and for offline rendering."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.rate = None
        self.channels = None
        self.frames = []

    def open(self, rate: int, channels: int) -> None:
        self.rate = rate
        self.channels = channels

    def write(self, frames: np.ndarray) -> None:  # [n, ch] int16
        self.frames.append(frames)

    def close(self) -> None:
        if self.path is not None and self.frames:
            from .io.wav import write_wav

            pcm = np.concatenate(self.frames, axis=0).T.astype(np.int32)
            write_wav(self.path, pcm, self.rate, 16)

    @property
    def num_frames_written(self) -> int:
        return sum(f.shape[0] for f in self.frames)


class PipeBackend:
    """Pushes raw PCM into an external player's stdin.

    Default candidates cover ALSA (`aplay`), PulseAudio (`paplay`) and
    PipeWire (`pw-play`) — the same OS surface the reference's native
    backends target, reached through the host's own player binaries.
    """

    CANDIDATES = (
        ("aplay", lambda r, c: ["aplay", "-q", "-t", "raw", "-f", "S16_LE",
                                "-r", str(r), "-c", str(c)]),
        ("paplay", lambda r, c: ["paplay", "--raw", "--format=s16le",
                                 f"--rate={r}", f"--channels={c}"]),
        ("pw-play", lambda r, c: ["pw-play", "--format", "s16",
                                  "--rate", str(r), "--channels", str(c),
                                  "-"]),
    )

    def __init__(self, command: Optional[Sequence[str]] = None):
        self._command = list(command) if command else None
        self._proc = None

    @classmethod
    def available(cls) -> bool:
        return any(shutil.which(name) for name, _ in cls.CANDIDATES)

    def open(self, rate: int, channels: int) -> None:
        if self._command is None:
            for name, build in self.CANDIDATES:
                if shutil.which(name):
                    self._command = build(rate, channels)
                    break
            else:
                raise RuntimeError("no pipe player (aplay/paplay/pw-play)")
        self._proc = subprocess.Popen(
            self._command, stdin=subprocess.PIPE,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    def write(self, frames: np.ndarray) -> None:
        self._proc.stdin.write(frames.tobytes())

    def close(self) -> None:
        if self._proc is not None:
            self._proc.stdin.close()
            self._proc.wait()
            self._proc = None


class SounddeviceBackend:
    """Callback-driven output via the `sounddevice` PortAudio binding
    (install with the `playback` extra). Unlike the push backends, this one
    owns the clock: the audio callback pulls from the decoder, exactly like
    the reference's render callbacks."""

    def __init__(self):
        import sounddevice  # noqa: F401  (fail fast if missing)

    @classmethod
    def available(cls) -> bool:
        try:
            import sounddevice  # noqa: F401

            return True
        except Exception:
            return False

    def play_stream(self, stream: StreamingDecoder,
                    chunk_frames: int = _CHUNK_FRAMES) -> None:
        import time

        import sounddevice as sd

        bps = stream.header.bits_per_sample

        def callback(outdata, frames, _time, _status):
            chunk = stream.read(frames)
            pcm = _to_int16(chunk, bps)
            outdata[: pcm.shape[0]] = pcm
            if pcm.shape[0] < frames:
                outdata[pcm.shape[0]:] = 0
                raise sd.CallbackStop()

        with sd.OutputStream(
                samplerate=stream.header.sampling_rate,
                channels=stream.num_channels, dtype="int16",
                blocksize=chunk_frames, callback=callback):
            while not stream.exhausted:
                time.sleep(0.05)


class Player:
    """Drives a StreamingDecoder into a push backend chunk by chunk."""

    def __init__(self, stream: StreamingDecoder, backend):
        self.stream = stream
        self.backend = backend

    def run(self, chunk_frames: int = _CHUNK_FRAMES) -> int:
        """Renders the whole stream; returns frames delivered."""
        hdr = self.stream.header
        self.backend.open(hdr.sampling_rate, self.stream.num_channels)
        delivered = 0
        try:
            while True:
                chunk = self.stream.read(chunk_frames)
                if chunk.shape[1] == 0:
                    break
                self.backend.write(_to_int16(chunk, hdr.bits_per_sample))
                delivered += chunk.shape[1]
        finally:
            self.backend.close()
        return delivered


def pick_backend():
    if SounddeviceBackend.available():
        return SounddeviceBackend()
    if PipeBackend.available():
        return PipeBackend()
    raise RuntimeError(
        "no audio backend: install the `playback` extra (sounddevice) or an "
        "OS pipe player (aplay/paplay/pw-play); FileBackend renders offline")


def play_file(path: str, backend=None,
              config: Optional[DecoderConfig] = None) -> None:
    with open(path, "rb") as f:
        stream = StreamingDecoder(f.read(), config)
    backend = backend or pick_backend()
    if isinstance(backend, SounddeviceBackend):
        backend.play_stream(stream)
    else:
        Player(stream, backend).run()


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="linne_tpu_torch.player",
        description="Play (or render) a .lnn file")
    p.add_argument("input")
    p.add_argument("--render-to", metavar="WAV",
                   help="render to a 16-bit WAV instead of audio output")
    args = p.parse_args(argv)
    backend = FileBackend(args.render_to) if args.render_to else None
    play_file(args.input, backend=backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
