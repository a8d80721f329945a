#!/usr/bin/env python3
"""Time the port's plain -e corpus encode and pooled decode on one CUDA
card, to compare two checkouts of the repository within one machine.

    python3 chip_pairs.py ROOT LABEL [REPS]

Imports linne_tpu_torch from the checkout at ROOT, encodes the seeded
4 x 30 s stereo corpus of chip_smoke.py (preset 7, block 10240) with
TorchEncoder.encode_many and decodes it with TorchDecoder.decode_many, REPS
times (default 3) after one warm-up round, with the card synchronised
around each call, and checks every decode lossless. Prints one JSON line:
{"label", "encode_s": [...], "decode_s": [...], "seconds_of_audio",
"card"}. Run it for the two checkouts in alternating turns (A B B A A B)
in one call, so both see the same card and host.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np

RATE = 44100
SPB = 10240


def make_track(seconds: float, seed: int) -> np.ndarray:
    """Stereo 16-bit audio-like material: detuned partials plus a filtered
    noise floor (the recipe of bench.py:make_signal), seeded per track;
    chip_smoke.py's corpus too."""
    n = int(seconds * RATE)
    rng = np.random.default_rng(seed)
    t = np.arange(n) / RATE
    base = 110.0 * (1.0 + 0.25 * (seed % 4))
    left = np.zeros(n)
    right = np.zeros(n)
    for k in range(1, 9):
        amp = 9000.0 / k
        left += amp * np.sin(2 * np.pi * base * k * t + 0.1 * k)
        right += amp * np.sin(2 * np.pi * (base * k + 0.5) * t)
    noise = np.convolve(rng.normal(0, 1, n + 64), np.exp(-np.arange(32) / 8.0),
                        mode="same")[:n]
    left += 120 * noise
    right += 120 * rng.normal(0, 1, n)
    s = np.stack([left, right])
    return np.clip(np.round(s * 0.6), -32768, 32767).astype(np.int32)


def main() -> int:
    root = pathlib.Path(sys.argv[1]).resolve()
    label = sys.argv[2]
    reps = int(sys.argv[3]) if len(sys.argv) > 3 else 3
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_pairs: this script needs a CUDA card")
    from linne_tpu_torch.codec.encoder import TorchEncoder
    from linne_tpu_torch.codec.params import EncodeParameter
    from linne_tpu_torch.codec.torch_decoder import TorchDecoder

    param = EncodeParameter(
        num_channels=2, bits_per_sample=16, sampling_rate=RATE,
        num_samples_per_block=SPB, preset=7, ch_process_method=1)
    tracks = [make_track(30.0, seed) for seed in range(4)]
    chans = [[t[0], t[1]] for t in tracks]
    lengths = [t.shape[1] for t in tracks]
    times = {"encode_s": [], "decode_s": []}
    for rep in range(reps + 1):  # round 0 warms up
        enc = TorchEncoder(device="cuda")
        enc.set_encode_parameter(param)
        dec = TorchDecoder(device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        datas = enc.encode_many(chans, lengths)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        outs = dec.decode_many(datas)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for sig, out in zip(tracks, outs):
            if not np.array_equal(np.stack(out), sig):
                raise SystemExit(f"chip_pairs: {label} decode not lossless")
        if rep:
            times["encode_s"].append(t1 - t0)
            times["decode_s"].append(t2 - t1)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps({"label": label, **times,
                      "seconds_of_audio": sum(lengths) / RATE,
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
