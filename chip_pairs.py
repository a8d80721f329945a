#!/usr/bin/env python3
"""Time the port on one CUDA card, to compare two checkouts of the
repository within one machine.

    python3 chip_pairs.py ROOT LABEL [REPS] [--exact | --kernel NAME]

Imports linne_tpu_torch from the checkout at ROOT, encodes the seeded
4 x 30 s stereo corpus of chip_smoke.py (preset 7, block 10240) with
TorchEncoder.encode_many and decodes it with TorchDecoder.decode_many, REPS
times (default 3) after one warm-up round, with the card synchronised
around each call, and checks every decode lossless. With --exact it also
times each exact_serial kernel over its calls in one preset-7 fit chunk
(512 row-terms; seeded inputs built here, so every checkout sees the same;
CUDA events, 5 runs of the chunk's calls) and
DeviceExactEncoder.encode_many on the corpus, REPS times after a warm-up,
each run's streams checked against the host oracle's
(ParallelExactEncoder). Prints one JSON line: {"label", "encode_s": [...],
"decode_s": [...], "seconds_of_audio", "card"}, with --exact also
"<kernel>_chunk_ms" (the 5 runs) for autocorr, levinson, abs_mean and
chain_predict, and "exact_s": [...]. With --kernel NAME (autocorr_serial,
levinson_serial, serial_abs_mean or chain_predict; --autocorr is
--kernel autocorr_serial) it times only that kernel: "<kernel>_chunk_ms",
"<kernel>_call_ms" (each call alone, [argument shapes, median ms of 7])
and "<kernel>_digest" (a hash of the chunk's outputs, equal for
checkouts that give the same bits). Run it for the two checkouts in
alternating turns (A B B A A B) in one call, so both see the same card
and host.
"""

from __future__ import annotations

import hashlib
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


def preset7_autocorr_calls():
    """(nseg, ns, nlags) of the 16 autocorr_serial calls of one preset-7
    fit chunk: 512 row-terms (128 rows x 4 ridge terms), layers 4, 128 and
    16 at every unit count, block 10240."""
    calls = []
    for order in (4, 128, 16):
        u = 1
        while u <= order:
            calls.append((512 * u, SPB // u, order // u + 1))
            u *= 2
    return calls


KERNELS = ("autocorr_serial", "levinson_serial", "serial_abs_mean",
           "chain_predict")
# the keys of a kernel's numbers in the JSON line
SHORT = {"autocorr_serial": "autocorr", "levinson_serial": "levinson",
         "serial_abs_mean": "abs_mean", "chain_predict": "chain_predict"}


def chunk_calls(torch, ES, name: str):
    """The argument tuples of a kernel's calls in one preset-7 fit chunk,
    on the card, built from 512 seeded noise-plus-tone rows of one block:
    autocorr_serial's 16 (segments, nlags) views of them; levinson_serial's
    16 (ac, order) from those autocorrelations (this checkout's
    autocorr_serial, held bit-equal to its plain version by its tests) with
    a ridge on r0; serial_abs_mean's [512, L, 10240] from 1 for L = 3, 8, 5
    unit levels and [512, 10240] from 0; chain_predict's 16 (rows, params
    [512, units, order / units]) with seeded taps."""
    rng = np.random.default_rng(8)
    t = np.arange(SPB)
    rows = (rng.normal(0, 0.05, (512, SPB))
            + 0.4 * np.sin(2 * np.pi * rng.uniform(0.01, 0.2, (512, 1)) * t))
    base = torch.from_numpy(rows).cuda()
    shapes = preset7_autocorr_calls()
    if name == "autocorr_serial":
        return [(base.reshape(nseg, ns), nlags) for nseg, ns, nlags in shapes]
    if name == "levinson_serial":
        calls = []
        for nseg, ns, nlags in shapes:
            ac = ES.autocorr_serial(base.reshape(nseg, ns), nlags)
            ac[:, 0] *= 1.0 + 1e-3
            calls.append((ac, nlags - 1))
        return calls
    if name == "serial_abs_mean":
        calls = []
        for levels in (3, 8, 5):
            scale = torch.linspace(0.5, 1.5, levels, dtype=torch.float64,
                                   device="cuda")
            calls.append(((base[:, None, :] * scale[:, None]).contiguous(),
                          1, SPB))
        return calls + [(base, 0, SPB)]
    calls = []
    for nseg, ns, nlags in shapes:
        units = nseg // 512
        prm = rng.normal(0, 0.4 / (nlags - 1), (512, units, nlags - 1))
        calls.append((base, torch.from_numpy(prm).cuda()))
    return calls


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def chunk_ms(torch, ES, name: str, runs: int = 5):
    """CUDA-event milliseconds of a kernel's calls in one chunk, once per
    run; device time (the calls are enqueued while the card is still
    busy)."""
    calls = chunk_calls(torch, ES, name)
    kernel = getattr(ES, name)
    for args in calls:  # warm-up: builds and loads the kernel
        kernel(*args)
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # the calls queue behind a ~5 ms spin of the card: device time only
        torch.cuda._sleep(10_000_000)
        start.record()
        for args in calls:
            kernel(*args)
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out


def call_ms(torch, ES, name: str, runs: int = 7):
    """Each call of the chunk alone: [argument shapes, median CUDA-event
    ms of runs, each queued behind a ~1 ms spin], and a hash of the
    outputs."""
    digest = hashlib.sha256()
    kernel = getattr(ES, name)
    out = []
    for args in chunk_calls(torch, ES, name):
        for o in _outputs(kernel(*args)):
            digest.update(o.cpu().numpy().tobytes())
        ms = []
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            start.record()
            kernel(*args)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        shape = [list(a.shape) if isinstance(a, torch.Tensor) else a
                 for a in args]
        out.append([shape, float(np.median(ms))])
    return out, digest.hexdigest()[:16]


def kernel_times(torch, name: str) -> dict:
    """A kernel's chunk (5 runs), each call alone and the output hash."""
    from linne_tpu_torch.ops import exact_serial as ES

    short = SHORT[name]
    times = {f"{short}_chunk_ms": chunk_ms(torch, ES, name)}
    times[f"{short}_call_ms"], times[f"{short}_digest"] = call_ms(
        torch, ES, name)
    return times


def exact_runs(torch, param, chans, lengths, reps: int):
    """Wall seconds of DeviceExactEncoder.encode_many on the corpus, reps
    times after a warm-up, each run's streams equal to the host oracle's."""
    from linne_tpu_torch.exact.device_encoder import DeviceExactEncoder
    from linne_tpu_torch.exact.parallel_encoder import ParallelExactEncoder

    host = ParallelExactEncoder()
    host.set_encode_parameter(param)
    want = host.encode_many(chans, lengths)
    times = []
    for rep in range(reps + 1):  # round 0 warms up
        enc = DeviceExactEncoder(device="cuda")
        enc.set_encode_parameter(param)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = enc.encode_many(chans, lengths)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if got != want:
            raise SystemExit("chip_pairs: exact-device streams differ from "
                             "the host oracle's")
        if rep:
            times.append(wall)
    return times


def corpus_runs(torch, label: str, reps: int, exact: bool) -> dict:
    """The corpus encode and decode, reps times after a warm-up round,
    every decode lossless; with exact also the autocorr chunk and the
    exact-device encode."""
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
    if exact:
        from linne_tpu_torch.ops import exact_serial as ES

        for name in KERNELS:
            times[f"{SHORT[name]}_chunk_ms"] = chunk_ms(torch, ES, name)
        times["exact_s"] = exact_runs(torch, param, chans, lengths, reps)
    times["seconds_of_audio"] = sum(lengths) / RATE
    return times


def main() -> int:
    argv = sys.argv[1:]
    kernel = None
    if "--kernel" in argv:
        i = argv.index("--kernel")
        kernel = argv[i + 1]
        del argv[i:i + 2]
    if "--autocorr" in argv:  # the older spelling of --kernel autocorr_serial
        argv.remove("--autocorr")
        kernel = "autocorr_serial"
    if kernel is not None and kernel not in KERNELS:
        raise SystemExit(f"chip_pairs: --kernel takes one of {KERNELS}")
    exact = "--exact" in argv
    args = [a for a in argv if a != "--exact"]
    root = pathlib.Path(args[0]).resolve()
    label = args[1]
    reps = int(args[2]) if len(args) > 2 else 3
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_pairs: this script needs a CUDA card")
    if kernel is not None:
        times = kernel_times(torch, kernel)
    else:
        times = corpus_runs(torch, label, reps, exact)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps({"label": label, **times, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
