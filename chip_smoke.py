#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. require a CUDA card; print its name and power limit (nvidia-smi);
  2. build the synthesis kernel from linne_tpu_torch/csrc/synthesis.cu;
  3. kernel: compare the kernel with its plain torch version on the card,
     bit for bit, at the edge shapes of its design (taps per unit 1..128
     around the 32-lane chunk, rows shorter than a chunk, ragged chunks, a
     row count that is not a multiple of the warps per block), and time
     both at the layer-1 group of a 60 s stereo track, beside the bound;
  4. main path: TorchEncoder.encode_many on a seeded 4 x 30 s stereo corpus
     at preset 7, then TorchDecoder.decode_many, both on the card; every
     stream must decode losslessly (also under the host Decoder) and the
     decode must have launched the kernel;
  5. decode groups: every (rows, ns, npu) launch of that decode, recorded
     in a second decode, checked bit for bit against the plain version and
     timed (CUDA events) beside its bound; then one decode under
     torch.profiler for the device-time breakdown;
  6. CLI: `python -m linne_tpu_torch.cli -e -m 7` on a 10 s WAV;
  7. cross-device: one 10 s track encoded on the CPU and on the card.
The second-to-last line is the kernel report (JSON), the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from linne_tpu_torch.codec.decoder import Decoder
from linne_tpu_torch.codec import torch_decoder
from linne_tpu_torch.codec.encoder import TorchEncoder
from linne_tpu_torch.codec.params import EncodeParameter
from linne_tpu_torch.codec.torch_decoder import TorchDecoder
from linne_tpu_torch.constants import CH_PROCESS_MS
from linne_tpu_torch.io.wav import write_wav
from linne_tpu_torch.ops import _kernels
from linne_tpu_torch.ops import synthesis as S

ROOT = pathlib.Path(__file__).resolve().parent
RATE = 44100
SPB = 10240
PRESET = 7

# H100 SXM rates for the kernel's bound: int32 multiply-add issue
# (64 IMAD/clk/SM x 132 SMs x 1.98 GHz) and HBM3 bandwidth
IMAD_PER_S = 64 * 132 * 1.98e9
HBM_BYTES_PER_S = 3.35e12


def make_track(seconds: float, seed: int) -> np.ndarray:
    """Stereo 16-bit audio-like material: detuned partials plus a filtered
    noise floor (the recipe of bench.py:make_signal), seeded per track."""
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


def param() -> EncodeParameter:
    return EncodeParameter(
        num_channels=2, bits_per_sample=16, sampling_rate=RATE,
        num_samples_per_block=SPB, preset=PRESET,
        ch_process_method=CH_PROCESS_MS)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke failed: {what}")


def synth_inputs(rows, ns, npu, seed, device="cuda"):
    rng = np.random.default_rng(seed)
    x = rng.integers(-30000, 30000, (rows, ns)).astype(np.int32)
    # coefficients in +-2^14 make the int32 accumulator wrap
    c = rng.integers(-(1 << 14), 1 << 14, (rows, npu)).astype(np.int32)
    rs = rng.integers(8, 15, rows).astype(np.int32)
    rs[::5] = 0  # the corrupt-stream guard: no rounding offset, no shift
    return tuple(torch.from_numpy(a).to(device) for a in (x, c, rs))


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card, CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def synth_bound(rows: int, ns: int, npu: int):
    """(ms, "operations" | "bytes"): the least time the card needs for one
    synthesize_rows call, the larger of its multiply-adds over the IMAD
    issue rate and its bytes (x, coefs, rshift read once, y written once)
    over the memory rate. Rows with ns <= npu are copies: no MACs."""
    macs = rows * max(ns - npu, 0) * npu
    nbytes = 4 * (2 * rows * ns + rows * npu + rows)
    t_ops, t_bytes = macs / IMAD_PER_S, nbytes / HBM_BYTES_PER_S
    if t_ops >= t_bytes:
        return 1e3 * t_ops, "operations"
    return 1e3 * t_bytes, "bytes"


def check_kernel(x, c, rs, what) -> int:
    """Kernel against the plain version on the same inputs; returns the
    max abs difference (0, or the script fails)."""
    got = S.synthesize_rows(x, c, rs)
    torch.cuda.synchronize()
    want = S.synthesize_rows_ref(x, c, rs)
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    require(torch.equal(got, want),
            f"kernel != plain version at {what} (max err {err})")
    return err


def kernel_phase() -> dict:
    max_err = 0
    # the shapes of tests/test_tpu_kernels.py, a row count that is not a
    # multiple of the block, one tap, and rows with ns <= npu
    shapes = [(4, 2048, 32), (130, 1024, 8), (64, 2560, 128),
              (8, 10240, 128), (45, 777, 1), (16, 64, 64), (9, 16, 128)]
    # the design's edges: taps around the 32-lane chunk, rows shorter than
    # a chunk, ragged last chunks; 13 rows is not a multiple of the 4
    # warps per block
    for npu in (1, 2, 4, 16, 31, 32, 33, 64, 127, 128):
        shapes += [(13, ns, npu) for ns in sorted({npu + 1, 33, 777, 10240})]
    for rows, ns, npu in shapes:
        x, c, rs = synth_inputs(rows, ns, npu, rows + ns + npu)
        max_err = max(max_err, check_kernel(x, c, rs, (rows, ns, npu)))
    print(f"kernel bit-equal to synthesize_rows_ref at {len(shapes)} shapes")

    # layer-1 u=1 group of one 60 s stereo track: 258 blocks x 2 channels
    x, c, rs = synth_inputs(516, 10240, 128, 1)
    kernel_ms = cuda_ms(lambda: S.synthesize_rows(x, c, rs), reps=20)
    plain_ms = cuda_ms(lambda: S.synthesize_rows_ref(x, c, rs), reps=2)
    max_err = max(max_err, check_kernel(x, c, rs, (516, 10240, 128)))
    bound_ms, bound_by = synth_bound(516, 10240, 128)
    print(f"synthesize_rows (516, 10240, 128): kernel {kernel_ms:.4f} ms, "
          f"plain torch {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}), kernel at {100 * bound_ms / kernel_ms:.1f} % of "
          "the bound")

    # first-minimum ties, which ridge and Rice-order selection rely on
    loss = torch.tensor([[3.0, 1.0], [1.0, 1.0], [1.0, 0.5]], device="cuda")
    require(torch.argmin(loss, dim=0).tolist() == [1, 2],
            "torch.argmin on the card does not take the first minimum")
    return {"max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def lossless(sig: np.ndarray, decoded) -> bool:
    return all(np.array_equal(decoded[ch], sig[ch])
               for ch in range(sig.shape[0]))


def main_path_phase():
    tracks = [make_track(30.0, seed) for seed in range(4)]
    lengths = [t.shape[1] for t in tracks]
    seconds = sum(lengths) / RATE
    # warm-up: CUDA context, cuFFT plans, pinned-memory pool
    warm = make_track(2 * SPB / RATE, 99)
    enc = TorchEncoder(device="cuda")
    enc.set_encode_parameter(param())
    TorchDecoder(device="cuda").decode_many(
        enc.encode_many([[warm[0], warm[1]]], [warm.shape[1]]))
    torch.cuda.synchronize()

    enc = TorchEncoder(device="cuda")
    enc.set_encode_parameter(param())
    dec = TorchDecoder(device="cuda")
    S.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    datas = enc.encode_many([[t[0], t[1]] for t in tracks], lengths)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    decoded = dec.decode_many(datas)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = S.KERNEL_LAUNCHES

    require(launches > 0, "decode_many did not launch the synthesis kernel")
    for sig, data, out in zip(tracks, datas, decoded):
        require(lossless(sig, out), "TorchDecoder output is not lossless")
        require(lossless(sig, Decoder().decode_whole(data)),
                "host Decoder output of the port's stream is not lossless")
    in_bytes = sum(lengths) * 2 * 2
    out_bytes = sum(len(d) for d in datas)
    print(f"main path: {len(tracks)} x 30 s stereo, preset {PRESET}, "
          f"block {SPB}: encode {t1 - t0:.3f} s "
          f"({seconds / (t1 - t0):.1f}x realtime), decode {t2 - t1:.3f} s "
          f"({seconds / (t2 - t1):.1f}x realtime), "
          f"size {100.0 * out_bytes / in_bytes:.3f} % of PCM, "
          f"kernel launches {launches}")
    return launches, datas


def decode_groups_phase(datas) -> int:
    """Record every synthesize_rows call of one corpus decode, then check
    each against the plain version and time it alone. Returns the max abs
    difference."""
    calls = []
    real = torch_decoder.synthesize_rows

    def recording(x, c, rs):
        calls.append((x.clone(), c.clone(), rs.clone()))
        return real(x, c, rs)

    torch_decoder.synthesize_rows = recording
    try:
        TorchDecoder(device="cuda").decode_many(datas)
    finally:
        torch_decoder.synthesize_rows = real
    torch.cuda.synchronize()
    max_err = 0
    total_ms = total_bound = 0.0
    for x, c, rs in calls:
        (rows, ns), npu = x.shape, c.shape[1]
        max_err = max(max_err, check_kernel(x, c, rs, (rows, ns, npu)))
        ms = cuda_ms(lambda: S.synthesize_rows(x, c, rs), reps=10)
        bound_ms, bound_by = synth_bound(rows, ns, npu)
        total_ms += ms
        total_bound += bound_ms
        print(f"decode group (rows {rows}, ns {ns}, npu {npu}): kernel "
              f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    print(f"decode groups: {len(calls)} launches, bit-equal to the plain "
          f"version, kernel {total_ms:.4f} ms in all, bound "
          f"{total_bound:.4f} ms")
    return max_err


def decode_profile_phase(datas) -> None:
    """Device-time breakdown of one warm corpus decode (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dec = TorchDecoder(device="cuda")
    dec.decode_many(datas)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dec.decode_many(datas)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernel_us = copy_us = other_us = 0.0
    for ev in prof.key_averages():
        # device-side events only: a host op's device time repeats theirs
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = ev.self_device_time_total
        if "synth_rows_kernel" in ev.key:
            kernel_us += dev_us
        elif "Memcpy" in ev.key or "memcpy" in ev.key:
            copy_us += dev_us
        else:
            other_us += dev_us
    device_ms = (kernel_us + copy_us + other_us) / 1e3
    if device_ms == 0:
        print("decode profile: no device time in the trace (not measured)")
        return
    print(f"decode profile: wall {wall_ms:.1f} ms (profiled), device "
          f"{device_ms:.3f} ms ({100 * device_ms / wall_ms:.1f} % busy): "
          f"synth_rows_kernel {kernel_us / 1e3:.3f} ms, copies "
          f"{copy_us / 1e3:.3f} ms, other {other_us / 1e3:.3f} ms")


def cli_phase(tmp: pathlib.Path) -> None:
    sig = make_track(10.0, 7)
    wav = tmp / "in.wav"
    lnn = tmp / "out.lnn"
    write_wav(str(wav), sig, RATE, 16)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "linne_tpu_torch.cli", "-e", "-m", str(PRESET),
         str(wav), str(lnn)], cwd=str(ROOT), env=env, capture_output=True,
        text=True, timeout=600)
    require(proc.returncode == 0, f"CLI encode failed:\n{proc.stderr}")
    data = lnn.read_bytes()
    require(lossless(sig, Decoder().decode_whole(data)),
            "CLI stream is not lossless")
    print(f"cli: -e -m {PRESET} on 10 s stereo -> {len(data)} bytes, "
          "lossless")


def cross_device_phase() -> None:
    sig = make_track(10.0, 11)
    n = sig.shape[1]
    streams = {}
    for device in ("cpu", "cuda"):
        enc = TorchEncoder(device=device)
        enc.set_encode_parameter(param())
        streams[device] = enc.encode_whole([sig[0], sig[1]], n)
        require(lossless(sig, Decoder().decode_whole(streams[device])),
                f"{device} stream is not lossless")
    a, b = streams["cpu"], streams["cuda"]
    same = sum(x == y for x, y in zip(a, b))
    require(abs(len(a) - len(b)) <= 0.001 * len(a),
            f"cpu and cuda sizes differ by more than 0.1%: {len(a)} vs {len(b)}")
    print(f"cross-device: cpu {len(a)} bytes, cuda {len(b)} bytes, "
          f"identical streams: {a == b}, bytes equal at "
          f"{same} of {max(len(a), len(b))} positions")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(f"card: {smi.stdout.strip()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _kernels.build("synthesis")
    S._kernel_fn()
    print(f"built synthesis kernel in {time.perf_counter() - t0:.2f} s")

    kernel = kernel_phase()
    launches, datas = main_path_phase()
    group_err = decode_groups_phase(datas)
    decode_profile_phase(datas)
    with tempfile.TemporaryDirectory() as tmp:
        cli_phase(pathlib.Path(tmp))
    cross_device_phase()

    print(json.dumps({"kernels": [{
        "name": "synthesize_rows",
        "route": "cuda",
        "source": "linne_tpu_torch/csrc/synthesis.cu",
        "replaces": "linne_tpu/ops/synthesis.py:46",
        "launches": launches,
        "max_abs_err": max(kernel["max_abs_err"], group_err),
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"],
        "bound_by": kernel["bound_by"],
        "library_ms": None,  # no PyTorch call computes this recurrence
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
