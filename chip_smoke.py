#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. require a CUDA card; print its name and power limit (nvidia-smi);
  2. build the kernels from linne_tpu_torch/csrc/synthesis.cu and
     exact_serial.cu (one nvcc each, started together);
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
  6. CLI: `python -m linne_tpu_torch.cli -e -m 7`, `-e -m 7 -a 2` and
     `-e -m 7 -l` on a 10 s WAV (each lossless), and `-e --exact-device
     -m 7` against `-e --exact` on it, byte for byte;
  7. cross-device: one 10 s track encoded on the CPU and on the card;
  8. exact-device kernels: each serial float64 kernel of exact_serial.cu
     against its plain torch version on the card, bit for bit, at the edge
     shapes of its design (odd and even lengths, lags 1..129, orders 1..128,
     a zero-signal row, row counts that are not a multiple of the block);
  9. exact-device path: DeviceExactEncoder.encode_many on the corpus of
     phase 4; every stream byte-identical to the host oracle's
     (ParallelExactEncoder, and ExactEncoder on the first track) and
     lossless; wall time, realtime multiples, guard counters, launches and
     a torch.profiler split of device time against wall time;
 10. exact-device calls: the corpus's device fit alone (no framing), timed,
     with the host share of the quantizer's tap loop and its share of the
     torch ops one chunk dispatches; then every kernel call of one 128-row fit chunk of that corpus,
     recorded, checked bit for bit against the plain version and timed
     beside its bound and chain bound;
 11. -a 2 (preset 7) and -l (preset 1) through DeviceExactEncoder on a
     3-block + tail track, byte-identical to ExactEncoder;
 12. -a 2 and -l on the batched path: TorchEncoder.encode_many on the
     corpus of phase 4 with each, then TorchDecoder.decode_many (and the
     host Decoder): lossless, the kernel launched; wall time and realtime
     multiples beside phase 4's plain multiple, the training's iterations
     per batch and the AF and training stages' share of the wall (CUDA
     events); then one 10 s track with -a 2 -l on the CPU port and on the
     card: both lossless, sizes within 0.1 %; the torch ops that one
     batch's AF stages and one training iteration dispatch, and device
     time against wall time of one 64-block batch with each flag;
 13. device list: every card when there are two or more, else ["cuda:0",
     "cuda:0"]; TorchEncoder(devices=...) on the corpus of phase 4 gives
     phase 4's streams, TorchDecoder(devices=...) decodes them losslessly
     with synthesize_rows launched on every shard, and
     DeviceExactEncoder(devices=...) gives the host oracle's streams with
     0 rows flagged; sharded_analyze equals the unsharded call bit for
     bit; one make_sharded_train_step step moves the params with a finite
     loss; each path's wall time and realtime multiple beside the
     one-device call's.
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
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from linne_tpu_torch.codec.decoder import Decoder
from linne_tpu_torch.codec import torch_decoder
from linne_tpu_torch.codec.encoder import TorchEncoder
from linne_tpu_torch.codec.params import EncodeParameter
from linne_tpu_torch.codec.torch_decoder import TorchDecoder
from linne_tpu_torch.constants import (
    CH_PROCESS_MS,
    LPC_COEF_BITWIDTH,
    TRAINING_LEARNING_RATE,
    TRAINING_LOSS_EPSILON,
)
from linne_tpu_torch.exact import device_encoder as DE
from linne_tpu_torch.exact.encoder import ExactEncoder
from linne_tpu_torch.exact.parallel_encoder import ParallelExactEncoder
from linne_tpu_torch.io.wav import write_wav
from linne_tpu_torch.ops import _kernels
from linne_tpu_torch.ops import afmethod
from linne_tpu_torch.ops import analysis as A
from linne_tpu_torch.ops import exact_device as ED
from linne_tpu_torch.ops import exact_serial as ES
from linne_tpu_torch.ops import synthesis as S
from linne_tpu_torch.ops import training
from linne_tpu_torch.parallel import mesh
from linne_tpu_torch.presets import PRESETS

ROOT = pathlib.Path(__file__).resolve().parent
RATE = 44100
SPB = 10240
PRESET = 7

# H100 SXM rates for the kernel's bound: int32 multiply-add issue
# (64 IMAD/clk/SM x 132 SMs x 1.98 GHz) and HBM3 bandwidth
IMAD_PER_S = 64 * 132 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
# FP64 issue: 64 operations/clk/SM on 132 SMs at the SM clock nvidia-smi
# reports (a multiply and an add count as two: the exact kernels do not
# contract them). The chain bound takes a dependent DADD as 8 cycles
# (reckoned, not measured on the card).
FP64_OPS_PER_CLK = 64 * 132
DADD_CYCLES = 8


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


def param(preset: int = PRESET, af: int = 0,
          learn: bool = False) -> EncodeParameter:
    return EncodeParameter(
        num_channels=2, bits_per_sample=16, sampling_rate=RATE,
        num_samples_per_block=SPB, preset=preset,
        ch_process_method=CH_PROCESS_MS, num_afmethod_iterations=af,
        enable_learning=learn)


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
    return launches, datas, seconds / (t1 - t0)


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
    for flags in (["-a", "2"], ["-l"]):
        out = tmp / "flags.lnn"
        proc = subprocess.run(
            [sys.executable, "-m", "linne_tpu_torch.cli", "-e", "-m",
             str(PRESET), *flags, str(wav), str(out)], cwd=str(ROOT),
            env=env, capture_output=True, text=True, timeout=600)
        require(proc.returncode == 0,
                f"CLI -e {' '.join(flags)} failed:\n{proc.stderr}")
        data = out.read_bytes()
        require(lossless(sig, Decoder().decode_whole(data)),
                f"CLI -e {' '.join(flags)} stream is not lossless")
        print(f"cli: -e -m {PRESET} {' '.join(flags)} -> {len(data)} "
              "bytes, lossless")
    streams = {}
    for flag in ("--exact", "--exact-device"):
        out = tmp / f"{flag.strip('-')}.lnn"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "linne_tpu_torch.cli", "-e", flag, "-m",
             str(PRESET), str(wav), str(out)], cwd=str(ROOT), env=env,
            capture_output=True, text=True, timeout=600)
        require(proc.returncode == 0,
                f"CLI {flag} encode failed:\n{proc.stderr}")
        streams[flag] = out.read_bytes()
        print(f"cli: -e {flag} -m {PRESET} -> {len(streams[flag])} bytes "
              f"in {time.perf_counter() - t0:.2f} s (process included)")
    require(streams["--exact-device"] == streams["--exact"],
            "CLI --exact-device bytes differ from --exact")
    require(lossless(sig, Decoder().decode_whole(streams["--exact"])),
            "CLI --exact stream is not lossless")
    print("cli: --exact-device bytes identical to --exact")


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


# -- the byte-exact device encoder -------------------------------------------


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int64)


def check_exact(name: str, got, want, what) -> float:
    """Kernel outputs against the plain version's, bit for bit (float64 as
    int64 bits); returns the max abs difference (0, or the script fails)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for g, w in zip(got, want):
        if g.dtype == torch.float64:
            if g.numel():
                err = max(err, float((g - w).abs().max()))
            same = torch.equal(bits(g), bits(w))
        else:
            same = torch.equal(g, w)
        require(same, f"{name} != plain version at {what} (max err {err})")
    return err


def seg_inputs(rows, units, ns, seed) -> torch.Tensor:
    """Noise plus a tone per segment, on the card; row 0 is all zero."""
    rng = np.random.default_rng(seed)
    t = np.arange(ns)
    seg = (rng.normal(0, 0.05, (rows, units, ns))
           + 0.4 * np.sin(2 * np.pi * rng.uniform(0.01, 0.2,
                                                  (rows, units, 1)) * t))
    seg[0] = 0.0
    return torch.from_numpy(seg).cuda()


_PLAIN = {"autocorr_serial": ES.autocorr_serial_ref,
          "levinson_serial": ES.levinson_serial_ref,
          "serial_abs_mean": ES.serial_abs_mean_ref,
          "chain_predict": ES.chain_predict_ref}


def exact_kernel_phase() -> dict:
    """Each exact_serial kernel against its plain version at the edges of
    its design. Returns the max abs difference per kernel."""
    err = dict.fromkeys(ES.KERNELS, 0.0)
    cases = []
    # 13 rows is not a multiple of the kernels' 128-thread blocks
    for rows, units, ns, nlags in [(13, 1, 10240, 129), (5, 2, 81, 9),
                                   (3, 4, 64, 1), (7, 3, 130, 129),
                                   (2, 1, 16, 16), (13, 128, 80, 2)]:
        cases.append(("autocorr_serial",
                      (seg_inputs(rows, units, ns, rows + ns), nlags)))
    for order in (1, 2, 31, 32, 33, 64, 128):
        seg = seg_inputs(13, 1, 4 * order + 16, order)
        seg[3] *= 1e-5
        ac = ES.autocorr_serial_ref(seg, order + 1)[:, 0].contiguous()
        ac[:, 0] *= 1.0 + 1.0 / 512.0
        cases.append(("levinson_serial", (ac, order)))
    for rows, n, start in [(13 * 8, 10240, 1), (3, 77, 0), (130, 2048, 0)]:
        x = seg_inputs(rows, 1, n, n)[:, 0].contiguous()
        cases.append(("serial_abs_mean", (x, start, n)))
    for rows, n, units, npu in [(13, 10240, 1, 128), (5, 384, 4, 8),
                                (3, 2048, 128, 1), (7, 300, 3, 5)]:
        x = seg_inputs(rows, 1, n, n + npu)[:, 0].contiguous()
        rng = np.random.default_rng(units + npu)
        prm = torch.from_numpy(rng.normal(0, 0.4, (rows, units, npu))).cuda()
        cases.append(("chain_predict", (x, prm)))
    for name, args in cases:
        got = getattr(ES, name)(*args)
        torch.cuda.synchronize()
        shape = tuple(tuple(a.shape) if isinstance(a, torch.Tensor) else a
                      for a in args)
        err[name] = max(err[name],
                        check_exact(name, got, _PLAIN[name](*args), shape))
    first_levinson = next(a for n, a in cases if n == "levinson_serial")
    zero_case = ES.levinson_serial(*first_levinson)[2]
    require(bool(zero_case[0]) and not bool(zero_case[1]),
            "the zero-signal row did not take the early-out")
    print(f"exact_serial kernels bit-equal to their plain versions at "
          f"{len(cases)} edge shapes")
    return err


def corpus():
    return [make_track(30.0, seed) for seed in range(4)]


def exact_encode_phase(tracks):
    """DeviceExactEncoder.encode_many on the corpus against the host
    oracle. Returns the launch counts of that run and the oracle's
    streams."""
    lengths = [t.shape[1] for t in tracks]
    seconds = sum(lengths) / RATE
    chans = [[t[0], t[1]] for t in tracks]
    warm = make_track(2 * SPB / RATE, 98)
    enc = DE.DeviceExactEncoder(device="cuda")
    enc.set_encode_parameter(param())
    enc.encode_many([[warm[0], warm[1]]], [warm.shape[1]])
    torch.cuda.synchronize()

    enc = DE.DeviceExactEncoder(device="cuda")
    enc.set_encode_parameter(param())
    for k in ES.KERNELS:
        ES.KERNEL_LAUNCHES[k] = 0
    t0 = time.perf_counter()
    datas = enc.encode_many(chans, lengths)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ES.KERNEL_LAUNCHES)
    for k in ES.KERNELS:
        require(launches[k] > 0, f"the exact-device encode did not launch "
                                 f"{k}")
    print(f"exact-device: {len(tracks)} tracks, {seconds:.1f} s stereo, "
          f"preset {PRESET}: "
          f"encode_many {wall:.3f} s ({seconds / wall:.1f}x realtime), "
          f"guard rows {enc.guard_rows_flagged} flagged of "
          f"{enc.guard_rows_total}, decisions flagged "
          f"{enc.guard_decisions_flagged}, launches {launches}")

    threads = os.cpu_count() or 1
    host = ParallelExactEncoder(num_threads=threads)
    host.set_encode_parameter(param())
    t0 = time.perf_counter()
    refs = host.encode_many(chans, lengths)
    par_wall = time.perf_counter() - t0
    single = ExactEncoder()
    single.set_encode_parameter(param())
    t0 = time.perf_counter()
    ref0 = single.encode_whole(chans[0], lengths[0])
    one_wall = time.perf_counter() - t0
    require(ref0 == refs[0], "ExactEncoder and ParallelExactEncoder differ")
    for i, (sig, data, ref) in enumerate(zip(tracks, datas, refs)):
        require(data == ref, f"exact-device stream {i} differs from the "
                             "host oracle's")
        require(lossless(sig, Decoder().decode_whole(data)),
                f"exact-device stream {i} is not lossless")
    print(f"exact-device: all {len(tracks)} streams byte-identical to the "
          f"host oracle and lossless; host oracle ParallelExactEncoder "
          f"({threads} threads) {par_wall:.3f} s "
          f"({seconds / par_wall:.1f}x realtime), ExactEncoder on track 0 "
          f"{one_wall:.3f} s ({lengths[0] / RATE / one_wall:.1f}x realtime)")
    exact_profile_phase(chans, lengths, wall)
    return launches, refs


def exact_profile_phase(chans, lengths, unprofiled_wall) -> None:
    """Device time against wall time of one warm corpus encode."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    enc = DE.DeviceExactEncoder(device="cuda")
    enc.set_encode_parameter(param())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        enc.encode_many(chans, lengths)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    names = {"autocorr_kernel": 0.0, "levinson_kernel": 0.0,
             "abs_mean_kernel": 0.0, "chain_predict_kernel": 0.0}
    copy_us = other_us = 0.0
    n_other = 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = ev.self_device_time_total
        hit = [k for k in names if k in ev.key]
        if hit:
            names[hit[0]] += dev_us
        elif "Memcpy" in ev.key or "memcpy" in ev.key:
            copy_us += dev_us
        else:
            other_us += dev_us
            n_other += ev.count
    device_ms = (sum(names.values()) + copy_us + other_us) / 1e3
    if device_ms == 0:
        print("exact-device profile: no device time in the trace "
              "(not measured)")
        return
    split = ", ".join(f"{k} {v / 1e3:.3f} ms" for k, v in names.items())
    print(f"exact-device profile: wall {wall_ms:.1f} ms profiled "
          f"({1e3 * unprofiled_wall:.1f} ms unprofiled), device "
          f"{device_ms:.3f} ms ({100 * device_ms / wall_ms:.1f} % busy): "
          f"{split}, copies {copy_us / 1e3:.3f} ms, other {other_us / 1e3:.3f}"
          f" ms in {n_other} launches")


def exact_bound(name: str, args, clock_hz: float):
    """(bound ms, "operations" | "bytes", chain ms) of one kernel call:
    FP64 operations over the issue rate against bytes over the memory
    rate, and the call's longest dependent chain of additions at
    DADD_CYCLES each."""
    if name == "autocorr_serial":
        seg, nlags = args
        ns = seg.shape[-1]
        nseg = seg.numel() // ns
        pairs = nseg * sum(ns - lag for lag in range(nlags))
        ops, nbytes, chain = 2 * pairs, 8 * nseg * (ns + nlags), ns
    elif name == "levinson_serial":
        ac, order = args
        nseg = ac.numel() // (order + 1)
        per = 4 + sum(4 * k + 8 for k in range(1, order))
        ops = nseg * per
        nbytes = 8 * nseg * (3 * order + 1) + nseg
        chain = 2 + sum(k + 5 for k in range(1, order))
    elif name == "serial_abs_mean":
        rows, start, n = args
        nrows = rows.numel() // rows.shape[-1]
        ops, nbytes, chain = nrows * (n - start + 1), 8 * (rows.numel()
                                                           + nrows), n - start
    else:
        x, prm = args
        npu = prm.shape[-1]
        ops = 3 * x.numel() * npu
        nbytes = 8 * (3 * x.numel() + prm.numel())
        chain = npu
    t_ops = ops / (FP64_OPS_PER_CLK * clock_hz)
    t_bytes = nbytes / HBM_BYTES_PER_S
    chain_ms = 1e3 * chain * DADD_CYCLES / clock_hz
    if t_ops >= t_bytes:
        return 1e3 * t_ops, "operations", chain_ms
    return 1e3 * t_bytes, "bytes", chain_ms


def fast_version(name: str, args):
    """The fast graph's plain torch version of the same work (context for
    the missing library call: no PyTorch call sums in serial order)."""
    if name == "autocorr_serial":
        return ED._autocorr_fast(*args)
    if name == "levinson_serial":
        return ED._levinson_fast(*args)
    if name == "serial_abs_mean":
        return ED._serial_abs_mean(*args, strict=False)
    x, prm = args
    return ED._chain_predict(x, prm, prm.shape[1], strict=False)


class QuantizerTap:
    """Within its `with`, `exact_device._quantize_layer` (the error-feedback
    quantizer, a plain torch loop over taps) sums its host time into
    `seconds` and marks `inside` while it runs."""

    def __init__(self):
        self.seconds = 0.0
        self.inside = False
        self._real = ED._quantize_layer

    def _timed(self, *args):
        t0 = time.perf_counter()
        self.inside = True
        try:
            return self._real(*args)
        finally:
            self.inside = False
            self.seconds += time.perf_counter() - t0

    def __enter__(self):
        ED._quantize_layer = self._timed
        return self

    def __exit__(self, *exc):
        ED._quantize_layer = self._real


def count_ops(fn, *args, inside=lambda: False):
    """(ops, ops inside): the torch ops fn(*args) dispatches, views and
    allocations excluded (they launch nothing), and how many of them were
    dispatched while inside() held."""
    from torch.utils._python_dispatch import TorchDispatchMode

    counts = [0, 0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func._schema.name
            if not (func.is_view or "empty" in name
                    or name == "aten::_local_scalar_dense"):
                counts[0] += 1
                counts[1] += inside()
            return func(*args, **(kwargs or {}))

    with Count():
        fn(*args)
    return counts[0], counts[1]


def count_fit_ops(fit, x: torch.Tensor):
    """(ops, quantizer ops): the torch ops one fit call dispatches, views
    and allocations excluded (they launch nothing), and how many of them
    run inside the quantizer."""
    with QuantizerTap() as quant:
        return count_ops(fit, x, inside=lambda: quant.inside)


def exact_calls_phase(tracks, clock_hz: float) -> dict:
    """Record every exact_serial call of one 128-row fit chunk of the
    corpus (the main path's shapes), then check each against the plain
    version and time kernel, plain version and fast graph per call.
    Returns per kernel {max_abs_err, ms, plain_ms, bound_ms, bound_by,
    chain_ms, fast_ms, calls}, summed over the chunk's calls."""
    p = param()
    t0 = time.perf_counter()
    planes = []
    for t in tracks:
        for pos in range(0, t.shape[1] - SPB + 1, SPB):
            planes.append(DE.preemph_plane(p, [t[0][pos:pos + SPB],
                                               t[1][pos:pos + SPB]], SPB))
    all_rows = np.concatenate(planes)
    t1 = time.perf_counter()
    preset = PRESETS[PRESET]
    fit = ED.build_fit_fn(preset.layer_num_params, preset.ridge_terms, SPB,
                          16, LPC_COEF_BITWIDTH)

    # the corpus's device fit alone, without the framing: every chunk
    # (the last one padded, as the encoder pads it) enqueued, then waited for;
    # the host time inside the quantizer's tap loop is summed apart
    chunks = -(-all_rows.shape[0] // DE._CHUNK)
    padded = np.zeros((chunks * DE._CHUNK, SPB), np.int32)
    padded[:all_rows.shape[0]] = all_rows
    quant = QuantizerTap()
    torch.cuda.synchronize()
    with quant:
        t2 = time.perf_counter()
        for start in range(0, padded.shape[0], DE._CHUNK):
            fit(torch.from_numpy(padded[start:start + DE._CHUNK]).cuda())
        t3 = time.perf_counter()
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    print(f"exact-device fit alone: {all_rows.shape[0]} rows in {chunks} "
          f"chunks, planes (host) {t1 - t0:.3f} s, fit enqueued in "
          f"{t3 - t2:.3f} s, done {t4 - t2:.3f} s after the first launch; "
          f"host time in the quantizer {quant.seconds:.3f} s "
          f"({100 * quant.seconds / (t3 - t2):.1f} % of the enqueue)")

    rows = all_rows[:DE._CHUNK]
    ops, quant_ops = count_fit_ops(fit, torch.from_numpy(rows).cuda())
    print(f"exact-device fit dispatch: one {rows.shape[0]}-row chunk "
          f"dispatches {ops} torch ops (views and allocations excluded; the "
          f"exact_serial kernels are not torch ops), {quant_ops} of them in "
          f"the quantizer ({100 * quant_ops / ops:.1f} %)")
    calls = {k: [] for k in ES.KERNELS}
    real = {k: getattr(ES, k) for k in ES.KERNELS}

    def recorder(name):
        def rec(*args):
            calls[name].append(tuple(
                a.clone() if isinstance(a, torch.Tensor) else a
                for a in args))
            return real[name](*args)
        return rec

    for k in ES.KERNELS:
        setattr(ES, k, recorder(k))
    try:
        fit(torch.from_numpy(rows).cuda())
    finally:
        for k in ES.KERNELS:
            setattr(ES, k, real[k])
    torch.cuda.synchronize()

    out = {}
    for name in ES.KERNELS:
        r = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
             "bound_ms": 0.0, "chain_ms": 0.0, "fast_ms": 0.0,
             "calls": len(calls[name])}
        by = {"operations": 0.0, "bytes": 0.0}
        for args in calls[name]:
            kernel = getattr(ES, name)
            r["ms"] += cuda_ms(lambda: kernel(*args), reps=5)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            want = _PLAIN[name](*args)
            end.record()
            torch.cuda.synchronize()
            r["plain_ms"] += start.elapsed_time(end)
            shape = tuple(tuple(a.shape) if isinstance(a, torch.Tensor)
                          else a for a in args)
            r["max_abs_err"] = max(r["max_abs_err"], check_exact(
                name, kernel(*args), want, shape))
            r["fast_ms"] += cuda_ms(lambda: fast_version(name, args), reps=1)
            b_ms, b_by, c_ms = exact_bound(name, args, clock_hz)
            r["bound_ms"] += b_ms
            r["chain_ms"] += c_ms
            by[b_by] += b_ms
        r["bound_by"] = max(by, key=by.get)
        out[name] = r
        print(f"exact-device calls {name}: {r['calls']} calls in one "
              f"{rows.shape[0]}-row chunk, bit-equal; kernel "
              f"{r['ms']:.4f} ms, plain torch {r['plain_ms']:.3f} ms, fast "
              f"graph {r['fast_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), chain bound {r['chain_ms']:.4f} ms")
    return out


def exact_flags_phase() -> None:
    """-a 2 at preset 7 and -l at preset 1 through DeviceExactEncoder on a
    3-block + tail track, against ExactEncoder."""
    sig = make_track((3 * SPB + 2040) / RATE, 21)
    n = sig.shape[1]
    for preset, af, learn in ((PRESET, 2, False), (1, 0, True)):
        prm = param(preset, af, learn)
        host = ExactEncoder()
        host.set_encode_parameter(prm)
        t0 = time.perf_counter()
        ref = host.encode_whole([sig[0], sig[1]], n)
        t1 = time.perf_counter()
        enc = DE.DeviceExactEncoder(device="cuda")
        enc.set_encode_parameter(prm)
        got = enc.encode_whole([sig[0], sig[1]], n)
        t2 = time.perf_counter()
        flags = f"-m {preset}" + (f" -a {af}" if af else "") + (
            " -l" if learn else "")
        require(got == ref, f"exact-device {flags} differs from ExactEncoder")
        require(lossless(sig, Decoder().decode_whole(got)),
                f"exact-device {flags} stream is not lossless")
        print(f"exact-device {flags}: byte-identical to ExactEncoder "
              f"(device {t2 - t1:.3f} s, host {t1 - t0:.3f} s), guard rows "
              f"{enc.guard_rows_flagged} flagged of {enc.guard_rows_total}")


# -- -a and -l on the batched encoder ----------------------------------------


class StageTimes:
    """Within its `with`, every AF layer stage and training call of a
    TorchEncoder built inside it is bracketed by CUDA events, and each
    training call's iteration count is kept."""

    def __init__(self):
        self.af = []          # (start, end) events per AF layer-stage call
        self.train = []       # (start, end) events per training call
        self.iterations = []  # per training call (one per batch)
        self._real = (afmethod.make_af_layer_stage, training.make_train_fn)

    @staticmethod
    def _timed(fn, spans):
        def run(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            spans.append((start, end))
            return out
        return run

    def __enter__(self):
        make_stage, make_train = self._real

        def stage(*args):
            return self._timed(make_stage(*args), self.af)

        def train(*args):
            run = self._timed(make_train(*args), self.train)

            def counted(*targs):
                params, iterations = run(*targs)
                self.iterations.append(iterations)
                return params, iterations
            return counted

        afmethod.make_af_layer_stage = stage
        training.make_train_fn = train
        return self

    def __exit__(self, *exc):
        afmethod.make_af_layer_stage, training.make_train_fn = self._real

    @staticmethod
    def ms(spans) -> float:
        return sum(start.elapsed_time(end) for start, end in spans)


def learn_af_phase(tracks, plain_multiple: float) -> None:
    """-a 2 and -l through TorchEncoder.encode_many on the corpus of phase
    4, each decoded by TorchDecoder.decode_many with the launch count set
    to 0 just before the encode and read just after the decode."""
    lengths = [t.shape[1] for t in tracks]
    seconds = sum(lengths) / RATE
    chans = [[t[0], t[1]] for t in tracks]
    warm = make_track(2 * SPB / RATE, 97)
    for flags, af, learn in (("-a 2", 2, False), ("-l", 0, True)):
        # warm-up: cuSOLVER and autograd state, cuFFT plans
        enc = TorchEncoder(device="cuda")
        enc.set_encode_parameter(param(af=af, learn=learn))
        enc.encode_many([[warm[0], warm[1]]], [warm.shape[1]])
        torch.cuda.synchronize()

        dec = TorchDecoder(device="cuda")
        S.KERNEL_LAUNCHES = 0
        with StageTimes() as times:
            enc = TorchEncoder(device="cuda")
            enc.set_encode_parameter(param(af=af, learn=learn))
            t0 = time.perf_counter()
            datas = enc.encode_many(chans, lengths)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        decoded = dec.decode_many(datas)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = S.KERNEL_LAUNCHES
        require(launches > 0, f"decode_many of the {flags} streams did not "
                              "launch the synthesis kernel")
        for sig, data, out in zip(tracks, datas, decoded):
            require(lossless(sig, out),
                    f"TorchDecoder output of a {flags} stream is not "
                    "lossless")
            require(lossless(sig, Decoder().decode_whole(data)),
                    f"host Decoder output of a {flags} stream is not "
                    "lossless")
        wall_ms = 1e3 * (t1 - t0)
        af_ms, train_ms = times.ms(times.af), times.ms(times.train)
        in_bytes = sum(lengths) * 2 * 2
        out_bytes = sum(len(d) for d in datas)
        print(f"batched {flags}: {len(tracks)} x 30 s stereo, preset "
              f"{PRESET}: encode {t1 - t0:.3f} s ({seconds / (t1 - t0):.1f}x "
              f"realtime; plain -e {plain_multiple:.1f}x in phase 4), decode "
              f"{t2 - t1:.3f} s ({seconds / (t2 - t1):.1f}x realtime), size "
              f"{100.0 * out_bytes / in_bytes:.3f} % of PCM, kernel launches "
              f"{launches}; AF stages {af_ms:.1f} ms "
              f"({100 * af_ms / wall_ms:.1f} % of the wall), training "
              f"{train_ms:.1f} ms ({100 * train_ms / wall_ms:.1f} %), "
              f"training iterations per batch {times.iterations}")

    sig = make_track(10.0, 13)
    n = sig.shape[1]
    streams, secs = {}, {}
    for device in ("cpu", "cuda"):
        enc = TorchEncoder(device=device)
        enc.set_encode_parameter(param(af=2, learn=True))
        t0 = time.perf_counter()
        streams[device] = enc.encode_whole([sig[0], sig[1]], n)
        secs[device] = time.perf_counter() - t0
        require(lossless(sig, Decoder().decode_whole(streams[device])),
                f"-a 2 -l {device} stream is not lossless")
    a, b = streams["cpu"], streams["cuda"]
    require(abs(len(a) - len(b)) <= 0.001 * len(a),
            f"-a 2 -l: cpu and cuda sizes differ by more than 0.1%: "
            f"{len(a)} vs {len(b)}")
    print(f"cross-device -a 2 -l: cpu {len(a)} bytes in {secs['cpu']:.2f} s, "
          f"cuda {len(b)} bytes in {secs['cuda']:.2f} s, identical streams: "
          f"{a == b}")


def learn_af_dispatch_phase() -> None:
    """The torch ops the AF stages of one batch and one training iteration
    dispatch on the card (preset 7, -a 2), and device time against wall
    time of one 64-block batch encoded with -a 2 and with -l."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    preset = PRESETS[PRESET]
    orders = preset.layer_num_params
    units = [A.candidate_units(o, SPB) for o in orders]
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 0.1, (8, 2, SPB))).cuda()
    log2u = [torch.from_numpy(rng.choice([(u - 1).bit_length() for u in c],
                                         (8, 2)).astype(np.int32)).cuda()
             for c in units]
    ridge = torch.full((8, 2), 1.0 / 512.0, dtype=torch.float64,
                       device="cuda")
    af_ops = sum(count_ops(afmethod.make_af_layer_stage(o, units[li], 2),
                           x, log2u[li], ridge)[0]
                 for li, o in enumerate(orders))
    params = [torch.from_numpy(rng.normal(0, 0.05, (8, 2, o))).cuda()
              for o in orders]
    per_call = [count_ops(training.make_train_fn(
        orders, units, cap, TRAINING_LEARNING_RATE, TRAINING_LOSS_EPSILON),
        x, params, log2u)[0] for cap in (1, 2)]
    print(f"batched dispatch: the AF stages of one batch (-a 2) dispatch "
          f"{af_ops} torch ops, one training iteration "
          f"{per_call[1] - per_call[0]} (the first with its set-up "
          f"{per_call[0]}); views and allocations excluded")

    sig = make_track(64 * SPB / RATE, 5)  # exactly one 64-block batch
    for flags, af, learn in (("-a 2", 2, False), ("-l", 0, True)):
        enc = TorchEncoder(device="cuda")
        enc.set_encode_parameter(param(af=af, learn=learn))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            enc.encode_whole([sig[0], sig[1]], sig.shape[1])
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        kernels = {}
        launches = 0
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            kernels[ev.key] = ev.self_device_time_total / 1e3
            launches += ev.count
        device_ms = sum(kernels.values())
        if device_ms == 0:
            print(f"batched {flags} profile: no device time in the trace "
                  "(not measured)")
            continue
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:4]
        print(f"batched {flags} profile, one 64-block batch: wall "
              f"{wall_ms:.1f} ms (profiled), device {device_ms:.3f} ms in "
              f"{launches} launches ({100 * device_ms / wall_ms:.1f} % "
              "busy); largest: " + ", ".join(
                  f"{k[:48]} {v:.3f} ms" for k, v in top))


# -- block data parallelism over a device list --------------------------------


def timed(fn):
    """(fn(), wall seconds), the card synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def device_list_phase(tracks, datas, exact_refs) -> None:
    """Every path that takes a device list, on the corpus of phase 4,
    against phase 4's streams and the host oracle's; each beside the
    one-device call of the same work."""
    count = torch.cuda.device_count()
    devices = ([f"cuda:{i}" for i in range(count)] if count >= 2
               else ["cuda:0", "cuda:0"])
    note = ("" if count >= 2 else
            "; one card serves every entry; not a scaling figure")
    print(f"device list: {devices} ({count} card(s){note})")
    lengths = [t.shape[1] for t in tracks]
    seconds = sum(lengths) / RATE
    chans = [[t[0], t[1]] for t in tracks]

    def line(what, one_s, split_s):
        return (f"device list {what}: {split_s:.3f} s "
                f"({seconds / split_s:.1f}x realtime) over {len(devices)} "
                f"entries, one device {one_s:.3f} s "
                f"({seconds / one_s:.1f}x){note}")

    one_enc = TorchEncoder(device="cuda")
    one_enc.set_encode_parameter(param())
    split_enc = TorchEncoder(devices=devices)
    split_enc.set_encode_parameter(param())
    one, one_s = timed(lambda: one_enc.encode_many(chans, lengths))
    split, split_s = timed(lambda: split_enc.encode_many(chans, lengths))
    require(one == datas, "one-device encode differs from phase 4's")
    require(split == datas, "device-list encode differs from phase 4's")
    print(line("encode (streams equal to phase 4's)", one_s, split_s))

    dec = TorchDecoder(devices=devices)
    per_shard = []
    real_shard = dec._synthesize_shard

    def counting(*args):
        before = S.KERNEL_LAUNCHES
        out = real_shard(*args)
        per_shard.append(S.KERNEL_LAUNCHES - before)
        return out

    dec._synthesize_shard = counting
    _, one_s = timed(lambda: TorchDecoder(device="cuda").decode_many(datas))
    S.KERNEL_LAUNCHES = 0
    decoded, split_s = timed(lambda: dec.decode_many(datas))
    launches = S.KERNEL_LAUNCHES
    require(all(k > 0 for k in per_shard),
            f"a decode shard launched no synthesize_rows: {per_shard}")
    for sig, out in zip(tracks, decoded):
        require(lossless(sig, out), "device-list decode is not lossless")
    print(line(f"decode (lossless; synthesize_rows launches {launches}, "
               f"per (block length, shard) {per_shard})", one_s, split_s))

    one_x = DE.DeviceExactEncoder(device="cuda")
    one_x.set_encode_parameter(param())
    split_x = DE.DeviceExactEncoder(devices=devices)
    split_x.set_encode_parameter(param())
    _, one_s = timed(lambda: one_x.encode_many(chans, lengths))
    got, split_s = timed(lambda: split_x.encode_many(chans, lengths))
    require(got == exact_refs,
            "device-list exact-device streams differ from the host oracle")
    require(split_x.guard_rows_flagged == 0
            and split_x.guard_decisions_flagged == 0,
            "the device-list exact-device guard flagged rows")
    print(line(f"exact-device (host oracle's streams, guard rows "
               f"{split_x.guard_rows_flagged} flagged of "
               f"{split_x.guard_rows_total}, decisions "
               f"{split_x.guard_decisions_flagged})", one_s, split_s))

    blocks = np.stack([tracks[0][:, b * SPB:(b + 1) * SPB]
                       for b in range(16)])
    plain = one_enc._analyze_fn(SPB)[0](torch.from_numpy(blocks).cuda())
    sharded = mesh.sharded_analyze(one_enc, mesh.make_block_mesh(devices),
                                   blocks, SPB)
    require(torch.equal(sharded, plain.cpu()),
            "sharded_analyze differs from the unsharded call")
    print(f"device list sharded_analyze: 16 blocks, bit-equal to the "
          "unsharded call")

    orders, n = (2, 32), 512
    rows = 2 * len(devices)
    rng = np.random.default_rng(17)
    signal = torch.from_numpy(rng.normal(0, 0.1, (rows, 2, n))).cuda()
    params = tuple(torch.zeros((rows, 2, o), dtype=torch.float64,
                               device=signal.device) for o in orders)
    step = mesh.make_sharded_train_step(mesh.make_block_mesh(devices),
                                        orders, n, torch.float64)
    new_params, _momentum, loss = step(params, signal,
                                       tuple(torch.zeros_like(p)
                                             for p in params))
    require(bool(torch.isfinite(loss)), "train step loss is not finite")
    require(any(bool(p.abs().sum() > 0) for p in new_params),
            "train step left the params at zero")
    print(f"device list train step: orders {orders}, n {n}, {rows} rows, "
          f"loss {float(loss):.6e}, params moved")


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

    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    clock_hz = 1e6 * float(clock.stdout.split()[0])
    print(f"SM clock (max): {clock_hz / 1e6:.0f} MHz")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, together
        list(pool.map(_kernels.build, ["synthesis", "exact_serial"]))
    S._kernel_fn()
    for k in ES.KERNELS:
        ES._fn(k)
    print(f"built synthesis and exact_serial in "
          f"{time.perf_counter() - t0:.2f} s")

    kernel = kernel_phase()
    launches, datas, plain_multiple = main_path_phase()
    group_err = decode_groups_phase(datas)
    decode_profile_phase(datas)
    with tempfile.TemporaryDirectory() as tmp:
        cli_phase(pathlib.Path(tmp))
    cross_device_phase()

    edge_err = exact_kernel_phase()
    tracks = corpus()
    exact_launches, exact_refs = exact_encode_phase(tracks)
    exact = exact_calls_phase(tracks, clock_hz)
    exact_flags_phase()
    learn_af_phase(tracks, plain_multiple)
    learn_af_dispatch_phase()
    device_list_phase(tracks, datas, exact_refs)

    replaces = {"autocorr_serial": 148, "levinson_serial": 203,
                "serial_abs_mean": 378, "chain_predict": 349}
    report = [{
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
    }]
    for k in ES.KERNELS:
        report.append({
            "name": k,
            "route": "cuda",
            "source": "linne_tpu_torch/csrc/exact_serial.cu",
            # an XLA scan of the JAX graph, not a Pallas kernel
            "replaces": f"linne_tpu/ops/exact_device.py:{replaces[k]}",
            "launches": exact_launches[k],
            "max_abs_err": max(edge_err[k], exact[k]["max_abs_err"]),
            # summed over every call of one 128-row preset-7 fit chunk
            "ms": exact[k]["ms"],
            "plain_ms": exact[k]["plain_ms"],
            "bound_ms": exact[k]["bound_ms"],
            "bound_by": exact[k]["bound_by"],
            # no PyTorch call sums in the reference's serial order
            "library_ms": None,
        })
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
