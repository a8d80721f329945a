#!/usr/bin/env python3
"""Time the port on one CUDA card, to compare two checkouts of the
repository within one machine.

    python3 chip_pairs.py ROOT LABEL [REPS] [--exact | --kernel NAME
                                             [--calls FILE] | --split NAME]

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
checkouts that give the same bits). --kernel levinson_durbin, --kernel
predict_dense and --kernel quantize_coefficients (analysis_scans) take
instead every call of that kernel in one 64-block preset-7 batch of the
corpus, recorded through TorchEncoder's analysis as chip_smoke.py's phase
4 records them: the same three keys, "<kernel>_chunk_ms" then the batch's
calls, and "<kernel>_burst_ms" (chip_smoke.py phase 4's measure: the
batch's calls five times back to back behind a spin, the least of three). The quantizer's batch is its layers: one grouped call
(quantize_layers) on a checkout that has it, else one call a layer
(quantize_coefficients); its digest hashes each layer's int coefficients
and rshifts, the same for either form. --kernel quantize_layer takes the
byte-exact fit's quantizer over the layers of one 128-row preset-7 fit
chunk of the corpus (the fit's final params): one launch of
quantize_layers_exact where the checkout has it, else its
exact_device._quantize_layer a layer (a torch loop over the taps); the
digest also hashes the two margins folded over the layers. With --calls
FILE the recorded calls are read from FILE when it exists and written to
it when it does not, so that two checkouts time the same inputs
(predict's inputs come from the recursion, which two builds may round
apart). --split NAME (levinson_durbin, predict_dense or
quantize_coefficients) builds ROOT's analysis_scans.cu with
-DLINNE_CLOCK_SPLIT (the kernels' clock64 marks) into a temporary
directory and runs each of the batch's calls of NAME once through that
build: "<kernel>_split" lists [argument shapes, cycles a slot] for each
call, the cycles one thread of the kernel spent between its marks (the
slots are named in the source). Run it for the two checkouts in
alternating turns (A B B A A B) in one call, so both see the same card and
host.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import pathlib
import subprocess
import sys
import tempfile
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
# the batched encode's analysis_scans kernels that --kernel and --split take
SCAN_KERNELS = ("levinson_durbin", "predict_dense", "quantize_coefficients")
# the C entry of an analysis_scans kernel where it has another name
ENTRY = {"quantize_coefficients": "quantize_layers"}
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


def batch_blocks(torch, count: int = 64):
    """The first `count` blocks of the corpus as one [count, 2, SPB] int32
    batch on the card (chip_smoke.py's phase-4 batch)."""
    tracks = [make_track(30.0, seed) for seed in range(4)]
    blocks = [t[:, b * SPB:(b + 1) * SPB] for t in tracks
              for b in range(t.shape[1] // SPB)]
    return torch.from_numpy(np.stack(blocks[:count])).cuda()


def quantize_wrapper(AS):
    """The batched encoder's quantizer wrapper of a checkout: the grouped
    one where it has it."""
    return "quantize_layers" if hasattr(AS, "quantize_layers") else (
        "quantize_coefficients")


def batch_scan_calls(torch, name: str, calls_file=None):
    """The argument tuples of an analysis_scans kernel's calls in one
    64-block preset-7 batch, recorded while TorchEncoder's analysis runs
    it; with calls_file, read from it when it exists, else written to it.
    The quantizer's are kept a layer, (coefs, nbits) each, whichever
    wrapper the checkout's encoder calls (scan_calls turns them into that
    wrapper's calls)."""
    from linne_tpu_torch.codec.encoder import TorchEncoder
    from linne_tpu_torch.codec.params import EncodeParameter
    from linne_tpu_torch.ops import analysis_scans as AS

    if calls_file is not None and calls_file.exists():
        return [tuple(a.cuda() if isinstance(a, torch.Tensor) else a
                      for a in args) for args in torch.load(calls_file)]
    wrapper = quantize_wrapper(AS) if name == "quantize_coefficients" \
        else name
    enc = TorchEncoder(device="cuda")
    enc.set_encode_parameter(EncodeParameter(
        num_channels=2, bits_per_sample=16, sampling_rate=RATE,
        num_samples_per_block=SPB, preset=7, ch_process_method=1))
    analyze = enc._analyze_fn(SPB)[0]
    blocks = batch_blocks(torch)
    analyze(blocks)  # warm: cuBLAS handles, the kernels' library
    calls = []
    real = getattr(AS, wrapper)

    def record(*args):
        if wrapper == "quantize_layers":  # a layer a tuple
            calls.extend((c.clone(), args[1]) for c in args[0])
        else:
            calls.append(tuple(a.clone() if isinstance(a, torch.Tensor)
                               else a for a in args))
        return real(*args)

    setattr(AS, wrapper, record)
    try:
        analyze(blocks)
    finally:
        setattr(AS, wrapper, real)
    torch.cuda.synchronize()
    if calls_file is not None:
        calls_file.parent.mkdir(parents=True, exist_ok=True)
        torch.save([tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                          for a in args) for args in calls], calls_file)
    return calls


def scan_calls(AS, name: str, calls):
    """(wrapper, its argument tuples) for a kernel's recorded calls: the
    quantizer's layers as one grouped call where the checkout has it."""
    if name == "quantize_coefficients" and quantize_wrapper(AS) == (
            "quantize_layers"):
        return AS.quantize_layers, [([c for c, _ in calls], calls[0][1])]
    return getattr(AS, name), calls


def exact_quant_calls(torch):
    """(wrapper, its argument tuples) of the byte-exact fit's quantizer on
    one 128-row preset-7 fit chunk of the corpus (the fit's final params,
    layers 4, 128, 16): quantize_layers_exact once where the checkout has
    it, else exact_device._quantize_layer a layer."""
    from linne_tpu_torch.codec.params import EncodeParameter
    from linne_tpu_torch.exact import device_encoder as DE
    from linne_tpu_torch.ops import analysis_scans as AS
    from linne_tpu_torch.ops import exact_device as ED
    from linne_tpu_torch.presets import PRESETS

    param = EncodeParameter(
        num_channels=2, bits_per_sample=16, sampling_rate=RATE,
        num_samples_per_block=SPB, preset=7, ch_process_method=1)
    planes = []
    for t in (make_track(30.0, seed) for seed in range(4)):
        for pos in range(0, t.shape[1] - SPB + 1, SPB):
            planes.append(DE.preemph_plane(
                param, [t[0][pos:pos + SPB], t[1][pos:pos + SPB]], SPB))
    rows = np.concatenate(planes)[:128]
    orders = PRESETS[7].layer_num_params
    fit = ED.build_fit_fn(orders, PRESETS[7].ridge_terms, SPB, 16, 8)
    params = fit(torch.from_numpy(rows).cuda())["params"]
    torch.cuda.synchronize()
    if hasattr(AS, "quantize_layers_exact"):
        return AS.quantize_layers_exact, [(params, orders, 8)]
    calls, col = [], 0
    for order in orders:
        calls.append((params[:, col:col + order], 8))
        col += order
    return ED._quantize_layer, calls


def canonical_outputs(torch, name, calls, outs):
    """The outputs of a kernel's calls in the form both checkouts share:
    the quantizers' a layer (int coefficients, rshift), then the byte-exact
    one's two margins folded over the layers; other kernels' as they are."""
    if name not in ("quantize_coefficients", "quantize_layer"):
        return [o for out in outs for o in _outputs(out)]
    layers, margins = [], []
    for args, out in zip(calls, outs):
        ic, rs = out[0], out[1]
        if isinstance(args[0], list):  # quantize_layers: rs [L, rows]
            orders, rs_of = [c.shape[1] for c in args[0]], lambda li: rs[li]
        elif len(args) == 3:  # quantize_layers_exact: rs [rows, L]
            orders, rs_of = list(args[1]), lambda li: rs[:, li]
        else:  # one layer
            orders, rs_of = [ic.shape[1]], lambda li: rs
        col = 0
        for li, order in enumerate(orders):
            layers += [ic[:, col:col + order], rs_of(li)]
            col += order
        margins.append(out[2:])
    return layers + [functools.reduce(torch.minimum, m)
                     for m in zip(*margins)]


def chunk_ms(torch, kernel, calls, runs: int = 5):
    """CUDA-event milliseconds of a kernel's calls in one chunk, once per
    run; device time (the calls are enqueued while the card is still
    busy)."""
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


def burst_ms(torch, kernel, calls, bursts: int = 3, reps: int = 5):
    """chip_smoke.py phase 4's measure of the chunk: its calls enqueued
    reps times back to back behind a ~1 ms spin, the CUDA-event time over
    reps, the least of `bursts` such runs (a host stall longer than the
    spin lets the enqueue into one of them)."""
    out = []
    for _ in range(bursts):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        for _ in range(reps):
            for args in calls:
                kernel(*args)
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return min(out)


def call_ms(torch, kernel, calls, runs: int = 7, name: str = ""):
    """Each call of the chunk alone: [argument shapes, median CUDA-event
    ms of runs, each queued behind a ~1 ms spin], and a hash of the
    outputs (canonical_outputs)."""
    digest = hashlib.sha256()
    outs = [kernel(*args) for args in calls]
    for o in canonical_outputs(torch, name, calls, outs):
        digest.update(o.contiguous().cpu().numpy().tobytes())
    out = []
    for args in calls:
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
        out.append([shapes(torch, args), float(np.median(ms))])
    return out, digest.hexdigest()[:16]


def shapes(torch, args):
    """A call's arguments as JSON: tensors (also in a list) by shape."""
    def one(a):
        if isinstance(a, torch.Tensor):
            return list(a.shape)
        if isinstance(a, (list, tuple)) and a and isinstance(
                a[0], torch.Tensor):
            return [list(t.shape) for t in a]
        return list(a) if isinstance(a, tuple) else a
    return [one(a) for a in args]


def kernel_times(torch, name: str, calls_file=None) -> dict:
    """A kernel's chunk or batch (5 runs), each call alone and the output
    hash."""
    if name in SCAN_KERNELS:
        from linne_tpu_torch.ops import analysis_scans as AS

        kernel, calls = scan_calls(AS, name,
                                   batch_scan_calls(torch, name, calls_file))
        short = name
    elif name == "quantize_layer":
        kernel, calls = exact_quant_calls(torch)
        short = name
    else:
        from linne_tpu_torch.ops import exact_serial as ES

        calls = chunk_calls(torch, ES, name)
        kernel, short = getattr(ES, name), SHORT[name]
    times = {f"{short}_chunk_ms": chunk_ms(torch, kernel, calls),
             f"{short}_burst_ms": burst_ms(torch, kernel, calls)}
    times[f"{short}_call_ms"], times[f"{short}_digest"] = call_ms(
        torch, kernel, calls, name=name)
    return times


def split_times(torch, root: pathlib.Path, name: str) -> dict:
    """Each of the batch's calls of an analysis_scans kernel once through
    a build of ROOT's analysis_scans.cu with its clock64 marks: [argument
    shapes, the cycles booked to each slot]."""
    from linne_tpu_torch.ops import _kernels
    from linne_tpu_torch.ops import analysis_scans as AS

    kernel, calls = scan_calls(AS, name, batch_scan_calls(torch, name))
    entry = ENTRY.get(name, name)
    src = root / "linne_tpu_torch" / "csrc" / "analysis_scans.cu"
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        lib_path = pathlib.Path(tmp) / "libsplit.so"
        subprocess.run([_kernels.find_nvcc(), *_kernels.NVCC_FLAGS,
                        "-DLINNE_CLOCK_SPLIT", "-o", str(lib_path), str(src)],
                       check=True)
        lib = ctypes.CDLL(str(lib_path))
        fn = getattr(lib, f"linne_{entry}")
        fn.argtypes = AS._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        read = lib.linne_clock_split
        read.argtypes = [ctypes.c_void_p]
        read.restype = ctypes.c_int
        slots = (ctypes.c_longlong * 8)()
        real = AS._fns.get(entry)
        AS._fns[entry] = fn
        try:
            for args in calls:
                kernel(*args)  # warm
                torch.cuda.synchronize()
                read(slots)
                kernel(*args)
                torch.cuda.synchronize()
                if read(slots) != 0:
                    raise SystemExit("chip_pairs: linne_clock_split failed")
                out.append([shapes(torch, args), list(slots)])
        finally:
            if real is None:
                AS._fns.pop(entry, None)
            else:
                AS._fns[entry] = real
    return {f"{name}_split": out}


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
            times[f"{SHORT[name]}_chunk_ms"] = chunk_ms(
                torch, getattr(ES, name), chunk_calls(torch, ES, name))
        times["exact_s"] = exact_runs(torch, param, chans, lengths, reps)
    times["seconds_of_audio"] = sum(lengths) / RATE
    return times


def main() -> int:
    argv = sys.argv[1:]
    kernel = split = calls_file = None
    for flag in ("--kernel", "--split", "--calls"):
        if flag in argv:
            i = argv.index(flag)
            value = argv[i + 1]
            del argv[i:i + 2]
            if flag == "--kernel":
                kernel = value
            elif flag == "--split":
                split = value
            else:
                calls_file = pathlib.Path(value).resolve()
    if "--autocorr" in argv:  # the older spelling of --kernel autocorr_serial
        argv.remove("--autocorr")
        kernel = "autocorr_serial"
    kernels = KERNELS + SCAN_KERNELS + ("quantize_layer",)
    if kernel is not None and kernel not in kernels:
        raise SystemExit(f"chip_pairs: --kernel takes one of {kernels}")
    if split is not None and split not in SCAN_KERNELS:
        raise SystemExit(f"chip_pairs: --split takes one of {SCAN_KERNELS}")
    exact = "--exact" in argv
    args = [a for a in argv if a != "--exact"]
    root = pathlib.Path(args[0]).resolve()
    label = args[1]
    reps = int(args[2]) if len(args) > 2 else 3
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_pairs: this script needs a CUDA card")
    if split is not None:
        times = split_times(torch, root, split)
    elif kernel is not None:
        times = kernel_times(torch, kernel, calls_file)
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
