#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. require a CUDA card; print its name and power limit (nvidia-smi);
  2. build the kernels from linne_tpu_torch/csrc/synthesis.cu,
     exact_serial.cu and analysis_scans.cu (one nvcc each, started
     together, beside two more that print nvcc -Xptxas -v's registers,
     shared memory and spills for exact_serial.cu and analysis_scans.cu);
     measure the card's dependent DADD latency with the clock64 probe of
     exact_serial.cu and its DDIV latency with the one of
     analysis_scans.cu;
  3. kernel: compare the kernel with its plain torch version on the card,
     bit for bit, at the edge shapes of its design (taps per unit 1..128
     around the 32-lane chunk, rows shorter than a chunk, ragged chunks, a
     row count that is not a multiple of the warps per block), and time
     both at the layer-1 group of a 60 s stereo track, beside the bound;
  3b. the encode's serial loops and the byte-exact quantizer
     (analysis_scans.cu): each kernel against its plain torch version on
     the card, one launch a case: both quantizer variants at every order
     1..128 (all-zero rows, the 2^-7 threshold, exact .5 ties, the +-128
     clamp; the byte-exact one also NaN and +-Inf rows and a frexp bin
     edge, its margins included) and in ragged groups of layers (orders
     (4, 128, 16), (128), (1, 2, 3, 4) at 1, 31, 33, 128 and 517 rows,
     read at a wider tensor's row stride and from contiguous copies), bit
     for bit; levinson_durbin at every order
     1..128 on 3 CTAs of rows and 14 more, with silent, guard (ek exactly
     0), rank-deficient, NaN and +-Inf rows (NaN and +-Inf in the same
     places, silent and guard rows bit-equal, determined rows within
     LEVINSON_RTOL, the same bits run to run and in reversed rows); the
     dense predict cascade at every (order, unit choices) of presets 0-7
     at every log2u, int32 extremes that wrap, rshift 1..15, and at
     PREDICT_EDGES (n that no tile divides, outputs that straddle units,
     rshift 0, 32 and 40), bit for bit;
  4. main path: TorchEncoder.encode_many on a seeded 4 x 30 s stereo corpus
     at preset 7, then TorchDecoder.decode_many, both on the card; every
     stream must decode losslessly (also under the host Decoder), the
     encode must have launched each of its analysis_scans kernels (the
     quantizer once a batch, every layer in one launch, counted per graph
     replay: each batch runs two graphs, eagerly at a shape's first
     batches)
     and the decode the synthesis kernel; the same encode and decode again
     on fresh objects under torch.profiler, where each kernel's launches
     counted by name in the trace must equal the wrappers' counts (the
     `kernels` line prints the traced counts); the W of each batch, the
     overflow rows and the
     bytes each transfer moved; then every analysis_scans call of one
     64-block batch, checked against its plain version and timed beside
     its bound and chain bound; the torch ops that batch dispatches per
     stage (pre_stage, each fit_stage, select/finish) and its device time
     against its wall time, with the kernels and with the plain versions
     forced on the card; the corpus encode in 5 alternating pairs of the
     two (multiples, sizes within 0.1 %, blocks that differ, every stream
     lossless);
  4b. the residual pass: unit_residual_select's launches in one
     128-block batch at presets 7 and 0 (one a layer: 3 and 2), then the
     preset-7 layer-2 call (1,024 rows, n 10240, order 128) against its
     plain version (picks, residuals and coefficients bit for bit where
     the picks agree, losses within UNIT_RESIDUAL_RTOL) and timed beside
     the plain version on the card's routes (the pass it replaced), on
     the loop route, and its bound;
  4c. the windowed autocorrelation: lpc_autocorr's launches in one
     128-block batch at presets 7 and 0 (one a layer and one for the
     block-type estimate: 4 and 3), then each preset-7 call (the
     estimate and layer 1 on 256 rows, layers 2 and 3 on 1,024) against
     its plain version (each lag within LPC_AUTOCORR_RTOL of its unit's
     lag 0, silent units zero, two launches bit-equal) and timed beside
     the plain version on the card's routes (the pass it replaced) and its
     bound;
  4d. the Rice parameter search: rice_search's launches in one 128-block
     batch at presets 7 and 0 (one a batch), then each preset's call
     (256 rows of 10,240 residuals) against its plain version (orders and
     parameters bit for bit) and timed beside the plain version (the
     torch ops it replaced) and its bound;
  5. decode groups: every (rows, ns, npu) launch of that decode, recorded
     in a second decode, checked bit for bit against the plain version and
     timed (CUDA events) beside its bound; then one decode under
     torch.profiler for the device-time breakdown (copies apart);
  6. CLI: `python -m linne_tpu_torch.cli -e -m 7`, `-e -m 7 -a 2` and
     `-e -m 7 -l` on a 10 s WAV (each lossless), and `-e --exact-device
     -m 7` against `-e --exact` on it, byte for byte;
  7. cross-device: one 10 s track encoded on the CPU and on the card;
  8. exact-device kernels: each serial float64 kernel of exact_serial.cu
     against its plain torch version on the card, bit for bit, at the edge
     shapes of its design (odd and even lengths, lags 1..129, orders 1..128,
     a zero-signal row, row counts that are not a multiple of the block);
     autocorr_serial with each choice of lags a thread at its tile, ring,
     staging and lag-group edges, with NaN, +-Inf, -0.0 and subnormal
     samples, and at every call shape of a preset-7 fit at 13 rows;
     levinson_serial on both paths of its plan (one thread a segment to
     order 32, one warp above) at orders around each template and warp
     slot, every preset-7 call shape, and rows with NaN and +-Inf lags, ek
     reaching 0 and a tone; serial_abs_mean in each rows-a-CTA bucket,
     around three tiles of its ring, from start 0 and 1, with start == n,
     n < row length, rows off a 16-byte boundary, and NaN, +-Inf, -0.0 and
     subnormal samples; one launch a call; the count per kernel;
  9. exact-device path: DeviceExactEncoder.encode_many on the corpus of
     phase 4; every stream byte-identical to the host oracle's
     (ParallelExactEncoder, and ExactEncoder on the first track) and
     lossless; wall time, realtime multiples, guard counters, launches and
     a torch.profiler split of device time against wall time;
 10. exact-device calls: the corpus's device fit alone (no framing), timed,
     with the host share of the quantizer (one launch a chunk) and its
     share of the torch ops one chunk dispatches; then every kernel call
     of one 128-row fit chunk of that corpus (the quantizer's one launch
     too),
     recorded, checked bit for bit against the plain version and timed
     beside its bound, chain bound (at the measured DADD latency) and
     their larger (the call's floor), with the plan of each
     autocorr_serial, levinson_serial and serial_abs_mean call (lags a
     thread, path, rows a CTA, CTAs, warps an SM);
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
     one-device call's;
 14. slim transfers and routes: pack_plane_words on the card bit-equal to
     the CPU at seven widths, inverted by native.unpack_bits; the CUDA-event
     time of one batch's packed copy beside its int32 residual's; the
     corpus with a 6-bit residual class (phase 4's streams, every overflow
     row fetched) and with a 6-bit download (lossless, every row flagged);
     the fit stages of one batch on the matrix-unit and on the lag/FFT
     routes (span, device time, torch ops), the plain -e corpus encode in 5
     alternating pairs of the two, and the card's default route.
 15. the two throughput entry points: the corpus tool (python -m
     linne_tpu_torch.tools.encode_corpus -m 7) in a subprocess on a WAV
     corpus of three format groups (phase 4's tracks; two mono 24-bit
     48 kHz tracks; a stereo 16-bit 48 kHz track with a partial tail), once
     on cuda and once over --devices cuda:0,cuda:0: every file lossless
     under the host Decoder, both runs byte-equal and equal to an
     in-process TorchEncoder(batch_blocks=128).encode_many of each group,
     whose analysis_scans launches must be nonzero; then python -m
     linne_tpu_torch.bench --reps 3 in a subprocess: every row present and
     finite, the byte-exact rows identical to the host oracle with 0 rows
     flagged at preset 0, the kernels of each path launched; its rows
     are printed; then every row the byte-exact guard flags on the
     bench's preset-7 corpus, each held to the CPU fit's margins bit for
     bit, its track's stream to the host oracle's.
 16. hostile streams: the port's encoder on the card makes stereo 16-bit
     streams at presets 0, 2 and 7 and a mono 24-bit one at preset 7
     (block 2560, two blocks and a tail); 400 seeded mutations of each
     (1-5 bytes at offset 30 or later), its truncations every 97 bytes,
     its corrupt num_samples header, and its first compress block
     rewritten with more units than taps and with rshift 0 in one channel
     (tests/torch_hostile_streams.py) go through TorchDecoder on the card
     and the host Decoder with CRC checking off, a synchronize after each:
     both raise FormatError or both give the same samples; every
     synthesize_rows launch of the sweep is bit-equal to its plain version
     on the card; launches, rows flagged past the download width and
     decodes with samples are all nonzero; phase 4's streams then decode
     to phase 4's samples.
 17. graphs: the batched encode runs its stages as CUDA graphs (G1:
     pre_stage, the fit stages and select_stage; G2: finish_stage at a
     W; a shape's first G.CAPTURE_AT - 1 batches eagerly, the next
     captured, later ones replayed), as every phase above did; here each
     is held to the eager
     card
     encode (the graph lookup patched out inside this script), byte for
     byte and lossless under the host Decoder, with graphs replayed:
     phase 4's corpus (also equal to phase 4's streams), at
     batch_blocks=128 (the corpus twice: four batches a run), under a forced
     6-bit residual class (every live block fetches its residual after
     later batches were dispatched), with -a 2 and with -l (graphs around
     the eager middle) and over ["cuda:0", "cuda:0"]; each with its
     graphs, eager runs, captures, capture seconds, replays and pool
     bytes, and the encode's seconds on both fresh encoders (the cold
     encode a CLI call makes), and the memory reserved before and after
     the corpus's captures; then one
     64-block batch on a warm encoder, with graphs and eagerly: the torch
     ops Python dispatches for it, the stages' profiled wall against
     device time and a CUDA-event span; then the plain -e corpus encode on
     a warm graph encoder against a warm eager one in GRAPH_PAIRS
     alternating pairs (median, IQR, pairs won), and each under the
     profiler (wall against device time); then -a 2 on the corpus and -l
     on its first track, warm, in GRAPH_REFINE_PAIRS pairs each; then
     cold encodes of n batches of one shape, graphs against eager, at 64
     and 128 rows (graph_crossover_phase: what a capture costs and a
     replay saves, which G.CAPTURE_AT is chosen from).
The second-to-last line is the kernel report (JSON), the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import re
import pathlib
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from chip_pairs import make_track
from linne_tpu_torch import bench
from linne_tpu_torch import native
from linne_tpu_torch.codec.decoder import Decoder
from linne_tpu_torch.codec import encoder as E
from linne_tpu_torch.codec import graphs as G
from linne_tpu_torch.codec import torch_decoder
from linne_tpu_torch.codec.encoder import TorchEncoder
from linne_tpu_torch.codec.params import DecoderConfig, EncodeParameter
from linne_tpu_torch.codec.torch_decoder import TorchDecoder
from linne_tpu_torch.constants import (
    CH_PROCESS_MS,
    CH_PROCESS_NONE,
    HEADER_SIZE,
    LPC_COEF_BITWIDTH,
    TRAINING_LEARNING_RATE,
    TRAINING_LOSS_EPSILON,
)
from linne_tpu_torch.exact import device_encoder as DE
from linne_tpu_torch.exact.encoder import ExactEncoder
from linne_tpu_torch.exact.parallel_encoder import ParallelExactEncoder
from linne_tpu_torch.format.block import parse_block_header
from linne_tpu_torch.format.header import FormatError
from linne_tpu_torch.io.wav import read_wav, write_wav
from linne_tpu_torch.ops import _kernels
from linne_tpu_torch.ops import afmethod
from linne_tpu_torch.ops import analysis as A
from linne_tpu_torch.ops import analysis_scans as AS
from linne_tpu_torch.ops import bitpack
from linne_tpu_torch.ops import exact_device as ED
from linne_tpu_torch.ops import intops as I
from linne_tpu_torch.ops import rice_search as R
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
# contract them). The chain bound takes a dependent DADD as DADD_CYCLES
# (reckoned) and as the latency exact_serial's probe measures on the card.
FP64_OPS_PER_CLK = 64 * 132
DADD_CYCLES = 8


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


def kernel_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call, CUDA events, after one warm-up
    call; the timed calls queue behind a ~1 ms spin of the card, so that
    the host's enqueue time of a short kernel drops out."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000)
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


def main_path_phase(tracks):
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
    real_quantize, layers = A.quantize_layers, []

    def quantize_layers(coefs, nbits):  # the layers of each python call
        layers.append(len(coefs))  # (under graphs: eager runs, captures)
        return real_quantize(coefs, nbits)

    S.KERNEL_LAUNCHES = 0
    for k in AS.KERNELS:
        AS.KERNEL_LAUNCHES[k] = 0
    A.quantize_layers = quantize_layers
    try:
        t0 = time.perf_counter()
        datas = enc.encode_many([[t[0], t[1]] for t in tracks], lengths)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        A.quantize_layers = real_quantize
    decoded = dec.decode_many(datas)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = S.KERNEL_LAUNCHES
    scan_launches = {k: AS.KERNEL_LAUNCHES[k] for k in MAIN_SCANS}
    batches = enc.batch_widths  # one W a dispatched batch
    graphs = enc._graphs[torch.device("cuda", 0)]

    require(launches > 0, "decode_many did not launch the synthesis kernel")
    for k, v in scan_launches.items():
        require(v > 0, f"encode_many did not launch the {k} kernel")
    require(scan_launches["quantize_coefficients"] == len(batches)
            and set(layers) == {len(PRESETS[PRESET].layer_num_params)},
            f"the quantizer launched {scan_launches['quantize_coefficients']}"
            f" times for {len(batches)} batches: not once a batch")
    require(graphs.eager_runs + graphs.replays == 2 * len(batches),
            f"{graphs.eager_runs} eager runs and {graphs.replays} graph "
            f"replays for {len(batches)} batches")
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
          f"kernel launches {launches}; encode launches of the "
          f"analysis_scans kernels {scan_launches} ({len(batches)} batches:"
          f" the quantizer once a batch; counted per graph replay: "
          f"{graphs.eager_runs} eager stage runs (a shape's first ones), "
          f"{graphs.replays} replays of {graphs.graphs} graphs, whose "
          f"{graphs.captures} captures took {graphs.capture_seconds:.3f} s of"
          f" the encode)")
    transfer_report(enc, dec, datas)
    traced = traced_launches(tracks)
    counted = dict(scan_launches, synthesize_rows=launches)
    require(traced == counted,
            f"the kernels in a trace of the main path {traced} differ from "
            f"the wrappers' counts {counted}")
    print(f"main path traced again (fresh encoder and decoder, CUDA "
          f"activity only): kernels launched, counted by name in the trace,"
          f" {traced}: equal to the wrappers' counts of the timed run")
    return (traced["synthesize_rows"],
            {k: traced[k] for k in MAIN_SCANS}, datas, seconds / (t1 - t0))


# the kernel function of each main-path wrapper, as a trace names it
TRACE_KERNELS = {"levinson_durbin": "levinson_kernel",
                 "quantize_coefficients": "quantize_kernel",
                 "predict_dense": "predict_kernel",
                 "unit_residual_select": "unit_residual_kernel",
                 "lpc_autocorr": "lpc_autocorr_kernel",
                 "rice_search": "rice_search_kernel",
                 "synthesize_rows": "synth_rows_kernel"}


def traced_launches(tracks) -> dict:
    """Phase 4's encode and decode once more, on a fresh encoder and
    decoder under torch.profiler (CUDA activity only): the launches of
    each main-path kernel, counted by its name among the trace's kernels
    (a kernel replayed in a CUDA graph is traced at each replay). Also
    requires the wrappers' counts of this run to equal the trace's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    enc = TorchEncoder(device="cuda")
    enc.set_encode_parameter(param())
    dec = TorchDecoder(device="cuda")
    S.KERNEL_LAUNCHES = 0
    for k in AS.KERNELS:
        AS.KERNEL_LAUNCHES[k] = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        dec.decode_many(enc.encode_many([[t[0], t[1]] for t in tracks],
                                        [t.shape[1] for t in tracks]))
        torch.cuda.synchronize()
    traced = dict.fromkeys(TRACE_KERNELS, 0)
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        for name, fn in TRACE_KERNELS.items():
            if re.search(rf"(?<!\w){fn}(?!\w)", ev.key):
                traced[name] += ev.count
    counted = {k: AS.KERNEL_LAUNCHES[k] for k in MAIN_SCANS}
    counted["synthesize_rows"] = S.KERNEL_LAUNCHES
    require(traced == counted,
            f"traced main path: kernels in the trace {traced}, wrappers' "
            f"counts {counted}")
    return traced


def compress_samples(datas) -> int:
    """Samples in the compress blocks of the streams, every channel: what
    the pooled decode moves each way."""
    samples = 0
    for data in datas:
        header, _orders, blocks = TorchDecoder(device="cpu")._parse_stream(
            data)
        for _start, n, kind, _b in blocks:
            if kind == "compress":
                samples += header.num_channels * n
    return samples


def transfer_report(enc, dec, datas) -> None:
    """The bytes the encode and the decode moved, beside the int32 planes
    that the same work would move without the W-bit packing."""
    batches = len(enc.batch_widths)
    full = 64 * 2 * SPB * 4  # one 64-block batch's int32 residual plane
    print(f"encode transfers: {batches} batches at W {enc.batch_widths}, "
          f"overflow rows fetched {enc.overflow_rows}, "
          f"{enc.bytes_to_host} bytes to the host "
          f"({enc.bytes_to_host / batches:.0f} a batch; a 64-block batch's "
          f"int32 residual plane alone is {full} bytes)")
    samples = compress_samples(datas)
    print(f"decode transfers: up {dec.bytes_up} bytes, down "
          f"{dec.bytes_down} bytes (int32 rows would be {4 * samples} each "
          f"way), download chunks {dec.download_chunks}, flagged rows "
          f"{dec.flagged_rows}")


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
    route = ("matmul" if A._use_matmul_routes(torch.zeros(1, device="cuda"))
             else "lag/FFT")
    print(f"cross-device: cpu (lag/FFT routes) {len(a)} bytes, cuda "
          f"({route} routes) {len(b)} bytes, identical streams: {a == b}, "
          f"bytes equal at {same} of {max(len(a), len(b))} positions")


# -- the encode's serial loops as kernels (analysis_scans.cu) -----------------

def unit_residual_plain(x, params, log2u, loop=True):
    """AS.unit_residual_select's call through its plain version on the
    loop route (the sums the kernel repeats), or with loop=False on the
    card's routes (the pass before the kernel), in the wrapper's
    layout."""
    ridges, per_ridge, n = x.shape
    units = [1 << v for v in log2u]
    real = A.unit_forward
    if loop:
        A.unit_forward = A._unit_forward_loop
    try:
        out = A._unit_residual_select_plain(
            x, [p.reshape(ridges, per_ridge, u, -1)
                for p, u in zip(params, units)], units)
    finally:
        A.unit_forward = real
    return tuple(t.reshape((ridges * per_ridge,) + tuple(t.shape[2:]))
                 for t in out)


def lpc_autocorr_plain(x, splits):
    """AS.lpc_autocorr's call through its plain version on the card's
    routes (the pass the kernel replaced), in the wrapper's layout."""
    rows, n = x.shape
    out = []
    for l2, lags, w in splits:
        seg = x.reshape(rows, 1 << l2, n >> l2)
        out.append(A._autocorrelation_plain(seg if w is None else seg * w,
                                            lags))
    return out


def rice_search_plain(x, max_porder):
    """AS.rice_search's call through its plain version (the torch ops the
    kernel replaced), in the wrapper's layout."""
    require(max_porder == R.max_porder_for(x.shape[-1]),
            f"max_porder {max_porder} for n = {x.shape[-1]}")
    return R._rice_search_plain(x)


# The batched encode's kernels (the byte-exact fit's quantizer,
# "quantize_layer", is the last of AS.KERNELS), the wrapper the encode
# calls for each, and each wrapper's plain version.
MAIN_SCANS = ("levinson_durbin", "quantize_coefficients", "predict_dense",
              "unit_residual_select", "lpc_autocorr", "rice_search")
_SCAN_WRAPPER = {"levinson_durbin": "levinson_durbin",
                 "quantize_coefficients": "quantize_layers",
                 "predict_dense": "predict_dense",
                 "unit_residual_select": "unit_residual_select",
                 "lpc_autocorr": "lpc_autocorr",
                 "rice_search": "rice_search",
                 "quantize_layer": "quantize_layers_exact"}
_SCAN_PLAIN = {"levinson_durbin": A._levinson_durbin_plain,
               "quantize_coefficients": A._quantize_layers_plain,
               "predict_dense": I._predict_dense_plain,
               "unit_residual_select": unit_residual_plain,
               "lpc_autocorr": lpc_autocorr_plain,
               "rice_search": rice_search_plain,
               "quantize_layer": ED._quantize_layers_plain}
# Where each kernel's loop stands in the JAX package: an XLA scan inside a
# jitted stage (the byte-exact quantizer: an unrolled loop of the jitted
# fit; the residual pass: fit_layer's loop over the unit counts; the Rice
# search: XLA ops over the residual plane), not a Pallas kernel.
_SCAN_REPLACES = {"levinson_durbin": "linne_tpu/ops/analysis.py:141",
                  "quantize_coefficients": "linne_tpu/ops/analysis.py:426",
                  "predict_dense": "linne_tpu/ops/intops.py:87",
                  "unit_residual_select": "linne_tpu/ops/analysis.py:348",
                  "lpc_autocorr": "linne_tpu/ops/analysis.py:196",
                  "rice_search": "linne_tpu/ops/rice_search.py:58",
                  "quantize_layer": "linne_tpu/ops/exact_device.py:429"}
# The residual pass's loss against its plain version's: the same terms
# summed in another order
UNIT_RESIDUAL_RTOL = 1e-12
# The windowed autocorrelation against its plain version's, a lag against
# its unit's lag 0 (the largest |value| a unit has): the same products
# summed in another order
LPC_AUTOCORR_RTOL = 1e-12
# The recursion's tolerance against its plain version. Both round every
# operation alike but sum a . s in other orders, so they differ by the
# rounding of those sums, which the recursion carries on. On rows that the
# data determine (the plain version's prediction error prod(1 - parcor^2)
# stays at or above LEVINSON_DETERMINED of lag 0, every |parcor| < 1) the
# kernel is held to LEVINSON_RTOL x the row's largest |value|. Below that a
# row is rank-deficient up to rounding (a pure tone): both versions divide
# rounding noise by rounding noise there, and only NaN and +-Inf are held
# to the same places.
LEVINSON_RTOL = 1e-9
LEVINSON_DETERMINED = 1e-8
# the quantizer's dependent float64 steps a tap (add, add 0.5, floor,
# clamp, subtract), each taken at the probed DADD latency (reckoned)
QUANT_CHAIN_STEPS = 5


def check_levinson(args, got, what, exact_rows=()):
    """Kernel outputs against the plain version on the same args: NaN and
    +-Inf in the same places, the determined rows within LEVINSON_RTOL of
    the row's largest |value|, exact_rows bit for bit. Returns (largest
    relative difference, largest absolute difference, on the determined
    rows; determined rows, rows)."""
    ac, order = args[0], args[1]
    want_lpc, want_pc = A._levinson_durbin_plain(ac, order, True)
    got = got if isinstance(got, tuple) else (got,)
    wants = (want_lpc, want_pc)[:len(got)]
    det = ((want_pc.abs() < 1).all(-1)
           & (torch.prod(1 - want_pc * want_pc, -1) >= LEVINSON_DETERMINED))
    rel_max = abs_max = 0.0
    for g, w in zip(got, wants):
        require(torch.equal(g.isnan(), w.isnan()),
                f"levinson_durbin NaN places differ at {what}")
        inf = w.isinf()
        require(torch.equal(g.isinf(), inf) and torch.equal(g[inf], w[inf]),
                f"levinson_durbin +-Inf places differ at {what}")
        fin = torch.isfinite(w)
        scale = torch.where(fin, w.abs(), 0.0).amax(-1)
        diff = torch.where(fin, (g - w).abs(), 0.0).amax(-1)
        rel = torch.where(scale > 0, diff / scale.clamp(min=1e-300), diff)
        if bool(det.any()):
            rel_max = max(rel_max, float(rel[det].max()))
            abs_max = max(abs_max, float(diff[det].max()))
        for r in exact_rows:
            require(torch.equal(bits(g[r]), bits(w[r])),
                    f"levinson_durbin row {r} not bit-equal at {what}")
    require(rel_max <= LEVINSON_RTOL,
            f"levinson_durbin off by {rel_max:.3g} of the row at {what}")
    return rel_max, abs_max, int(det.sum()), int(det.numel())


def check_unit_residual(args, got, what):
    """The residual pass against its plain version on the loop route: the
    same pick, residual and coefficients bit for bit on every row whose
    pick agrees, a pick apart only where the two losses lie within
    UNIT_RESIDUAL_RTOL, the losses within it (NaN in the same places).
    Returns (largest relative loss difference, largest absolute, rows
    whose pick agrees, rows)."""
    log2u, flat, res, loss = got
    wl2, wflat, wres, wloss = _SCAN_PLAIN["unit_residual_select"](*args)
    agree = log2u == wl2
    fin = ~torch.isnan(wloss)
    require(torch.equal(torch.isnan(loss), ~fin),
            f"unit_residual_select NaN losses differ at {what}")
    diff = (loss - wloss).abs()
    rel = torch.where(fin, diff / wloss.abs().clamp(min=1e-300), 0.0)
    require(bool(torch.all(rel <= UNIT_RESIDUAL_RTOL)),
            f"unit_residual_select loss off by {float(rel.max()):.3g} at "
            f"{what}")
    require(torch.equal(bits(res[agree]), bits(wres[agree]))
            and torch.equal(bits(flat[agree]), bits(wflat[agree])),
            f"unit_residual_select residual not bit-equal at {what}")
    err = float(torch.where(fin, diff, 0.0).max()) if loss.numel() else 0.0
    return float(rel.max()), err, int(agree.sum()), int(agree.numel())


def check_lpc_autocorr(args, got, what):
    """Kernel outputs against the plain version on the same args: each lag
    within LPC_AUTOCORR_RTOL of its unit's lag 0, silent units exactly 0,
    a second launch the same bits. Returns (largest |difference| over lag
    0, largest |difference|, silent units, units)."""
    want = _SCAN_PLAIN["lpc_autocorr"](*args)
    again = AS.lpc_autocorr(*args)
    rel = err = 0.0
    silent = units = 0
    for g, a, w in zip(got, again, want):
        require(torch.equal(bits(g), bits(a)),
                f"lpc_autocorr not the same bits twice at {what}")
        scale = w[..., :1].abs()
        d = (g - w).abs()
        zero = scale[..., 0] == 0
        require(not torch.any(g[zero]),
                f"lpc_autocorr: a silent unit not zero at {what}")
        live = ~zero
        if torch.any(live):
            rel = max(rel, float((d[live] / scale[live]).max()))
        err = max(err, float(d.max()))
        silent += int(zero.sum())
        units += zero.numel()
    require(rel <= LPC_AUTOCORR_RTOL,
            f"lpc_autocorr off by {rel:.3g} of lag 0 at {what}")
    return rel, err, silent, units


def check_scan(name, args, got, what, exact_rows=()):
    """One kernel call's outputs against the plain version. Returns (largest
    relative, largest absolute difference, determined rows, rows); the
    quantizer's two variants and the predict cascade must be bit-equal
    (float64 as int64 bits: both ran on the card, NaN bits included)."""
    if name == "levinson_durbin":
        return check_levinson(args, got, what, exact_rows)
    if name == "unit_residual_select":
        return check_unit_residual(args, got, what)
    if name == "lpc_autocorr":
        return check_lpc_autocorr(args, got, what)
    check_exact(name, got, _SCAN_PLAIN[name](*args), what)
    return 0.0, 0.0, 0, 0


def scan_launch(name, args):
    """One call of kernel `name` through the wrapper the encode calls,
    which must launch it once."""
    before = AS.KERNEL_LAUNCHES[name]
    got = getattr(AS, _SCAN_WRAPPER[name])(*args)
    torch.cuda.synchronize()
    require(AS.KERNEL_LAUNCHES[name] == before + 1,
            f"{name}: not one launch")
    return got


def quantize_edge_rows(order, seed) -> torch.Tensor:
    """[8, order] coefficients on the card: seeded rows at three scales, an
    all-zero row, rows at and just above the 2^-7 threshold, exact .5 ties
    at rshift 7, and error feedback near the +-128 clamp."""
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 0.3, (8, order)) * np.array(
        [1e-2, 1.0, 4.0, 0.0, 1.0, 1.0, 1.0, 1.0])[:, None]
    c[4] = 2.0 ** -7
    c[5] = np.where(np.arange(order) % 2, -1, 1) * 2.0 ** -7 * (1 + 2e-16)
    c[6] = (rng.integers(-64, 64, order)
            + 0.5 * rng.integers(0, 2, order)) * 2.0 ** -7
    c[6, 0] = 0.75
    c[7] = np.where(np.arange(order) % 3, 127.49, -127.87) * 2.0 ** -7
    return torch.from_numpy(c).cuda()


def quantize_special_rows(order, seed) -> torch.Tensor:
    """[14, order] on the card: quantize_edge_rows, then rows for the
    byte-exact variant: NaN coefficients (their products count as 0), +Inf
    and -Inf in a row of one sign, +Inf and -Inf together (NaN sums), max
    |c| exactly 2^-1 (a frexp bin edge) and a row of 2^-1074."""
    c = torch.cat([quantize_edge_rows(order, seed),
                   quantize_edge_rows(order, seed + 1)[:6]])
    c[8, ::3] = float("nan")
    c[9, 0] = float("inf")
    c[10, -1] = -float("inf")
    c[11, 0], c[11, -1] = float("inf"), -float("inf")
    c[12] = c[12].clamp(-0.49, 0.49)
    c[12, order // 2] = 0.5
    c[13] = 2.0 ** -1074
    return c


def quantize_group(orders, rows, seed, exact=False, width=0):
    """One group of layers on the card, `rows` rows each, their first rows
    quantize_special_rows (quantize_edge_rows without the exact variant's
    non-finite rows): the layers [rows, order] as column slices of one
    [rows, sum(orders) + width] tensor (rows at its stride), and that
    tensor."""
    parts = []
    for li, order in enumerate(orders):
        rng = np.random.default_rng(seed + li)
        c = torch.from_numpy(rng.normal(0, 0.3, (rows, order))).cuda()
        edge = (quantize_special_rows(order, seed + li) if exact
                else quantize_edge_rows(order, seed + li))
        k = min(rows, edge.shape[0])
        c[:k] = edge[:k]
        parts.append(c)
    arena = torch.cat(parts + [parts[0].new_full((rows, width),
                                                 float("nan"))], dim=1)
    layers, col = [], 0
    for order in orders:
        layers.append(arena[:, col:col + order])
        col += order
    return layers, arena


def levinson_edge_rows(order, seed, extra=0) -> torch.Tensor:
    """[14 + extra, order + 1] autocorrelations on the card: seeded
    segments after a ridge (rows 0-6 and 14 on), a silent row (7), [1, 1,
    ...] (8: ek exactly 0 after the first step), a pure tone (9:
    rank-deficient), a NaN lag, +Inf at lag 1, -Inf at the last lag, r0 =
    +Inf (10-13)."""
    ac = levinson_rows(14 + extra, order, seed)
    lags = torch.arange(order + 1, dtype=torch.float64, device=ac.device)
    ac[7] = 0.0
    ac[8] = 1.0
    ac[9] = torch.cos(0.3 * lags)
    ac[10, min(order, 3)] = float("nan")
    ac[11, 1] = float("inf")
    ac[12, order] = -float("inf")
    ac[13, 0] = float("inf")
    return ac


def predict_edge_inputs(order, choices, n, seed):
    """Two rows at each log2u of the choices on the card: samples and
    coefficients over the whole int32 range on even rows (the sums wrap;
    int32 extremes among the samples), quantizer-range coefficients on odd
    rows; rshift 1..15 with 8 on row 0."""
    rng = np.random.default_rng(seed)
    rows = 2 * len(choices)
    x = rng.integers(-2**31, 2**31, (rows, n), dtype=np.int64)
    x[0, ::7] = -2**31
    x[1, ::5] = 2**31 - 1
    c = rng.integers(-2**31, 2**31, (rows, order), dtype=np.int64)
    c[1::2] = rng.integers(-128, 128, (rows // 2, order))
    log2u = np.repeat([(u - 1).bit_length() for u in choices], 2)
    rsh = rng.integers(1, 16, rows)
    rsh[0] = 8
    return tuple(torch.from_numpy(a.astype(np.int32)).cuda()
                 for a in (x, c, log2u, rsh))


# (order, unit choices, n) of the predict cascade's edges: n that neither
# its 2048-sample tile nor its 16 outputs a thread divide; units of 9 and 33
# samples (a thread's outputs straddle two units); a row shorter than its
# history; npu 1 and 128 in one call
PREDICT_EDGES = [(4, (1, 2, 4), 1500), (4, (1, 2, 4), 12),
                 (16, (1, 2), 2050), (128, (1, 2), 1030), (1, (1,), 1001),
                 (128, (1, 2, 4, 8, 16, 32, 64, 128), 1152),
                 (32, (1, 2, 4, 8, 16, 32), 1056)]


# (orders, rows) of the quantizer's ragged groups: preset 7's layers, one
# layer, four short ones; one row, rows around a CTA's tile, 517
QUANT_GROUPS = [(orders, rows) for orders in ((4, 128, 16), (128,),
                                              (1, 2, 3, 4))
                for rows in (1, 31, 33, 128, 517)]


def scans_edge_phase() -> dict:
    """Each analysis_scans kernel against its plain version on the card at
    the edges of its design, one launch a case: the quantizer's two
    variants at every order 1..128 (one layer; the byte-exact one also on
    NaN and +-Inf rows) and in QUANT_GROUPS, their layers as column slices
    of a wider tensor and as contiguous copies; the recursion at every order 1..128 (each lanes-a-row template
    and its edges) on 3 CTAs of rows and 14 more (no multiple of a CTA's
    rows), with silent, guard, rank-deficient and non-finite rows, twice
    (the same bits) and with its rows reversed (the same bits a row); the
    predict cascade at every (order, unit choices) of presets 0-7 at every
    log2u, at a length that is a multiple of its tile and one that is not,
    then at PREDICT_EDGES with rshift 0, 32 and 40 beside 1..15.
    Returns the largest absolute difference per kernel."""
    err = dict.fromkeys(AS.KERNELS, 0.0)
    counts = dict.fromkeys(AS.KERNELS, 0)
    for order in range(1, 129):
        for name, rows in (("quantize_coefficients",
                            quantize_edge_rows(order, order)),
                           ("quantize_layer",
                            quantize_special_rows(order, order))):
            args = (([rows], LPC_COEF_BITWIDTH) if name ==
                    "quantize_coefficients"
                    else (rows, (order,), LPC_COEF_BITWIDTH))
            check_scan(name, args, scan_launch(name, args), order)
            counts[name] += 1
    for orders, rows in QUANT_GROUPS:
        seed = rows + sum(orders)
        layers, _ = quantize_group(orders, rows, seed, width=3)
        _, arena = quantize_group(orders, rows, seed, exact=True, width=5)
        for args, name in (
                ((layers, LPC_COEF_BITWIDTH), "quantize_coefficients"),
                (([c.contiguous() for c in layers], LPC_COEF_BITWIDTH),
                 "quantize_coefficients"),
                ((arena, orders, LPC_COEF_BITWIDTH), "quantize_layer"),
                ((arena[:, :sum(orders)].contiguous(), orders,
                  LPC_COEF_BITWIDTH), "quantize_layer")):
            check_scan(name, args, scan_launch(name, args), (orders, rows))
            counts[name] += 1
    rel = 0.0
    for order in range(1, 129):
        cta_rows = 128 // AS.levinson_lanes(order)
        ac = levinson_edge_rows(order, order, extra=3 * cta_rows)
        for with_parcor in (False, True):
            args = (ac, order, with_parcor)
            got = scan_launch("levinson_durbin", args)
            r, a, _, _ = check_levinson(args, got, (order, with_parcor),
                                        exact_rows=(7, 8))
            rel, err["levinson_durbin"] = max(rel, r), max(
                err["levinson_durbin"], a)
            again = scan_launch("levinson_durbin", args)
            flip = scan_launch("levinson_durbin",
                               (ac.flip(0).contiguous(), order, with_parcor))
            for g, h, f in zip(*(t if with_parcor else (t,)
                                 for t in (got, again, flip))):
                require(torch.equal(bits(g), bits(h)),
                        f"levinson_durbin not deterministic at {order}")
                require(torch.equal(bits(g), bits(f.flip(0))),
                        f"levinson_durbin depends on the row's place at "
                        f"{order}")
            counts["levinson_durbin"] += 3
    for order, choices in sorted({
            (o, tuple(A.candidate_units(o, SPB)))
            for p in PRESETS for o in p.layer_num_params}):
        for n in (SPB, 3 * 128):  # 384 is no multiple of the 2048-sample tile
            args = predict_edge_inputs(order, choices, n, order + n) + (
                max(choices),)
            check_scan("predict_dense", args,
                       scan_launch("predict_dense", args),
                       (order, choices, n))
            counts["predict_dense"] += 1
    for order, choices, n in PREDICT_EDGES:
        x, c, log2u, rsh = predict_edge_inputs(order, choices, n, order + n)
        rsh[0], rsh[-1] = 0, 32
        if rsh.shape[0] > 2:
            rsh[1] = 40
        args = (x, c, log2u, rsh, max(choices))
        check_scan("predict_dense", args, scan_launch("predict_dense", args),
                   (order, choices, n, "rshift 0, 32, 40"))
        counts["predict_dense"] += 1
    print(f"analysis_scans kernels against their plain versions at "
          f"{sum(counts.values())} edge cases, one launch each "
          f"({', '.join(f'{k} {v}' for k, v in counts.items())}): both "
          f"quantizer variants (margins included) and the predict cascade "
          f"bit-equal; levinson NaN and +-Inf in the "
          f"same places, silent and guard rows bit-equal, the same bits run "
          f"to run and in reversed rows, determined rows within "
          f"{rel:.3g} of the row's largest |value| (tolerance "
          f"{LEVINSON_RTOL:g})")
    return err


def scan_bound(name, args, clock_hz, dadd_cycles, ddiv_cycles=0.0):
    """(bound ms, "operations" | "bytes", chain ms) of one analysis_scans
    call: its operations over the issue rate (FP64 for the recursion and
    the quantizer, IMAD for the predict cascade, the multiply-adds that
    these inputs need) against its bytes over the memory rate (inputs read
    once, outputs written once), and its longest dependent chain at the
    probed latencies (0 for the predict cascade, whose sums are short
    beside its multiply-adds)."""
    if name == "levinson_durbin":
        ac, order = args[0], args[1]
        parcor = len(args) > 2 and args[2]
        rows = ac.numel() // (order + 1)
        # step k: k + 2 products and adds, the divide, ek (3), the tail (2)
        # and k + 2 updates (a multiply and an add each)
        ops = rows * sum(4 * (k + 2) + 6 for k in range(order))
        nbytes = 8 * rows * (order + 1 + order * (2 if parcor else 1))
        # a step of any design that keeps the divide and ek's update: the
        # divide, then ek's multiply, subtract and multiply (the next
        # divide waits for ek); the sums may run beside them
        chain = order * (ddiv_cycles + 3 * dadd_cycles)
        t_ops = ops / (FP64_OPS_PER_CLK * clock_hz)
    elif name in ("quantize_coefficients", "quantize_layer"):
        # one launch over every layer: the chain bound is the longest
        # layer's; the byte-exact variant adds the round margin's rint,
        # subtract and minimum a tap and writes two margins a row
        if name == "quantize_coefficients":
            orders = [c.shape[1] for c in args[0]]
            rows = args[0][0].shape[0]
        else:
            orders, rows = list(args[1]), args[0].shape[0]
        exact = name == "quantize_layer"
        taps = rows * sum(orders)
        # the chain, and |c|, max and the product
        ops = taps * (QUANT_CHAIN_STEPS + 2 + (3 if exact else 0))
        nbytes = taps * (8 + 4) + 4 * rows * len(orders) + (
            16 * rows if exact else 0)
        chain = max(orders) * QUANT_CHAIN_STEPS * dadd_cycles
        t_ops = ops / (FP64_OPS_PER_CLK * clock_hz)
    elif name == "unit_residual_select":
        # a multiply and an add a tap, sample and candidate (the winner's
        # second pass not counted); the input once (once for every ridge
        # where they share it), the coefficients, the winners' outputs;
        # the chain: the winner's longest sum of products
        x, params, log2u = args
        ridges, per_ridge, n = x.shape
        rows = ridges * per_ridge
        order = params[0].shape[1]
        ops = 2 * rows * n * sum(order >> v for v in log2u)
        nbytes = 8 * (n * (per_ridge if x.stride(0) == 0 else rows)
                      + rows * order * len(params)
                      + rows * (n + order + 1)) + 4 * rows
        chain = 2 * order * dadd_cycles
        t_ops = ops / (FP64_OPS_PER_CLK * clock_hz)
    elif name == "lpc_autocorr":
        # a multiply-add a product of a unit's lag (ns - l of them), one
        # fused instruction each (the kernel contracts them); the rows and
        # windows read once, every ac written once; the chain: the longest
        # sum
        x, splits = args
        rows, n = x.shape
        mads = 0
        for l2, lags, _ in splits:
            ns = n >> l2
            mads += (1 << l2) * sum(max(0, ns - lag) for lag in range(lags))
        ops = rows * mads
        nbytes = 8 * (rows * n + sum(n >> l2 for l2, _, w in splits
                                     if w is not None)
                      + rows * sum((1 << l2) * lags
                                   for l2, lags, _ in splits))
        chain = n * dadd_cycles / 32  # a stretch of t, then its butterfly
        t_ops = ops / (FP64_OPS_PER_CLK * clock_hz)
    elif name == "rice_search":
        # a shift, a max and an add a sample and order, and the code and
        # the finest sum a sample, at the IMAD rate (the parameter fits
        # left out); the plane read once, the orders and parameters
        # written once
        x, max_porder = args
        rows, n = x.shape
        ops = rows * n * (3 * (max_porder + 1) + 3)
        nbytes = 4 * rows * n + 4 * rows * (1 + (1 << max_porder))
        chain = 0
        t_ops = ops / IMAD_PER_S
    else:
        x, coefs, log2u = args[0], args[1], args[2]
        rows, n = x.shape
        order = coefs.shape[1]
        l2 = log2u.long().cpu()
        npu = order >> l2
        ns = n >> l2
        # samples past each unit's passthrough head, npu taps each
        macs = int(torch.sum((n - (n // ns) * npu) * npu))
        ops = macs
        nbytes = 4 * (2 * rows * n + rows * order + 2 * rows)
        chain = 0
        t_ops = ops / IMAD_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    chain_ms = 1e3 * chain / clock_hz
    if t_ops >= t_bytes:
        return 1e3 * t_ops, "operations", chain_ms
    return 1e3 * t_bytes, "bytes", chain_ms


def batch_blocks(tracks, count=64) -> torch.Tensor:
    """The first `count` blocks of the corpus as one [count, 2, SPB] int32
    batch on the card."""
    blocks = [t[:, b * SPB:(b + 1) * SPB] for t in tracks
              for b in range(t.shape[1] // SPB)]
    return torch.from_numpy(np.stack(blocks[:count])).cuda()


def scan_calls_phase(tracks, clock_hz, dadd_cycles, ddiv_cycles) -> dict:
    """Record every analysis_scans call of one 64-block preset-7 batch of
    the corpus (the main path's shapes), check each against its plain
    version and time both, beside the bound and the chain bound. Returns
    per kernel {max_abs_err, ms, plain_ms, bound_ms, bound_by, calls},
    summed over the batch's calls."""
    blocks = batch_blocks(tracks)
    enc = TorchEncoder(device="cuda")
    enc.set_encode_parameter(param())
    analyze = enc._analyze_fn(SPB)[0]
    analyze(blocks)  # warm: cuBLAS handles, the kernels' library
    calls = {k: [] for k in MAIN_SCANS}
    real = {k: getattr(AS, _SCAN_WRAPPER[k]) for k in MAIN_SCANS}

    def recorder(name):
        def rec(*args):
            calls[name].append(clone_args(args))
            return real[name](*args)
        return rec

    for k in MAIN_SCANS:
        setattr(AS, _SCAN_WRAPPER[k], recorder(k))
    try:
        analyze(blocks)
    finally:
        for k in MAIN_SCANS:
            setattr(AS, _SCAN_WRAPPER[k], real[k])
    torch.cuda.synchronize()
    require(len(calls["quantize_coefficients"]) == 1,
            "the batch did not quantize its layers in one call")
    return {name: time_scan_calls(name, calls[name], clock_hz, dadd_cycles,
                                  ddiv_cycles, "64-block batch")
            for name in MAIN_SCANS}


def unit_residual_phase(tracks, clock_hz, dadd_cycles) -> None:
    """The residual pass in one 128-block batch of the corpus (the
    benchmark's batch): its launches a batch at presets 7 and 0 (one a
    layer: 3 and 2), then the preset-7 layer-2 call (1,024 rows of 10,240
    samples, order 128, 8 candidate splits) checked against its plain
    version and timed beside the pass it replaced (the plain version on
    the card's routes), the loop route and its bound."""
    blocks = batch_blocks(tracks, 128)
    calls, launches = [], {}
    real = AS.unit_residual_select

    def rec(*args):
        calls.append(clone_args(args))
        return real(*args)

    for preset in (7, 0):
        enc = TorchEncoder(batch_blocks=128, device="cuda")
        enc.set_encode_parameter(param(preset))
        analyze = enc._analyze_fn(SPB)[0]
        analyze(blocks)  # warm
        torch.cuda.synchronize()
        before = AS.KERNEL_LAUNCHES["unit_residual_select"]
        AS.unit_residual_select = rec if preset == 7 else real
        try:
            analyze(blocks)
        finally:
            AS.unit_residual_select = real
        torch.cuda.synchronize()
        launches[preset] = AS.KERNEL_LAUNCHES["unit_residual_select"] - before
        layers = len(PRESETS[preset].layer_num_params)
        require(launches[preset] == layers,
                f"preset {preset}: {launches[preset]} unit_residual_select "
                f"launches in a batch of {layers} layers")
    args = calls[1]
    x, params, log2u = args
    shape = (tuple(x.shape), len(params), params[0].shape[1])
    rel, _, agree, rows = check_unit_residual(args, real(*args), shape)
    ms = min(kernel_ms(lambda: real(*args), reps=5) for _ in range(3))
    plain = {}
    for loop in (False, True):
        unit_residual_plain(x, params, log2u, loop)  # warm
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        unit_residual_plain(x, params, log2u, loop)
        end.record()
        torch.cuda.synchronize()
        plain[loop] = start.elapsed_time(end)
    b_ms, b_by, chain_ms = scan_bound("unit_residual_select", args, clock_hz,
                                      dadd_cycles)
    print(f"unit_residual_select: launches a 128-block batch {launches} "
          f"(preset: launches, one a layer); preset-7 layer 2 {shape}: "
          f"kernel {ms:.4f} ms, plain torch on the card's routes (the pass "
          f"it replaced) {plain[False]:.3f} ms, on the loop route "
          f"{plain[True]:.3f} ms, bound {b_ms:.4f} ms ({b_by}; "
          f"{100 * b_ms / ms:.1f} % of it reached), chain bound "
          f"{chain_ms:.4f} ms; picks agree on {agree} of {rows} rows, "
          f"losses within {rel:.3g}")


def lpc_autocorr_phase(tracks, clock_hz, dadd_cycles) -> None:
    """The windowed autocorrelation in one 128-block batch of the corpus
    (the benchmark's batch): its launches a batch at presets 7 and 0 (one
    a layer and one for the estimate: 4 and 3), then each preset-7 call
    checked against its plain version and timed beside it (the plain
    version on the card's routes: the pass the kernel replaced) and its
    bound."""
    blocks = batch_blocks(tracks, 128)
    calls, launches = [], {}
    real = AS.lpc_autocorr

    def rec(*args):
        calls.append(clone_args(args))
        return real(*args)

    for preset in (7, 0):
        enc = TorchEncoder(batch_blocks=128, device="cuda")
        enc.set_encode_parameter(param(preset))
        analyze = enc._analyze_fn(SPB)[0]
        analyze(blocks)  # warm
        torch.cuda.synchronize()
        before = AS.KERNEL_LAUNCHES["lpc_autocorr"]
        AS.lpc_autocorr = rec if preset == 7 else real
        try:
            analyze(blocks)
        finally:
            AS.lpc_autocorr = real
        torch.cuda.synchronize()
        launches[preset] = AS.KERNEL_LAUNCHES["lpc_autocorr"] - before
        want = 1 + len(PRESETS[preset].layer_num_params)
        require(launches[preset] == want,
                f"preset {preset}: {launches[preset]} lpc_autocorr launches "
                f"in a batch, not {want} (one a layer and the estimate)")
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for args in calls:
        shape = (tuple(args[0].shape), [(l2, lags) for l2, lags, _ in args[1]])
        rel, _, silent, units = check_lpc_autocorr(args, real(*args), shape)
        ms = min(kernel_ms(lambda: real(*args), reps=5) for _ in range(3))
        lpc_autocorr_plain(*args)  # warm
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        lpc_autocorr_plain(*args)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        b_ms, b_by, _ = scan_bound("lpc_autocorr", args, clock_hz,
                                   dadd_cycles)
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms)):
            total[k] += v
        print(f"  lpc_autocorr {shape}: kernel {ms:.4f} ms, plain torch on "
              f"the card's routes {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
              f"({b_by}; {100 * b_ms / ms:.1f} % of it reached); each lag "
              f"within {rel:.3g} of lag 0, {silent} of {units} units silent")
    print(f"lpc_autocorr: launches a 128-block batch {launches} (preset: "
          f"launches, one a layer and the estimate); the preset-7 batch's "
          f"{len(calls)} calls: kernel {total['ms']:.4f} ms, plain torch on "
          f"the card's routes (the pass it replaced) {total['plain_ms']:.3f}"
          f" ms, bound {total['bound_ms']:.4f} ms "
          f"({100 * total['bound_ms'] / total['ms']:.1f} % of it reached)")


def rice_search_phase(tracks, clock_hz, dadd_cycles) -> None:
    """The Rice parameter search in one 128-block batch of the corpus (the
    benchmark's batch): its launches a batch at presets 7 and 0 (one
    each), then each preset's call checked against its plain version and
    timed beside it (the torch ops the kernel replaced) and its bound."""
    blocks = batch_blocks(tracks, 128)
    real = AS.rice_search
    for preset in (7, 0):
        calls = []

        def rec(*args):
            calls.append(clone_args(args))
            return real(*args)

        enc = TorchEncoder(batch_blocks=128, device="cuda")
        enc.set_encode_parameter(param(preset))
        analyze = enc._analyze_fn(SPB)[0]
        analyze(blocks)  # warm
        torch.cuda.synchronize()
        before = AS.KERNEL_LAUNCHES["rice_search"]
        AS.rice_search = rec
        try:
            analyze(blocks)
        finally:
            AS.rice_search = real
        torch.cuda.synchronize()
        launches = AS.KERNEL_LAUNCHES["rice_search"] - before
        require(launches == 1 and len(calls) == 1,
                f"preset {preset}: {launches} rice_search launches in a "
                f"batch, not one")
        args = calls[0]
        check_exact("rice_search", real(*args), rice_search_plain(*args),
                    f"preset {preset}")
        ms = min(kernel_ms(lambda: real(*args), reps=20) for _ in range(3))
        plain_ms = min(cuda_ms(lambda: rice_search_plain(*args), reps=5)
                       for _ in range(3))
        b_ms, b_by, _ = scan_bound("rice_search", args, clock_hz,
                                   dadd_cycles)
        orders = torch.bincount(real(*args)[0].flatten(), minlength=11)
        print(f"rice_search preset {preset}, {tuple(args[0].shape)} "
              f"(one launch a 128-block batch): kernel {ms:.4f} ms, plain "
              f"torch (the ops it replaced) {plain_ms:.3f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}; {100 * b_ms / ms:.1f} % of it "
              f"reached); orders and parameters bit-equal; rows a best "
              f"order 0..10 {orders.tolist()}")


def clone_args(args):
    """A call's arguments with every tensor (also in a list) cloned."""
    def one(a):
        if isinstance(a, torch.Tensor):
            return a.clone()
        if isinstance(a, (list, tuple)) and a and isinstance(
                a[0], torch.Tensor):
            return [t.clone() for t in a]
        return a
    return tuple(one(a) for a in args)


def arg_shape(a):
    if isinstance(a, torch.Tensor):
        return tuple(a.shape)
    if isinstance(a, list) and a and isinstance(a[0], torch.Tensor):
        return [tuple(t.shape) for t in a]
    if isinstance(a, list) and a and isinstance(a[0], tuple):
        return [tuple(arg_shape(v) for v in t) for t in a]
    return a


def time_scan_calls(name, calls, clock_hz, dadd_cycles, ddiv_cycles,
                    where) -> dict:
    """Check each recorded call of kernel `name` against its plain version
    on the card and time both, beside its bound and chain bound; prints a
    line a call and one for the calls. Returns {max_abs_err, rel, ms,
    plain_ms, bound_ms, bound_by, chain_ms, calls, det, rows}, summed over
    the calls."""
    r = {"max_abs_err": 0.0, "rel": 0.0, "ms": 0.0, "plain_ms": 0.0,
         "bound_ms": 0.0, "chain_ms": 0.0, "calls": len(calls),
         "det": 0, "rows": 0}
    by = {"operations": 0.0, "bytes": 0.0}
    for args in calls:
        kernel = getattr(AS, _SCAN_WRAPPER[name])
        # the least of three timings: a host stall longer than the
        # spin lets the enqueue into one of them
        call_ms = min(kernel_ms(lambda: kernel(*args), reps=5)
                      for _ in range(3))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _SCAN_PLAIN[name](*args)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        shape = tuple(arg_shape(a) for a in args)
        rel, err, det, rows = check_scan(name, args, kernel(*args),
                                         shape)
        b_ms, b_by, c_ms = scan_bound(name, args, clock_hz, dadd_cycles,
                                      ddiv_cycles)
        for key, v in (("ms", call_ms), ("plain_ms", plain_ms),
                       ("bound_ms", b_ms), ("chain_ms", c_ms),
                       ("det", det), ("rows", rows)):
            r[key] += v
        r["rel"] = max(r["rel"], rel)
        r["max_abs_err"] = max(r["max_abs_err"], err)
        by[b_by] += b_ms
        print(f"  {name} {shape}: {call_ms:.4f} ms, plain torch "
              f"{plain_ms:.3f} ms, bound {b_ms:.6f} ms ({b_by})"
              + (f", chain bound {c_ms:.4f} ms" if c_ms else ""))
    r["bound_by"] = max(by, key=by.get)
    det = (f"; levinson off by at most {r['rel']:.3g} of the row's "
           f"largest |value| on {r['det']} of {r['rows']} rows (the "
           f"determined ones), {r['max_abs_err']:.3g} absolute"
           if name == "levinson_durbin" else
           f"; picks agree on {r['det']} of {r['rows']} rows (residuals "
           f"bit-equal there), losses within {r['rel']:.3g}"
           if name == "unit_residual_select" else
           f"; each lag within {r['rel']:.3g} of its unit's lag 0, "
           f"{r['det']} of {r['rows']} units silent and zero, the same bits"
           f" twice" if name == "lpc_autocorr" else ", bit-equal")
    chain = (f", chain bound {r['chain_ms']:.4f} ms "
             f"({100 * r['chain_ms'] / r['ms']:.1f} % of it reached)"
             if r["chain_ms"] else "")
    print(f"analysis_scans calls {name}: {r['calls']} calls in one "
          f"{where}{det}; kernel {r['ms']:.4f} ms, plain torch "
          f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.6f} ms "
          f"({r['bound_by']}, {100 * r['bound_ms'] / r['ms']:.2f} % of "
          f"it reached){chain}")
    return r


class PlainScans:
    """Within its `with`, the encode's loops take their plain torch
    versions on the card too (the public functions are swapped for them),
    so that a run can be compared with the kernels'."""

    def __init__(self, on: bool = True):
        self.on = on
        self._real = (A.levinson_durbin, A.quantize_layers, I._predict_dense,
                      A.unit_residual_select, A.unit_autocorrelations,
                      R.rice_search)

    def __enter__(self):
        if self.on:
            A.levinson_durbin = A._levinson_durbin_plain
            A.quantize_layers = A._quantize_layers_plain
            I._predict_dense = I._predict_dense_plain
            A.unit_residual_select = A._unit_residual_select_plain
            A.unit_autocorrelations = A._unit_autocorrelations_plain
            R.rice_search = R._rice_search_plain
        return self

    def __exit__(self, *exc):
        (A.levinson_durbin, A.quantize_layers, I._predict_dense,
         A.unit_residual_select, A.unit_autocorrelations,
         R.rice_search) = self._real


def stage_ops(blocks) -> dict:
    """The torch ops one batch's stages dispatch (views and allocations
    excluded: they launch nothing): pre_stage, each fit_stage, and the
    select and finish stages. A stage starts where its first function is
    entered (fit_layer, take_ridge), so the ridge tensor each fit_stage
    builds before its fit_layer counts with the stage before it."""
    from torch.utils._python_dispatch import TorchDispatchMode

    enc = TorchEncoder(device="cuda")
    enc.set_encode_parameter(param())
    analyze = enc._analyze_fn(SPB)[0]
    analyze(blocks)
    counts = {}
    stage = ["pre_stage"]
    real_fit, real_take = A.fit_layer, A.take_ridge

    def fit_layer(x, order, rv, *windows):
        stage[0] = f"fit_stage {order}"
        return real_fit(x, order, rv, *windows)

    def take_ridge(t, best):
        stage[0] = "select/finish"
        return real_take(t, best)

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func._schema.name
            if not (func.is_view or "empty" in name
                    or name == "aten::_local_scalar_dense"):
                counts[stage[0]] = counts.get(stage[0], 0) + 1
            return func(*args, **(kwargs or {}))

    A.fit_layer, A.take_ridge = fit_layer, take_ridge
    try:
        with Count():
            analyze(blocks)
    finally:
        A.fit_layer, A.take_ridge = real_fit, real_take
    return counts


def stream_blocks(data: bytes) -> list:
    """The bytes of each block of one stream, in order."""
    out, offset = [], HEADER_SIZE
    while offset < len(data):
        size = parse_block_header(data[offset:]).total_size
        out.append(data[offset:offset + size])
        offset += size
    return out


def scan_pairs_phase(tracks) -> None:
    """The plain -e corpus encode with the kernels against the same encode
    with the plain versions on the card: the torch ops one 64-block batch
    dispatches per stage, one profiled batch's device time against its
    wall time, then 5 alternating pairs (multiples, sizes, differing
    blocks; every stream lossless)."""
    blocks = batch_blocks(tracks)
    ops = {}
    for plain in (False, True):
        with PlainScans(plain):
            ops[plain] = stage_ops(blocks)
            enc = TorchEncoder(device="cuda")
            enc.set_encode_parameter(param())
            analyze = enc._analyze_fn(SPB)[0]
            top = []
            wall_ms, dev_ms, dev_launches = device_time(analyze, blocks,
                                                        top=top)
        label = "plain versions" if plain else "kernels"
        print(f"scans, one 64-block batch with the {label}: torch ops "
              + ", ".join(f"{k} {v}" for k, v in ops[plain].items())
              + f" ({sum(ops[plain].values())} in all); profiled wall "
              f"{wall_ms:.1f} ms, device {dev_ms:.2f} ms in {dev_launches} "
              f"launches ({100 * dev_ms / wall_ms:.1f} % busy); largest: "
              + ", ".join(f"{k[:48]} {v:.3f} ms" for k, v in top[:5]))
    print("scans, torch ops the loops dispatched in one batch "
          "(plain - kernels): " + ", ".join(
              f"{k} {ops[True][k] - ops[False].get(k, 0)}"
              for k in ops[True]))

    chans = [[t[0], t[1]] for t in tracks]
    lengths = [t.shape[1] for t in tracks]
    seconds = sum(lengths) / RATE
    multiples = {False: [], True: []}
    first = {}
    encs = {}
    for plain in (False, True):  # each captures its graphs in a warm run
        with PlainScans(plain):
            encs[plain] = TorchEncoder(device="cuda")
            encs[plain].set_encode_parameter(param())
            encs[plain].encode_many(chans, lengths)
    for turn in range(5):
        for plain in ((False, True) if turn % 2 == 0 else (True, False)):
            with PlainScans(plain):
                got, secs = timed(
                    lambda: encs[plain].encode_many(chans, lengths))
            multiples[plain].append(seconds / secs)
            if got != first.setdefault(plain, got) or turn == 0:
                for sig, data in zip(tracks, got):
                    require(lossless(sig, Decoder().decode_whole(data)),
                            "a scans-pairs stream is not lossless")
    sizes = {k: sum(len(d) for d in v) for k, v in first.items()}
    differ = total = 0
    for a, b in zip(first[False], first[True]):
        ba, bb = stream_blocks(a), stream_blocks(b)
        total += max(len(ba), len(bb))
        differ += sum(x != y for x, y in zip(ba, bb)) + abs(len(ba) - len(bb))
    require(abs(sizes[False] - sizes[True]) <= 0.001 * sizes[True],
            f"kernel and plain corpus sizes differ by more than 0.1 %: "
            f"{sizes[False]} vs {sizes[True]}")
    med = {k: float(np.median(v)) for k, v in multiples.items()}
    for plain in (False, True):
        v = multiples[plain]
        print(f"scans pairs, plain -e corpus encode with the "
              f"{'plain versions' if plain else 'kernels'}: multiples "
              f"{[round(m, 1) for m in v]}, median {med[plain]:.1f}x "
              f"({min(v):.1f}-{max(v):.1f}) realtime, {sizes[plain]} bytes, "
              "lossless")
    print(f"scans pairs: kernels / plain median ratio "
          f"{med[False] / med[True]:.3f}; {differ} of {total} blocks differ "
          f"between the two routes; sizes differ by "
          f"{sizes[False] - sizes[True]} bytes")


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


def autocorr_special(seg: torch.Tensor) -> torch.Tensor:
    """NaN, +-Inf, -0.0 and subnormal samples in [6, 2, ns] segments: NaN
    products (the shield's rerun), 0 * Inf, Inf - Inf sums, signed zeros
    and subnormal products."""
    ns = seg.shape[-1]
    seg[1, 0, 3] = float("nan")
    seg[1, 1, ns // 2] = float("inf")
    seg[2, 0, ::2] = float("inf")
    seg[2, 0, 1::2] = 0.0
    seg[2, 1, ::5] = -float("inf")
    seg[3, 0] = -0.0
    seg[3, 1, 1::3] = -0.0
    seg[4] *= 2.0 ** -1030
    seg[5, 0] *= 2.0 ** -530
    return seg


def autocorr_edge_cases():
    """autocorr_serial against its plain version, bit for bit, at the
    edges of its design, with its own choice of lags a thread and with each
    choice forced: odd rows (cp.async staging) and even ones (TMA bulk
    copies), rows that start off a 16-byte boundary, lags 1..129, nlags ==
    ns and == 1 and not a multiple of the lags a thread, rows shorter than
    a tile's window, segment counts that no CTA size divides, rows one
    short of, at and one past three tiles of the ring, and NaN, +-Inf,
    -0.0 and subnormal samples; then every call shape of a preset-7 fit at
    13 rows of 4 ridge terms. Returns (max abs difference, cases)."""
    err, n = 0.0, 0

    def check(seg, nlags, what):
        nonlocal err, n
        got = ES.autocorr_serial(seg, nlags)
        torch.cuda.synchronize()
        err = max(err, check_exact("autocorr_serial", got,
                                   ES.autocorr_serial_ref(seg, nlags), what))
        n += 1

    shapes = [(13, 1, 10240, 129), (5, 2, 81, 9), (3, 4, 64, 1),
              (7, 3, 130, 129), (2, 1, 16, 16), (13, 128, 80, 2),
              (5, 1, 6, 6), (3, 2, 10, 7), (4, 1, 50, 7), (131, 1, 80, 2),
              (131, 1, 641, 9), (3, 1, 23, 20), (2, 1, 2049, 129)]
    try:
        for k in (None,) + ES.AUTOCORR_K_CHOICES:
            ES._AUTOCORR_K_OVERRIDE = k
            for rows, units, ns, nlags in shapes:
                check(seg_inputs(rows, units, ns, rows + ns), nlags,
                      (k, rows, units, ns, nlags))
            for nlags in (9, 129):
                tile = ES.autocorr_plan(13, 10240, nlags, k)["tile"]
                for extra in (-1, 0, 1):
                    ns = 3 * tile + extra
                    check(seg_inputs(13, 1, ns, ns), nlags,
                          (k, "tiles", ns, nlags))
            for ns, nlags in ((80, 2), (641, 9), (2048, 129)):
                check(autocorr_special(seg_inputs(6, 2, ns, ns)), nlags,
                      (k, "special values", ns, nlags))
            seg = seg_inputs(9, 1, 1000, 3)
            flat = torch.empty(seg.numel() + 1, dtype=seg.dtype,
                               device="cuda")
            shifted = flat[1:].view(seg.shape)
            shifted.copy_(seg)
            require(shifted.data_ptr() % 16 == 8, "unaligned rows")
            check(shifted, 65, (k, "unaligned rows"))
    finally:
        ES._AUTOCORR_K_OVERRIDE = None
    for order in (4, 128, 16):
        u = 1
        while u <= order:
            check(seg_inputs(13 * 4, u, 10240 // u, u), order // u + 1,
                  ("preset 7", u, order))
            u *= 2
    return err, n


def levinson_rows(nseg, order, seed) -> torch.Tensor:
    """Autocorrelations of seeded segments after a ridge, on the card; row
    0 is a zero-signal row (|r0| < FLT_EPSILON), row 3 a tiny one."""
    seg = seg_inputs(nseg, 1, 4 * order + 16, seed)
    seg[3 % nseg] *= 1e-5
    ac = ES.autocorr_serial_ref(seg, order + 1)[:, 0].contiguous()
    ac[:, 0] *= 1.0 + 1.0 / 512.0
    return ac


def levinson_special(ac: torch.Tensor) -> torch.Tensor:
    """[8, order + 1] rows at the recursion's edges: a constant signal (ek
    exactly 0 after the first step, then 0 / -0), a pure tone, a NaN lag,
    +-Inf lags, r0 = +Inf, a zero row."""
    order = ac.shape[-1] - 1
    lags = torch.arange(order + 1, dtype=torch.float64, device=ac.device)
    ac[1] = 1.0
    ac[2] = torch.cos(0.3 * lags)
    ac[3, min(order, 3)] = float("nan")
    ac[4, 1] = float("inf")
    ac[5, order] = -float("inf")
    ac[6, 0] = float("inf")
    ac[7] = 0.0
    return ac


def levinson_edge_cases() -> list:
    """(kernel, args) of levinson_serial at the edges of its design: orders
    around each thread-path template (4, 8, 16, 32) and the warp path's
    slots (32-lane multiples), on 13 segments; every call shape of a
    preset-7 fit at 5 rows of `units` segments; the special rows at orders
    on both paths."""
    cases = []
    for order in (1, 2, 3, 4, 5, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65,
                  96, 97, 127, 128):
        cases.append(("levinson_serial", (levinson_rows(13, order, order),
                                          order)))
    for order in (4, 128, 16):
        u = 1
        while u <= order:
            cases.append(("levinson_serial", (levinson_rows(
                5 * u, order // u, u), order // u)))
            u *= 2
    for order in (2, 8, 31, 33, 128):
        cases.append(("levinson_serial", (levinson_special(levinson_rows(
            8, order, 7 * order)), order)))
    return cases


def abs_mean_edge_cases() -> list:
    """(kernel, args) of serial_abs_mean at the edges of its design: odd
    and even lengths (rows of odd length alternate on and off a 16-byte
    boundary), n = 1, start == n; the four call shapes of a preset-7 fit
    chunk at 3 rows; each rows-a-CTA bucket of the plan over several tiles
    with n < row_len; rows around three tiles of the ring; NaN, +-Inf, -0.0
    and subnormal samples; rows that start 8 bytes past a 16-byte
    boundary."""
    cases = []

    def add(x, start, n):
        cases.append(("serial_abs_mean", (x, start, n)))

    for rows, n, start in [(13 * 8, 10240, 1), (3, 77, 0), (130, 2048, 0),
                           (13, 77, 1), (5, 1, 0), (5, 1, 1), (7, 2, 1),
                           (4, 16, 16)]:
        add(seg_inputs(rows, 1, n, n)[:, 0].contiguous(), start, n)
    for lead, start in (((3, 3), 1), ((3, 8), 1), ((3, 5), 1), ((3,), 0)):
        x = seg_inputs(int(np.prod(lead)), 1, SPB, len(lead) + start)
        add(x.reshape(lead + (SPB,)), start, SPB)
    sms = ES.abs_mean_plan(1, 0, 3001)["sms"]
    for per_cta in (1, 2, 4, 8, 16, 32):
        for start in (0, 1):
            plan = ES.abs_mean_plan(per_cta * sms, start, 3001)
            require(plan["rows_per_cta"] == per_cta and plan["tiles"] > 1,
                    f"abs_mean plan {plan} for {per_cta} rows a CTA")
            add(seg_inputs(per_cta * sms, 1, 3003, per_cta)[:, 0]
                .contiguous(), start, 3001)
    for start in (0, 1):
        tile = ES.abs_mean_plan(13, start, SPB)["tile"]
        for extra in (-2, -1, 0, 1, 2):
            n = 3 * tile + start + extra
            require(ES.abs_mean_plan(13, start, n)["stages"] == 2,
                    "abs_mean tile edges: two stages")
            add(seg_inputs(13, 1, n, n)[:, 0].contiguous(), start, n)
    for n in (77, 2500):
        x = seg_inputs(6, 1, n, n)[:, 0].contiguous()
        x[0, 1] = float("nan")
        x[1, n // 2] = float("inf")
        x[1, n - 1] = -float("inf")
        x[2, ::3] = -0.0
        x[3] = -0.0
        x[4] *= 2.0 ** -1060
        x[5, n - 1] = float("nan")
        add(x, 0, n)
        add(x, 1, n)
    for row_len, n, start in ((1000, 1000, 1), (999, 999, 0),
                              (2600, 2599, 1)):
        x = seg_inputs(9, 1, row_len, row_len)[:, 0].contiguous()
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
        shifted = flat[1:].view(x.shape)
        shifted.copy_(x)
        require(shifted.data_ptr() % 16 == 8, "unaligned rows")
        add(shifted, start, n)
    return cases


def exact_kernel_phase() -> dict:
    """Each exact_serial kernel against its plain version at the edges of
    its design, one launch a call. Returns the max abs difference per
    kernel."""
    err = dict.fromkeys(ES.KERNELS, 0.0)
    err["autocorr_serial"], n_autocorr = autocorr_edge_cases()
    cases = levinson_edge_cases() + abs_mean_edge_cases()
    for rows, n, units, npu in [(13, 10240, 1, 128), (5, 384, 4, 8),
                                (3, 2048, 128, 1), (7, 300, 3, 5)]:
        x = seg_inputs(rows, 1, n, n + npu)[:, 0].contiguous()
        rng = np.random.default_rng(units + npu)
        prm = torch.from_numpy(rng.normal(0, 0.4, (rows, units, npu))).cuda()
        cases.append(("chain_predict", (x, prm)))
    counts = dict.fromkeys(ES.KERNELS, 0)
    for name, args in cases:
        before = ES.KERNEL_LAUNCHES[name]
        got = getattr(ES, name)(*args)
        torch.cuda.synchronize()
        shape = tuple(tuple(a.shape) if isinstance(a, torch.Tensor) else a
                      for a in args)
        require(ES.KERNEL_LAUNCHES[name] == before + 1,
                f"{name} at {shape}: not one launch")
        err[name] = max(err[name],
                        check_exact(name, got, _PLAIN[name](*args), shape))
        counts[name] += 1
    first_levinson = next(a for n, a in cases if n == "levinson_serial")
    zero_case = ES.levinson_serial(*first_levinson)[2]
    require(bool(zero_case[0]) and not bool(zero_case[1]),
            "the zero-signal row did not take the early-out")
    counts["autocorr_serial"] = n_autocorr
    print(f"exact_serial kernels bit-equal to their plain versions at "
          f"{sum(counts.values())} edge cases "
          f"({', '.join(f'{k} {v}' for k, v in counts.items())})")
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
    AS.KERNEL_LAUNCHES["quantize_layer"] = 0
    t0 = time.perf_counter()
    datas = enc.encode_many(chans, lengths)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ES.KERNEL_LAUNCHES)
    launches["quantize_layer"] = AS.KERNEL_LAUNCHES["quantize_layer"]
    for k in launches:
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
    # levinson_ matches levinson_thread_kernel<P> and levinson_warp_kernel
    names = {"autocorr_kernel": 0.0, "levinson_": 0.0,
             "abs_mean_kernel": 0.0, "chain_predict_kernel": 0.0,
             "quantize_kernel": 0.0}
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
    split = ", ".join(f"{k}{'*' if k.endswith('_') else ''} {v / 1e3:.3f} ms"
                      for k, v in names.items())
    print(f"exact-device profile: wall {wall_ms:.1f} ms profiled "
          f"({1e3 * unprofiled_wall:.1f} ms unprofiled), device "
          f"{device_ms:.3f} ms ({100 * device_ms / wall_ms:.1f} % busy): "
          f"{split}, copies {copy_us / 1e3:.3f} ms, other {other_us / 1e3:.3f}"
          f" ms in {n_other} launches")


def exact_bound(name: str, args, clock_hz: float,
                dadd_cycles: float = DADD_CYCLES):
    """(bound ms, "operations" | "bytes", chain ms, floor ms) of one kernel
    call: FP64 operations over the issue rate against bytes over the
    memory rate, the call's longest dependent chain of additions at
    dadd_cycles each, and the larger of the two (the least time the call
    can take)."""
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
    chain_ms = 1e3 * chain * dadd_cycles / clock_hz
    if t_ops >= t_bytes:
        bound_ms, by = 1e3 * t_ops, "operations"
    else:
        bound_ms, by = 1e3 * t_bytes, "bytes"
    return bound_ms, by, chain_ms, max(bound_ms, chain_ms)


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
    """Within its `with`, `exact_device._quantize_layers` (the fit's
    error-feedback quantizer over every layer: one kernel launch on the
    card) sums its host time into `seconds` and marks `inside` while it
    runs."""

    def __init__(self):
        self.seconds = 0.0
        self.inside = False
        self._real = ED._quantize_layers

    def _timed(self, *args):
        t0 = time.perf_counter()
        self.inside = True
        try:
            return self._real(*args)
        finally:
            self.inside = False
            self.seconds += time.perf_counter() - t0

    def __enter__(self):
        ED._quantize_layers = self._timed
        return self

    def __exit__(self, *exc):
        ED._quantize_layers = self._real


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


def exact_calls_phase(tracks, clock_hz: float, dadd_cycles: float) -> dict:
    """Record every exact_serial call of one 128-row fit chunk of the
    corpus (the main path's shapes), then check each against the plain
    version and time kernel, plain version and fast graph per call.
    Returns per kernel {max_abs_err, ms, plain_ms, bound_ms, bound_by,
    chain_ms, fast_ms, calls}, summed over the chunk's calls; chain_ms at
    the measured DADD latency."""
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
          f"kernels are not torch ops), {quant_ops} of them in "
          f"the quantizer ({100 * quant_ops / ops:.1f} %)")
    calls = {k: [] for k in ES.KERNELS}
    real = {k: getattr(ES, k) for k in ES.KERNELS}
    quant_calls = []
    real_quant = AS.quantize_layers_exact

    def recorder(name):
        def rec(*args):
            calls[name].append(tuple(
                a.clone() if isinstance(a, torch.Tensor) else a
                for a in args))
            return real[name](*args)
        return rec

    def quant_rec(*args):
        quant_calls.append(clone_args(args))
        return real_quant(*args)

    for k in ES.KERNELS:
        setattr(ES, k, recorder(k))
    AS.quantize_layers_exact = quant_rec
    try:
        fit(torch.from_numpy(rows).cuda())
    finally:
        for k in ES.KERNELS:
            setattr(ES, k, real[k])
        AS.quantize_layers_exact = real_quant
    torch.cuda.synchronize()
    require(len(quant_calls) == 1,
            "the fit chunk did not quantize its layers in one call")

    out = {}
    call_lines = {"autocorr_serial": autocorr_call_line,
                  "levinson_serial": levinson_call_line,
                  "serial_abs_mean": abs_mean_call_line}
    for name in ES.KERNELS:
        r = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
             "bound_ms": 0.0, "chain_ms": 0.0, "chain8_ms": 0.0,
             "floor_ms": 0.0, "fast_ms": 0.0, "calls": len(calls[name])}
        by = {"operations": 0.0, "bytes": 0.0}
        for args in calls[name]:
            kernel = getattr(ES, name)
            call_ms = kernel_ms(lambda: kernel(*args), reps=5)
            r["ms"] += call_ms
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
            b_ms, b_by, c_ms, f_ms = exact_bound(name, args, clock_hz,
                                                 dadd_cycles)
            r["bound_ms"] += b_ms
            r["chain_ms"] += c_ms
            r["floor_ms"] += f_ms
            r["chain8_ms"] += exact_bound(name, args, clock_hz)[2]
            by[b_by] += b_ms
            if name in call_lines:
                call_lines[name](args, call_ms, b_ms, b_by, c_ms)
        r["bound_by"] = max(by, key=by.get)
        out[name] = r
        print(f"exact-device calls {name}: {r['calls']} calls in one "
              f"{rows.shape[0]}-row chunk, bit-equal; kernel "
              f"{r['ms']:.4f} ms, plain torch {r['plain_ms']:.3f} ms, fast "
              f"graph {r['fast_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}, {100 * r['bound_ms'] / r['ms']:.1f} % of "
              f"it reached), chain bound {r['chain_ms']:.4f} ms at the "
              f"measured {dadd_cycles:.2f} cycles a DADD "
              f"({r['chain8_ms']:.4f} ms at {DADD_CYCLES}); the calls' "
              f"floors (the larger of the two a call) {r['floor_ms']:.4f} ms, "
              f"{100 * r['floor_ms'] / r['ms']:.1f} % of it reached")
    out["quantize_layer"] = time_scan_calls(
        "quantize_layer", quant_calls, clock_hz, dadd_cycles, 0.0,
        f"{rows.shape[0]}-row fit chunk")
    return out


def autocorr_call_line(args, ms, bound_ms, bound_by, chain_ms) -> None:
    """One autocorr_serial call of the chunk: its shape, the kernel's plan
    (lags a thread, CTA size, CTAs, CTAs and warps an SM holds at once),
    its time beside its bound and chain bound, and its time with each
    choice of lags a thread forced."""
    seg, nlags = args
    ns = seg.shape[-1]
    nseg = seg.numel() // ns
    p = ES.autocorr_plan(nseg, ns, nlags)
    warps = p["threads"] // 32
    resident = min(p["ctas"], p["ctas_per_sm"] * p["sms"])
    forced = []
    try:
        for k in ES.AUTOCORR_K_CHOICES:
            ES._AUTOCORR_K_OVERRIDE = k
            k_ms = kernel_ms(lambda: ES.autocorr_serial(*args), reps=5)
            forced.append(f"{k_ms:.4f}")
    finally:
        ES._AUTOCORR_K_OVERRIDE = None
    print(f"  autocorr_serial [{nseg}, {ns}] x {nlags} lags: K {p['k']}, "
          f"{p['threads']} threads x {p['ctas']} CTAs, tile {p['tile']} x "
          f"{p['stages']} stages, {p['smem_bytes']} B shared, "
          f"{p['ctas_per_sm']} CTAs ({p['ctas_per_sm'] * warps} warps) an "
          f"SM can hold, {resident * warps / p['sms']:.2f} warps an SM in "
          f"this call; {ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}), chain bound {chain_ms:.4f} ms; K "
          f"{'/'.join(map(str, ES.AUTOCORR_K_CHOICES))} forced: "
          f"{'/'.join(forced)} ms")


def levinson_call_line(args, ms, bound_ms, bound_by, chain_ms) -> None:
    """One levinson_serial call of the chunk: its shape, the kernel's plan
    (one warp or one thread a segment, the thread path's template order,
    CTA size, CTAs, warps an SM), its time beside its bound and chain
    bound."""
    ac, order = args
    nseg = ac.numel() // (order + 1)
    p = ES.levinson_plan(nseg, order)
    warps = p["threads"] // 32
    resident = min(p["ctas"], p["ctas_per_sm"] * p["sms"])
    path = ("one warp a segment" if p["warp"] else
            f"one thread a segment (template order {p['max_order']})")
    print(f"  levinson_serial [{nseg}] x order {order}: {path}, "
          f"{p['threads']} threads x {p['ctas']} CTAs, {p['smem_bytes']} B "
          f"shared, {resident * warps / p['sms']:.2f} warps an SM in this "
          f"call; {ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), chain "
          f"bound {chain_ms:.4f} ms")


def abs_mean_call_line(args, ms, bound_ms, bound_by, chain_ms) -> None:
    """One serial_abs_mean call of the chunk: its shape, the kernel's plan
    (rows a CTA, tile, stages, CTAs, warps an SM), its time beside its
    bound and chain bound."""
    rows, start, n = args
    nrows = rows.numel() // rows.shape[-1]
    p = ES.abs_mean_plan(nrows, start, n)
    resident = min(p["ctas"], p["ctas_per_sm"] * p["sms"])
    print(f"  serial_abs_mean {list(rows.shape)} from {start}: "
          f"{p['rows_per_cta']} rows a CTA (one warp) x {p['ctas']} CTAs, "
          f"tile {p['tile']} x {p['stages']} stages ({p['tiles']} tiles a "
          f"row), {p['smem_bytes']} B shared, {resident / p['sms']:.2f} "
          f"warps an SM in this call; {ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}), chain bound {chain_ms:.4f} ms")


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
        enc.encode_whole([sig[0], sig[1]], sig.shape[1])  # the captures
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
    require(torch.equal(sharded, plain["packed"].cpu()),
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


# -- the slim transfers and the matrix-unit routes ----------------------------


PACK_WIDTHS = (10, 12, 14, 18, 20, 24, 30)


def packing_phase() -> None:
    """pack_plane_words on the card against the CPU, bit for bit, and
    native.unpack_bits as its inverse."""
    rng = np.random.default_rng(14)
    n = SPB + 7  # ragged for every group size
    x = rng.integers(-2**31, 2**31, (128, n), dtype=np.int64)
    x = x.astype(np.int32)
    x[0, 0], x[1, -1] = -2**31, 2**31 - 1
    on_card = torch.from_numpy(x).cuda()
    for w in PACK_WIDTHS:
        card = bitpack.pack_plane_words(on_card, w).cpu()
        require(torch.equal(card, bitpack.pack_plane_words(
            torch.from_numpy(x), w)), f"pack_plane_words at W={w}: the "
            "card's words differ from the CPU's")
        g, _ = bitpack.pack_geometry(w)
        sign = 1 << (w - 1)
        low = ((x.astype(np.int64) & ((1 << w) - 1)) ^ sign) - sign
        back = native.unpack_bits(card.numpy(), w, -(-n // g) * g)[:, :n]
        require(np.array_equal(back, low),
                f"native.unpack_bits does not invert W={w}")
    print(f"packing: pack_plane_words on the card bit-equal to the CPU at W "
          f"{list(PACK_WIDTHS)} on 128 x {n} int32 rows with both int32 "
          "extremes; native.unpack_bits inverts each")


def copy_phase(tracks) -> None:
    """CUDA-event time of one 64-block batch's packed copy to pinned host
    memory beside a copy of its int32 residual tensor (both exist on the
    card after the batch's stages), in alternating turns."""
    enc = TorchEncoder(device="cuda")
    enc.set_encode_parameter(param())
    blocks = np.stack([tracks[0][:, b * SPB:(b + 1) * SPB]
                       for b in range(64)]).astype(np.int16)
    W = E._res_pack_width(16)
    out = enc._analyze_fn(SPB)[0](torch.from_numpy(blocks).cuda(), W)
    packed, residual = out["packed"], out["residual"].contiguous()
    to_packed = torch.empty(packed.shape, dtype=torch.int32, pin_memory=True)
    to_int32 = torch.empty(residual.shape, dtype=torch.int32,
                           pin_memory=True)
    times = {"packed": [], "int32": []}
    for _ in range(5):
        times["packed"].append(cuda_ms(
            lambda: to_packed.copy_(packed, non_blocking=True), reps=20))
        times["int32"].append(cuda_ms(
            lambda: to_int32.copy_(residual, non_blocking=True), reps=20))
    med = {k: float(np.median(v)) for k, v in times.items()}
    nbytes = {"packed": packed.numel() * 4, "int32": residual.numel() * 4}
    print(f"encode copy, one 64-block batch at W {W}: packed (side columns "
          f"+ W-bit plane) {nbytes['packed']} bytes in {med['packed']:.4f} "
          f"ms ({nbytes['packed'] / med['packed'] / 1e6:.1f} GB/s), int32 "
          f"residual {nbytes['int32']} bytes in {med['int32']:.4f} ms "
          f"({nbytes['int32'] / med['int32'] / 1e6:.1f} GB/s); medians of 5 "
          f"turns of 20 copies: packed {times['packed']}, int32 "
          f"{times['int32']}")


def forced_overflow_phase(tracks, datas) -> None:
    """A 6-bit residual class: every live block's int32 rows are fetched
    from the card, and the streams equal phase 4's. Then a 6-bit download:
    every row is flagged and fetched again at int32; lossless."""
    chans = [[t[0], t[1]] for t in tracks]
    lengths = [t.shape[1] for t in tracks]
    classes = E._res_width_classes
    E._res_width_classes = lambda bps: (6,)
    try:
        enc = TorchEncoder(device="cuda")
        enc.set_encode_parameter(param())
        got, secs = timed(lambda: enc.encode_many(chans, lengths))
    finally:
        E._res_width_classes = classes
    require(got == datas, "the forced-overflow encode differs from phase 4")
    require(enc.overflow_rows > 0, "no overflow row was fetched at W=6")
    print(f"forced overflow (W 6): streams equal phase 4's, overflow rows "
          f"fetched {enc.overflow_rows}, {enc.bytes_to_host} bytes to the "
          f"host, encode {secs:.3f} s")

    width = torch_decoder._download_width
    torch_decoder._download_width = lambda bps: 6
    try:
        dec = TorchDecoder(device="cuda")
        S.KERNEL_LAUNCHES = 0
        decoded, secs = timed(lambda: dec.decode_many(datas))
        launches = S.KERNEL_LAUNCHES
    finally:
        torch_decoder._download_width = width
    require(launches > 0, "the 6-bit download decode launched no kernel")
    require(dec.flagged_rows > 0, "no row was flagged at a 6-bit download")
    for sig, out in zip(tracks, decoded):
        require(lossless(sig, out), "the 6-bit download decode is not "
                                    "lossless")
    print(f"forced 6-bit download: lossless, flagged rows {dec.flagged_rows}"
          f", download chunks {dec.download_chunks}, down {dec.bytes_down} "
          f"bytes, up {dec.bytes_up} bytes, decode {secs:.3f} s, kernel "
          f"launches {launches}")


def device_time(fn, *args, top=None):
    """(wall ms, device ms, device launches) of one fn(*args) under
    torch.profiler, the card synchronised after it; with a list as `top`,
    its (name, device ms) of every kernel, largest first, are put in it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    dev_us = launches = 0
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            dev_us += ev.self_device_time_total
            launches += ev.count
            kernels.append((ev.key, ev.self_device_time_total / 1e3))
    if top is not None:
        top.extend(sorted(kernels, key=lambda kv: -kv[1]))
    return wall_ms, dev_us / 1e3, launches


def routes_phase(tracks) -> None:
    """The matrix-unit routes against the lag/FFT routes on the card: the
    fit stages of one 64-block batch (CUDA-event span, device time, torch
    ops), then the plain -e corpus encode in 5 alternating pairs."""
    preset = PRESETS[PRESET]
    ridges = preset.ridge_terms
    blocks = np.stack([tracks[1][:, b * SPB:(b + 1) * SPB]
                       for b in range(64)])
    sig = I.normalize_to_float(torch.from_numpy(blocks).cuda(), 16,
                               torch.float64)
    sig_r = sig.unsqueeze(0).expand((len(ridges),) + tuple(sig.shape))
    rv = torch.tensor(ridges, dtype=torch.float64, device="cuda").reshape(
        len(ridges), 1, 1, 1)

    def fit(x):
        for order in preset.layer_num_params:
            _log2u, _flat, x, _loss = A.fit_layer(x, order, rv)
        return x

    chans = [[t[0], t[1]] for t in tracks]
    lengths = [t.shape[1] for t in tracks]
    seconds = sum(lengths) / RATE
    warm = make_track(2 * SPB / RATE, 96)
    names = {True: "matmul", False: "lag/FFT"}
    saved = A._MATMUL_ROUTES_OVERRIDE
    multiples = {True: [], False: []}
    sizes = {}
    try:
        for route in (True, False):
            A._MATMUL_ROUTES_OVERRIDE = route
            fit(sig_r)  # warm: cuFFT plans, cuBLAS handles
            enc = TorchEncoder(device="cuda")
            enc.set_encode_parameter(param())
            enc.encode_many([[warm[0], warm[1]]], [warm.shape[1]])
            span_ms = cuda_ms(lambda: fit(sig_r), reps=3)
            wall_ms, dev_ms, dev_launches = device_time(fit, sig_r)
            ops = count_ops(fit, sig_r)[0]
            print(f"routes, fit stages of one 64-block batch (preset "
                  f"{PRESET}, 4 ridges): {names[route]}: CUDA-event span "
                  f"{span_ms:.2f} ms, profiled wall {wall_ms:.1f} ms, device "
                  f"{dev_ms:.2f} ms in {dev_launches} launches, {ops} torch "
                  "ops")
        encs = {}
        for route in (True, False):  # each captures its graphs in a warm run
            A._MATMUL_ROUTES_OVERRIDE = route
            encs[route] = TorchEncoder(device="cuda")
            encs[route].set_encode_parameter(param())
            encs[route].encode_many(chans, lengths)
        for turn in range(5):
            for route in ((True, False) if turn % 2 == 0 else (False, True)):
                A._MATMUL_ROUTES_OVERRIDE = route
                got, secs = timed(
                    lambda: encs[route].encode_many(chans, lengths))
                multiples[route].append(seconds / secs)
                if route not in sizes:
                    sizes[route] = sum(len(d) for d in got)
                    for sig, data in zip(tracks, got):
                        require(lossless(sig, Decoder().decode_whole(data)),
                                f"{names[route]} stream is not lossless")
    finally:
        A._MATMUL_ROUTES_OVERRIDE = saved
    med = {r: float(np.median(v)) for r, v in multiples.items()}
    default = A._use_matmul_routes(torch.zeros(1, device="cuda"))
    for route in (True, False):
        print(f"routes, plain -e corpus encode, {names[route]}: multiples "
              f"{[round(m, 1) for m in multiples[route]]}, median "
              f"{med[route]:.1f}x realtime, {sizes[route]} bytes (lossless)")
    print(f"routes: matmul / lag-FFT median ratio "
          f"{med[True] / med[False]:.3f}; the card's default route is "
          f"{names[default]}")


def corpus_tool_phase(tracks, tmp: pathlib.Path) -> None:
    """The corpus encode tool (linne_tpu_torch.tools.encode_corpus -m 7) on
    a WAV corpus of three format groups, in a subprocess on the card and
    over ["cuda:0", "cuda:0"]: every file lossless under the host Decoder,
    both runs byte-equal, and equal to an in-process
    TorchEncoder(batch_blocks=128).encode_many of each group, whose
    analysis_scans launches are counted from 0."""
    wav_dir = tmp / "corpus"
    wav_dir.mkdir()
    for i, t in enumerate(tracks):  # phase 4's: stereo 16-bit 44.1 kHz
        write_wav(str(wav_dir / f"stereo44_{i}.wav"), t, RATE, 16)
    for i, seconds in enumerate((20.0, 12.5)):  # mono 24-bit 48 kHz
        mono = make_track(seconds, 20 + i)[:1] * 256
        write_wav(str(wav_dir / f"mono24_{i}.wav"), mono, 48000, 24)
    # 661,500 samples: 64 blocks and a 6,940-sample tail
    write_wav(str(wav_dir / "stereo48_tail.wav"), make_track(15.0, 30),
              48000, 16)
    groups = {}  # (channels, bps, rate) -> [(file name, samples)]
    for wav in sorted(wav_dir.glob("*.wav")):
        fmt, samples = read_wav(str(wav))
        groups.setdefault(
            (fmt.num_channels, fmt.bits_per_sample, fmt.sampling_rate),
            []).append((wav.stem + ".lnn", samples))
    require(len(groups) == 3, f"{len(groups)} format groups, not 3")

    def tool(out: pathlib.Path, *extra) -> dict:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "linne_tpu_torch.tools.encode_corpus",
             str(wav_dir), str(out), "-m", "7", *extra], cwd=ROOT,
            capture_output=True, text=True, timeout=300)
        require(proc.returncode == 0, f"encode_corpus {extra} exited "
                f"{proc.returncode}: {proc.stderr[-3000:]}")
        print(f"corpus tool {' '.join(extra) or '(--device cuda)'}: "
              f"{proc.stdout.strip()}; {time.perf_counter() - t0:.1f} s "
              "with the process's start")
        return {p.name: p.read_bytes() for p in out.glob("*.lnn")}

    one = tool(tmp / "one")
    split = tool(tmp / "split", "--devices", "cuda:0,cuda:0")

    for k in AS.KERNELS:
        AS.KERNEL_LAUNCHES[k] = 0
    want = {}
    for (nch, bps, rate), members in groups.items():
        enc = TorchEncoder(batch_blocks=128, device="cuda")
        enc.set_encode_parameter(EncodeParameter(
            num_channels=nch, bits_per_sample=bps, sampling_rate=rate,
            preset=7, ch_process_method=(CH_PROCESS_MS if nch >= 2
                                         else CH_PROCESS_NONE)))
        datas = enc.encode_many([list(s) for _, s in members],
                                [s.shape[1] for _, s in members])
        want.update((name, d) for (name, _), d in zip(members, datas))
    torch.cuda.synchronize()
    launches = {k: AS.KERNEL_LAUNCHES[k] for k in MAIN_SCANS}
    for k, v in launches.items():
        require(v > 0, f"the corpus groups' encode did not launch {k}")
    require(sorted(one) == sorted(want),
            f"the tool wrote {sorted(one)}, not {sorted(want)}")
    require(split == one, "the tool's --devices cuda:0,cuda:0 files differ "
                          "from its one-device files")
    require(one == want, "the tool's files differ from TorchEncoder("
                         "batch_blocks=128).encode_many of each group")
    for members in groups.values():
        for name, samples in members:
            require(lossless(samples, Decoder().decode_whole(one[name])),
                    f"corpus tool file {name} is not lossless")
    print(f"corpus tool: {len(one)} files in {len(groups)} format groups "
          f"({', '.join(f'{k}: {len(m)}' for k, m in groups.items())}), "
          "lossless under the host Decoder, the device list's bytes and "
          "encode_many's; in-process analysis_scans launches "
          f"{launches}")


# the bench's rows (linne_tpu_torch/bench.py), each with _cuda; RATE_ROWS
# also come as _min and _max
BENCH_RATE_ROWS = (
    "mode7_encode_realtime_x", "encode_msamples_s",
    "decode_mode0_realtime_x", "decode_mode7_realtime_x",
    "decode_mode7_msamples_s", "corpus_encode_realtime_x",
    "mode7_a2_encode_realtime_x", "mode7_l_encode_realtime_x",
    "corpus_decode_realtime_x", "corpus_decode_msamples_s",
    "decode_launch_floor_ms", "decode_pooled_rows_64_msamples_s",
    "decode_pooled_rows_256_msamples_s", "decode_pooled_rows_1024_msamples_s",
    "decode_underload_native_msamples_s",
    "decode_underload_device_msamples_s",
    "exact_host_encode_mode0_realtime_x",
    "exact_device_encode_mode0_realtime_x", "exact_device_corpus_realtime_x",
    "exact_host_encode_mode7_realtime_x_short",
    "exact_device_encode_mode7_realtime_x",
    "exact_device_corpus_mode7_realtime_x")
BENCH_ROWS = (
    "decode_mode0_vs_c_ref_hw", "decode_mode7_vs_c_ref_hw",
    "corpus_encode_bytes", "mode7_a2_encode_bytes", "mode7_l_encode_bytes",
    "exact_device_guard_total", "exact_device_mode7_guard_total",
    # rows near a decision boundary in the data; guard_phase holds each
    # of the card's flags to the CPU's
    "exact_device_mode7_guard_flagged",
    *(f"exact_device_mode{p}_{k}_s" for p in (0, 7)
      for k in ("framing", "fit_enqueue", "row_wait", "split_wall")))
BENCH_TRUE = ("exact_device_byte_identical",
              "exact_device_mode7_byte_identical")
BENCH_ZERO = ("exact_device_guard_flagged",)
# kernels each row must have launched
BENCH_LAUNCHES = {
    "mode7_encode_realtime_x": MAIN_SCANS,
    "corpus_encode_realtime_x": MAIN_SCANS,
    "corpus_decode_realtime_x": ("synthesize_rows",),
    "decode_pooled_rows_1024_msamples_s": ("synthesize_rows",),
    "decode_underload_device_msamples_s": ("synthesize_rows",),
    "exact_device_corpus_mode7_realtime_x": ES.KERNELS + ("quantize_layer",),
    "exact_device_corpus_realtime_x": ES.KERNELS + ("quantize_layer",),
}
BENCH_TIMEOUT = 420


def bench_phase() -> None:
    """python -m linne_tpu_torch.bench --reps 3 in a subprocess: every row
    present and finite, the byte-exact rows identical to the host oracle
    with no row flagged, and the kernels of each path launched."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "linne_tpu_torch.bench", "--reps", "3"],
        cwd=ROOT, capture_output=True, text=True, timeout=BENCH_TIMEOUT)
    wall = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        if line.startswith("# "):
            print(f"bench {line[2:]}")
    require(proc.returncode == 0, f"the bench exited {proc.returncode}: "
                                  f"{proc.stderr[-3000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    sfx = "_cuda"
    for row in BENCH_RATE_ROWS:
        lo, mid, hi = (result.get(f"{row}{sfx}{m}")
                       for m in ("_min", "", "_max"))
        require(all(isinstance(v, (int, float)) and np.isfinite(v)
                    and v > 0 for v in (lo, mid, hi)),
                f"bench row {row}: {lo}, {mid}, {hi}")
        print(f"bench {row}{sfx}: median {mid!r} (min {lo!r}, max {hi!r})")
    for row in BENCH_ROWS + BENCH_ZERO:
        value = result.get(row + sfx)
        require(isinstance(value, (int, float)) and np.isfinite(value),
                f"bench row {row}: {value}")
        print(f"bench {row}{sfx}: {value!r}")
    for row in BENCH_TRUE:
        require(result.get(row + sfx) is True, f"bench row {row} is not true")
        print(f"bench {row}{sfx}: True")
    for row in BENCH_ZERO:
        require(result[row + sfx] == 0, f"bench row {row} is not 0")
    for row, kernels in BENCH_LAUNCHES.items():
        counts = result["launches"].get(row + sfx, {})
        for k in kernels:
            require(counts.get(k, 0) > 0, f"bench row {row} did not launch "
                                          f"{k}: {counts}")
    require(result["metric"] == "mode7_encode_realtime_x" + sfx
            and result["value"] == result["mode7_encode_realtime_x" + sfx],
            "the bench's headline is not its mode7_encode row")
    print(f"bench: {len(BENCH_RATE_ROWS)} timed rows (3 reps each after a "
          f"warm run, every rep's output hashed against the warm run's) and "
          f"{len(BENCH_ROWS + BENCH_TRUE + BENCH_ZERO)} more in {wall:.1f} s; "
          f"headline {result['value']!r}x realtime on {result['card']}")


def guard_phase() -> None:
    """The rows the byte-exact guard flags on the bench's preset-7 corpus
    (96 x 4-block tracks of bench.make_signal): a flag sends a row whose
    decision margin is under the guard's bound to the host oracle. Each
    row flagged on the card must have the CPU fit's margins bit for bit,
    so that the flag comes from the data, not from the card's arithmetic;
    the streams must be the host oracle's."""
    tlen, ntracks = 4 * SPB, 96
    sig = bench.make_signal(tlen * ntracks)
    tracks = [[sig[0, i * tlen:(i + 1) * tlen], sig[1, i * tlen:(i + 1) * tlen]]
              for i in range(ntracks)]
    p = param()
    enc = DE.DeviceExactEncoder(device="cuda")
    enc.set_encode_parameter(p)
    last, flagged = [None], []
    real_fetch, real_flag = enc._overlapped_fit, enc._row_flagged

    def fetch(*args):
        get_row = real_fetch(*args)

        def row_of(r):
            last[0] = r
            return get_row(r)
        return row_of

    def flag(row):
        hit = real_flag(row)
        if hit:
            flagged.append((last[0], np.asarray(row["margins"], np.float64)))
        return hit

    enc._overlapped_fit, enc._row_flagged = fetch, flag
    datas = enc.encode_many(tracks, [tlen] * ntracks)
    require(len(flagged) == enc.guard_rows_flagged,
            f"{len(flagged)} flags seen, {enc.guard_rows_flagged} counted")
    preset = PRESETS[PRESET]
    fit = ED.build_fit_fn(preset.layer_num_params, preset.ridge_terms, SPB,
                          16, LPC_COEF_BITWIDTH)
    for r, margins in flagged:
        (ti, bi), ch = divmod(r // 2, 4), r % 2
        plane = DE.preemph_plane(
            p, [c[bi * SPB:(bi + 1) * SPB] for c in tracks[ti]], SPB)
        cpu = fit(torch.from_numpy(plane[ch:ch + 1]))["margins"][0].numpy()
        require(np.array_equal(cpu.view(np.int64), margins.view(np.int64)),
                f"flagged row {r}: card margins {margins.tolist()}, CPU "
                f"{cpu.tolist()}")
        print(f"guard: row {r} (track {ti}, block {bi}, channel {ch}) "
              f"flagged, margins {margins.tolist()} (bounds "
              f"{DE._MARGIN_REL}, {DE._MARGIN_REL}, {DE._MARGIN_ABS}), the "
              "CPU fit's bit for bit")
    for ti in sorted({r // 2 // 4 for r, _ in flagged}):
        oracle = ExactEncoder()
        oracle.set_encode_parameter(p)
        require(datas[ti] == oracle.encode_whole(tracks[ti], tlen),
                f"track {ti} of the guard corpus differs from the host "
                "oracle's")
    print(f"guard: {len(flagged)} of {enc.guard_rows_total} rows of the "
          "bench's preset-7 corpus flagged, each as on the CPU; the streams "
          "of their tracks the host oracle's")


HOSTILE_SPB = 2560
HOSTILE_LEN = 2 * HOSTILE_SPB + 777  # two full blocks and a tail
HOSTILE_MUTATIONS = 400


def hostile_streams() -> list:
    """(name, stream) of the port's encoder on the card: stereo 16-bit at
    presets 0, 2 and 7, and a mono 24-bit track at preset 7, each two
    2560-sample blocks and a tail."""
    out = []
    for preset in (0, 2, 7):
        sig = make_track(1.0, 100 + preset)[:, :HOSTILE_LEN]
        enc = TorchEncoder(device="cuda")
        enc.set_encode_parameter(EncodeParameter(
            num_channels=2, bits_per_sample=16, sampling_rate=RATE,
            num_samples_per_block=HOSTILE_SPB, preset=preset,
            ch_process_method=CH_PROCESS_MS))
        out.append((f"stereo16-p{preset}",
                    enc.encode_whole([sig[0], sig[1]], HOSTILE_LEN)))
    mono = make_track(1.0, 107)[:1, :HOSTILE_LEN] * 256  # 24-bit range
    enc = TorchEncoder(device="cuda")
    enc.set_encode_parameter(EncodeParameter(
        num_channels=1, bits_per_sample=24, sampling_rate=RATE,
        num_samples_per_block=HOSTILE_SPB, preset=7,
        ch_process_method=CH_PROCESS_NONE))
    out.append(("mono24-p7", enc.encode_whole([mono[0]], HOSTILE_LEN)))
    return out


def hostile_phase(tracks, datas, card: str) -> int:
    """Hostile streams through TorchDecoder on the card and the host
    Decoder, CRC checking off: for each stream of hostile_streams, 400
    seeded mutations (1-5 bytes at offset 30 or later), its truncations
    every 97 bytes, its corrupt num_samples header, and its first compress
    block rewritten with more units than taps and with rshift 0 in one
    channel (tests/torch_hostile_streams.py). Both decoders must raise a
    FormatError, or give the same samples. Every synthesize_rows launch of
    the sweep is recorded and held bit for bit to synthesize_rows_ref on
    the card; then phase 4's streams must decode to phase 4's samples.
    Returns the max abs difference."""
    spec = importlib.util.spec_from_file_location(
        "torch_hostile_streams", ROOT / "tests" / "torch_hostile_streams.py")
    H = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(H)

    t0 = time.perf_counter()
    cfg = DecoderConfig(check_crc=False)
    inputs = []
    for seed, (name, data) in enumerate(hostile_streams()):
        inputs += [(name, "mutation", m) for m in
                   H.mutations(data, HOSTILE_MUTATIONS, seed)]
        inputs += [(name, "truncation", t) for t in H.truncations(data)]
        inputs += [(name, "num_samples", H.giant_num_samples(data)),
                   (name, "units_above_order", H.units_above_order(data)),
                   (name, "rshift_zero", H.rshift_zero(data))]
    calls = []
    real = torch_decoder.synthesize_rows

    def recording(x, c, rs):
        x = x.clone()  # the decoder writes the result over its input
        y = real(x, c, rs)
        calls.append((x, c.clone(), rs.clone(), y.clone()))
        return y

    samples = raised = flagged = 0
    S.KERNEL_LAUNCHES = 0
    torch_decoder.synthesize_rows = recording
    try:
        for i, (name, kind, data) in enumerate(inputs):
            try:
                want = Decoder(cfg).decode_whole(data)
            except FormatError:
                want = None
            dec = TorchDecoder(cfg, device="cuda")
            try:
                got = dec.decode_whole(data)
            except FormatError:
                got = None
            # an asynchronous kernel fault lands in its own input
            torch.cuda.synchronize()
            flagged += dec.flagged_rows
            what = f"{name}, {kind} input {i}"
            require((want is None) == (got is None),
                    f"hostile {what}: the host Decoder "
                    f"{'raised' if want is None else 'decoded'}, TorchDecoder "
                    f"{'raised' if got is None else 'decoded'}")
            if want is None:
                raised += 1
                continue
            require(all(np.array_equal(w, g) for w, g in zip(want, got)),
                    f"hostile {what}: TorchDecoder's samples differ from "
                    "the host Decoder's")
            samples += 1
    finally:
        torch_decoder.synthesize_rows = real
    launches = S.KERNEL_LAUNCHES
    require(launches == len(calls) > 0,
            f"hostile streams: {launches} launches, {len(calls)} recorded")
    require(flagged > 0, "hostile streams: no row past the download width")
    require(samples > 0, "hostile streams: no input decoded to samples")

    # each launch against the plain version, pooled by shape: the plain
    # version's Python loop over time costs the same for one row or many
    by_shape = {}
    for x, c, rs, y in calls:
        by_shape.setdefault((x.shape[1], c.shape[1]), []).append((x, c, rs, y))
    max_err = 0
    for (ns, npu), group in by_shape.items():
        x, c, rs, y = (torch.cat(parts) for parts in zip(*group))
        want = S.synthesize_rows_ref(x, c, rs)
        max_err = max(max_err, int((y.long() - want.long()).abs().max()))
        require(torch.equal(y, want),
                f"hostile streams: a launch at (ns {ns}, npu {npu}) differs "
                "from synthesize_rows_ref")
    rs_all = torch.cat([rs for _x, _c, rs, _y in calls])
    rows = int(rs_all.numel())

    # the context survived: phase 4's streams decode to phase 4's samples
    decoded = TorchDecoder(device="cuda").decode_many(datas)
    torch.cuda.synchronize()
    for sig, out in zip(tracks, decoded):
        require(lossless(sig, out), "phase 4's streams no longer decode "
                                    "losslessly after the hostile sweep")
    print(f"hostile streams: {len(inputs)} inputs from 4 streams (stereo "
          f"16-bit presets 0, 2, 7; mono 24-bit preset 7; block "
          f"{HOSTILE_SPB}), CRC off: {samples} decoded to the host "
          f"Decoder's samples, {raised} raised FormatError on both, "
          f"synthesize_rows launches {launches} ({rows} rows, "
          f"{int((rs_all == 0).sum())} at rshift 0, {len(by_shape)} "
          f"(ns, npu) shapes) bit-equal to synthesize_rows_ref, rows "
          f"flagged past the download width {flagged}; phase 4's streams "
          f"lossless after the sweep; {time.perf_counter() - t0:.1f} s on "
          f"{card}")
    return max_err


# -- the batched encode's stages as CUDA graphs ------------------------------


GRAPH_PAIRS = 10  # alternating pairs of the graph and eager encodes
GRAPH_REFINE_PAIRS = 3  # the same for -a 2 and -l, warm
# cold encodes of n batches of one shape, graphs against eager
CROSSOVER_BATCHES = (2, 3, 4, 6, 8, 12)
CROSSOVER_PAIRS = 5


class EagerStages:
    """Within its `with`, TorchEncoder runs its stage chain eagerly on the
    card too (its lookup of a device's graphs is swapped for one that
    gives none), so that a run can be compared with the graphs'. There is
    no switch in the package."""

    def __init__(self, on: bool = True):
        self.on = on
        self._real = TorchEncoder._stage_graphs

    def __enter__(self):
        if self.on:
            TorchEncoder._stage_graphs = lambda enc, device: None
        return self

    def __exit__(self, *exc):
        TorchEncoder._stage_graphs = self._real


def graph_report(enc) -> str:
    """Each device's graphs of an encoder: the keys, eager runs, captures,
    capture seconds, replays and the pool's bytes."""
    out = []
    for d, g in enc._graphs.items():
        pool = g.pool_bytes()
        keys = ", ".join("G1 " + "x".join(map(str, k[2:4])) if k[0] == "g1"
                         else "G2 " + "x".join(map(str, k[2:4]))
                         + f" W{k[5]}" for k in g.keys())
        out.append(f"{d}: {g.graphs} graphs ({keys}), {g.eager_runs} eager "
                   f"runs, {g.captures} "
                   f"captures in {g.capture_seconds:.3f} s, {g.replays} "
                   f"replays, pool "
                   + ("not measured" if pool is None
                      else f"{pool / 2**20:.1f} MiB"))
    return "; ".join(out)


def encoder_for(batch_blocks=64, devices=None, **kw) -> TorchEncoder:
    enc = (TorchEncoder(batch_blocks=batch_blocks, devices=devices)
           if devices else TorchEncoder(batch_blocks=batch_blocks,
                                        device="cuda"))
    enc.set_encode_parameter(param(**kw))
    return enc


def graphs_against_eager(what, tracks, want=None, batch_blocks=64,
                         devices=None, runs=1, **kw):
    """The corpus through a fresh graph encoder (`runs` times, so that a
    corpus of fewer than G.CAPTURE_AT batches a shape replays graphs too)
    and a fresh eager one on the card: byte-identical (and equal to `want`
    when given), lossless under the host Decoder, with graphs replayed.
    Returns (the graph encoder, its streams)."""
    chans = [[t[0], t[1]] for t in tracks]
    lengths = [t.shape[1] for t in tracks]
    with EagerStages():
        eager_enc = encoder_for(batch_blocks, devices, **kw)
        eager, eager_s = timed(lambda: eager_enc.encode_many(chans, lengths))
    enc = encoder_for(batch_blocks, devices, **kw)
    got, secs = timed(lambda: enc.encode_many(chans, lengths))
    for _ in range(runs - 1):
        require(enc.encode_many(chans, lengths) == got,
                f"graphs, {what}: a later run's streams differ")
    require(all(g.replays > 0 for g in enc._graphs.values()),
            f"graphs, {what}: no graph was replayed")
    require(got == eager, f"graphs, {what}: the streams differ from the "
                          "eager card encode's")
    if want is not None:
        require(got == want, f"graphs, {what}: the streams differ from "
                             "phase 4's")
    for sig, data in zip(tracks, got):
        require(lossless(sig, Decoder().decode_whole(data)),
                f"graphs, {what}: a stream is not lossless")
    print(f"graphs, {what}: streams byte-identical to the eager card "
          f"encode's, lossless; cold encode (a fresh encoder, as a CLI call "
          f"makes) {secs:.3f} s with graphs, {eager_s:.3f} s eager; overflow "
          f"rows "
          f"{enc.overflow_rows} and {eager_enc.overflow_rows}; "
          + graph_report(enc))
    return enc, got


def graph_batch_phase(tracks) -> None:
    """One 64-block batch on a warm encoder, with graphs and eagerly: the
    torch ops Python dispatches for it (counted as stage_ops counts), and
    its stages' profiled wall against device time."""
    blocks = np.stack([tracks[0][:, b * SPB:(b + 1) * SPB]
                       for b in range(64)])
    dev = torch.device("cuda", 0)
    rows = torch.from_numpy(blocks.astype(np.int16)).pin_memory()
    for eager in (False, True):
        with EagerStages(eager):
            enc = encoder_for()
            # a W from the seen residual, then the graphs' captures
            for _ in range(G.CAPTURE_AT + 2):
                enc._drain_batch(*enc._dispatch_batch(blocks, SPB))
            W = enc._pick_width(SPB)
            g = enc._graphs.get(dev)
            replays = g.replays if g else 0
            ops = count_ops(enc._dispatch_batch, blocks, SPB)[0]
            require(eager or g.replays == replays + 2,
                    "graphs: the warm batch did not replay G1 and G2")
            torch.cuda.synchronize()
            top = []
            wall_ms, dev_ms, launches = device_time(
                enc._run_stages, rows, SPB, dev, W, top=top)
            span_ms = cuda_ms(lambda: enc._run_stages(rows, SPB, dev, W),
                              reps=5)
        label = "eager" if eager else "graphs"
        busy = (f"{100 * dev_ms / wall_ms:.1f} % busy" if dev_ms
                else "no device time in the trace (not measured)")
        print(f"graphs, one 64-block batch, {label}: {ops} torch ops "
              f"dispatched by _dispatch_batch (views and allocations "
              f"excluded); stages profiled wall {wall_ms:.2f} ms, device "
              f"{dev_ms:.2f} ms in {launches} launches ({busy}); CUDA-event "
              f"span {span_ms:.2f} ms a batch (mean of 5 back to back)"
              + ("" if eager else "; " + graph_report(enc)))


def graph_pairs_phase(tracks, want) -> None:
    """The plain -e corpus encode on a warm graph encoder against a warm
    eager one, 10 alternating pairs in one process."""
    chans = [[t[0], t[1]] for t in tracks]
    lengths = [t.shape[1] for t in tracks]
    seconds = sum(lengths) / RATE
    encs = {}
    for eager in (False, True):
        with EagerStages(eager):
            encs[eager] = encoder_for()
            for _ in range(2):  # every shape and W class the corpus takes
                encs[eager].encode_many(chans, lengths)
    g = encs[False]._graphs[torch.device("cuda", 0)]
    captures = g.captures
    multiples = {False: [], True: []}
    won = 0
    for turn in range(GRAPH_PAIRS):
        secs = {}
        for eager in ((False, True) if turn % 2 == 0 else (True, False)):
            with EagerStages(eager):
                got, secs[eager] = timed(
                    lambda: encs[eager].encode_many(chans, lengths))
            require(got == want, "graphs pairs: a stream differs from "
                                 "phase 4's")
            multiples[eager].append(seconds / secs[eager])
        won += secs[False] < secs[True]
    for eager in (False, True):
        v = np.asarray(multiples[eager])
        q1, med, q3 = np.percentile(v, [25, 50, 75])
        print(f"graphs pairs, plain -e corpus encode "
              f"{'eager' if eager else 'with graphs'}: multiples "
              f"{[round(float(m), 2) for m in v]}, median {med:.2f}x "
              f"realtime, IQR {q1:.2f}-{q3:.2f}")
    ratio = [a / b for a, b in zip(multiples[False], multiples[True])]
    print(f"graphs pairs: graphs / eager median ratio "
          f"{float(np.median(ratio)):.3f} (IQR "
          f"{float(np.percentile(ratio, 25)):.3f}-"
          f"{float(np.percentile(ratio, 75)):.3f}), graphs faster in {won} "
          f"of {GRAPH_PAIRS} pairs; captures during the pairs "
          f"{g.captures - captures}; every stream equal to phase 4's")
    for eager in (False, True):
        with EagerStages(eager):
            wall_ms, dev_ms, launches = device_time(
                encs[eager].encode_many, chans, lengths)
        busy = (f"{100 * dev_ms / wall_ms:.1f} % busy" if dev_ms
                else "no device time in the trace (not measured)")
        print(f"graphs, plain -e corpus encode "
              f"{'eager' if eager else 'with graphs'} under the profiler: "
              f"wall {wall_ms:.1f} ms, device {dev_ms:.2f} ms in {launches} "
              f"launches ({busy})")


def graph_refine_pairs_phase(tracks) -> None:
    """-a 2 on the corpus and -l on its first track, on warm graph and
    eager encoders, GRAPH_REFINE_PAIRS alternating pairs each: the eager
    middle is the same code either way, so only G1 and G2 differ."""
    for flags, kw, subset in (("-a 2", {"af": 2}, tracks),
                              ("-l", {"learn": True}, tracks[:1])):
        chans = [[t[0], t[1]] for t in subset]
        lengths = [t.shape[1] for t in subset]
        seconds = sum(lengths) / RATE
        encs, want = {}, None
        for eager in (False, True):
            with EagerStages(eager):
                encs[eager] = encoder_for(**kw)
                got = encs[eager].encode_many(chans, lengths)
            require(want is None or got == want,
                    f"graphs {flags}: warm streams differ from eager's")
            want = got
        multiples = {False: [], True: []}
        won = 0
        for turn in range(GRAPH_REFINE_PAIRS):
            secs = {}
            for eager in ((False, True) if turn % 2 == 0
                          else (True, False)):
                with EagerStages(eager):
                    got, secs[eager] = timed(
                        lambda: encs[eager].encode_many(chans, lengths))
                require(got == want, f"graphs {flags}: a stream differs")
                multiples[eager].append(seconds / secs[eager])
            won += secs[False] < secs[True]
        med = {k: float(np.median(v)) for k, v in multiples.items()}
        print(f"graphs pairs, {flags} on {len(subset)} track(s), warm: "
              f"with graphs {[round(m, 2) for m in multiples[False]]} "
              f"(median {med[False]:.2f}x), eager "
              f"{[round(m, 2) for m in multiples[True]]} (median "
              f"{med[True]:.2f}x); graphs faster in {won} of "
              f"{GRAPH_REFINE_PAIRS} pairs; streams equal")


def graph_crossover_phase(tracks) -> None:
    """Cold encodes (a fresh encoder each, as every CLI call and every
    group of the corpus tool builds) of n batches of one shape at 64 and
    128 rows, with graphs captured at a shape's second run against eager,
    CROSSOVER_PAIRS alternating pairs for each n. The median difference
    at n = 2 is what a capture costs beyond an eager run (it replays only
    itself); its fall per added batch is what a replay saves. A key that
    captures at run K loses at most (K - 1) savings when it stops right
    after, and at most a capture's cost when it runs on: K = 1 + cost /
    saving makes the two equal, which is what G.CAPTURE_AT is set from."""
    sig = np.concatenate(tracks, axis=1)
    for rows in (64, 128):
        diffs = {}
        for n in CROSSOVER_BATCHES:
            need = n * rows * SPB
            reps = -(-need // sig.shape[1])
            track = np.concatenate([sig] * reps, axis=1)[:, :need]
            secs = {False: [], True: []}
            for turn in range(CROSSOVER_PAIRS):
                for eager in ((False, True) if turn % 2 == 0
                              else (True, False)):
                    with EagerStages(eager):
                        enc = encoder_for(batch_blocks=rows)
                        gc.collect()
                        captured = G.CAPTURE_AT
                        G.CAPTURE_AT = 2
                        try:
                            _got, s = timed(lambda: enc.encode_many(
                                [[track[0], track[1]]], [need]))
                        finally:
                            G.CAPTURE_AT = captured
                        secs[eager].append(s)
                        del enc
            diffs[n] = float(np.median(np.subtract(secs[False],
                                                   secs[True])))
            print(f"graphs crossover, {rows} rows, {n} batches cold: "
                  f"graphs (capture at run 2) "
                  f"{[round(v, 4) for v in secs[False]]} s, eager "
                  f"{[round(v, 4) for v in secs[True]]} s, median "
                  f"difference {1e3 * diffs[n]:+.1f} ms")
        ns = np.asarray(CROSSOVER_BATCHES, dtype=np.float64)
        slope = float(np.polyfit(ns, [diffs[n] for n in CROSSOVER_BATCHES],
                                 1)[0])
        cost = diffs[CROSSOVER_BATCHES[0]]
        saving = -slope
        k = (1 + cost / saving) if saving > 0 else float("inf")
        print(f"graphs crossover, {rows} rows: a capture costs "
              f"{1e3 * cost:+.1f} ms beyond an eager run, a replay saves "
              f"{1e3 * saving:.1f} ms (least squares over n), so K = 1 + "
              f"cost / saving = {k:.2f} (G.CAPTURE_AT is {G.CAPTURE_AT})")


def graph_phase(tracks, datas) -> None:
    """17. The batched encode's stages as CUDA graphs against the eager card
    encode (see the module docstring)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    enc, _ = graphs_against_eager("phase 4's corpus", tracks, datas)
    torch.cuda.synchronize()
    print(f"graphs, memory reserved before the corpus's captures "
          f"{reserved / 2**20:.1f} MiB, after "
          f"{torch.cuda.memory_reserved() / 2**20:.1f} MiB (the eager "
          "encode's cache included)")
    del enc
    # four 128-row batches a run: the second run captures and replays
    graphs_against_eager("batch_blocks=128", tracks, datas, batch_blocks=128,
                         runs=2)
    classes = E._res_width_classes
    E._res_width_classes = lambda bps: (6,)
    try:
        enc, _ = graphs_against_eager("forced 6-bit residual class", tracks,
                                      datas)
    finally:
        E._res_width_classes = classes
    require(enc.overflow_rows > 0, "graphs: no overflow row at W=6")
    graphs_against_eager("-a 2", tracks, af=2)
    graphs_against_eager("-l", tracks, learn=True)
    graphs_against_eager('devices ["cuda:0", "cuda:0"]', tracks, datas,
                         devices=["cuda:0", "cuda:0"])
    graph_batch_phase(tracks)
    graph_pairs_phase(tracks, datas)
    graph_refine_pairs_phase(tracks)
    graph_crossover_phase(tracks)


def ptxas_report(name: str) -> str:
    """nvcc -Xptxas -v's registers, shared memory and spills for each
    kernel of csrc/<name>.cu (a throwaway build beside the real one)."""
    src = ROOT / "linne_tpu_torch" / "csrc" / f"{name}.cu"
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_kernels.find_nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v",
             "-o", str(pathlib.Path(tmp) / "lib.so"), str(src)],
            capture_output=True, text=True)
    require(proc.returncode == 0, f"nvcc -Xptxas -v failed on {src}")
    lines, kernel = [], None
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            # _ZN..._<len>autocorr_kernelILi4EEEv... -> autocorr_kernel<4>
            m = re.search(r"\d+([a-z_]+_kernel)(?:IL[ib](\d+)E)?",
                          line.split("'")[1])
            kernel = (m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
                      if m else line.split("'")[1])
        elif kernel and ("spill" in line or "Used" in line):
            text = line.split(":", 1)[1] if "Used" in line else line
            lines.append(f"  {kernel}: {text.strip()}")
    return f"ptxas -v, {name}.cu:\n" + "\n".join(lines)


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
    sources = ["synthesis", "exact_serial", "analysis_scans"]
    with ThreadPoolExecutor(5) as pool:  # one nvcc per source, together
        reports = [pool.submit(ptxas_report, name)
                   for name in ("exact_serial", "analysis_scans")]
        list(pool.map(_kernels.build, sources))
        for report in reports:
            print(report.result())
    S._kernel_fn()
    for k in ES.KERNELS:
        ES._fn(k)
    for entry in AS._SIGNATURES:  # the C entry of every kernel
        AS._fn(entry)
    print(f"built {', '.join(sources)} in "
          f"{time.perf_counter() - t0:.2f} s")
    dadd = ES.dadd_cycles()
    print(f"DADD latency: {dadd:.3f} cycles a dependent __dadd_rn "
          f"(clock64 probe in exact_serial.cu; {DADD_CYCLES} reckoned)")
    ddiv = AS.ddiv_cycles()
    print(f"DDIV latency: {ddiv:.3f} cycles a dependent __ddiv_rn "
          "(clock64 probe in analysis_scans.cu)")

    kernel = kernel_phase()
    scan_err = scans_edge_phase()
    tracks = corpus()
    launches, scan_launches, datas, plain_multiple = main_path_phase(tracks)
    scans = scan_calls_phase(tracks, clock_hz, dadd, ddiv)
    unit_residual_phase(tracks, clock_hz, dadd)
    lpc_autocorr_phase(tracks, clock_hz, dadd)
    rice_search_phase(tracks, clock_hz, dadd)
    scan_pairs_phase(tracks)
    group_err = decode_groups_phase(datas)
    decode_profile_phase(datas)
    with tempfile.TemporaryDirectory() as tmp:
        cli_phase(pathlib.Path(tmp))
    cross_device_phase()

    edge_err = exact_kernel_phase()
    exact_launches, exact_refs = exact_encode_phase(tracks)
    exact = exact_calls_phase(tracks, clock_hz, dadd)
    exact_flags_phase()
    learn_af_phase(tracks, plain_multiple)
    learn_af_dispatch_phase()
    device_list_phase(tracks, datas, exact_refs)
    packing_phase()
    copy_phase(tracks)
    forced_overflow_phase(tracks, datas)
    routes_phase(tracks)
    with tempfile.TemporaryDirectory() as tmp:
        corpus_tool_phase(tracks, pathlib.Path(tmp))
    bench_phase()
    guard_phase()
    hostile_err = hostile_phase(tracks, datas, smi.stdout.strip())
    graph_phase(tracks, datas)

    replaces = {"autocorr_serial": 148, "levinson_serial": 203,
                "serial_abs_mean": 378, "chain_predict": 349}
    report = [{
        "name": "synthesize_rows",
        "route": "cuda",
        "source": "linne_tpu_torch/csrc/synthesis.cu",
        "replaces": "linne_tpu/ops/synthesis.py:46",
        "launches": launches,
        "max_abs_err": max(kernel["max_abs_err"], group_err, hostile_err),
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
    for k in AS.KERNELS:
        # the byte-exact quantizer: its launches in the exact-device
        # encode, its time over one 128-row preset-7 fit chunk
        timed_k = exact[k] if k == "quantize_layer" else scans[k]
        report.append({
            "name": k,
            "route": "cuda",
            "source": "linne_tpu_torch/csrc/analysis_scans.cu",
            # an XLA scan of the JAX graph, not a Pallas kernel
            "replaces": _SCAN_REPLACES[k],
            "launches": (exact_launches[k] if k == "quantize_layer"
                         else scan_launches[k]),
            "max_abs_err": max(scan_err[k], timed_k["max_abs_err"]),
            # summed over every call of one 64-block preset-7 batch
            "ms": timed_k["ms"],
            "plain_ms": timed_k["plain_ms"],
            "bound_ms": timed_k["bound_ms"],
            "bound_by": timed_k["bound_by"],
            # no PyTorch call runs these recursions, or an int32 FIR that
            # wraps, on CUDA
            "library_ms": None,
        })
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
