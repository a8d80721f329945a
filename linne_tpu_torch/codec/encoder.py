"""Batched block encoder on torch tensors — the main encode path.
Counterpart of linne_tpu/codec/encoder.py:TpuEncoder.

Whole tracks are split into [blocks, channels, block_len] tensors. One
batch runs a chain of stages on the device (pre-processing: estimator, MS
transform, pre-emphasis; one unit x ridge sweep per layer; ridge selection;
with `-a N` an IRLS refit of each layer under the winning ridge
(ops/afmethod.py), with `-l` momentum training of the whole cascade
(ops/training.py); quantization, integer predict cascade and Rice parameter
search); the host then only packs bits with the native host library
(native.py), which the encoder requires: it is built with g++ at first
use, and a missing one raises at construction. On a CUDA device the chain
runs as two CUDA graphs a shape (codec/graphs.py, the counterpart of the
reference's jitted stages), eager at a shape's first batches, then
captured and replayed: G1 (pre-processing, the layer sweeps, ridge
selection) and G2 (quantization to the packed result), with `-a N` and
`-l` run eagerly between them. The CPU runs the chain eagerly.

Emitted streams are always losslessly decodable by the reference decoder
(integer predict/Rice semantics are wire-exact, and the residual is
recomputed from the quantized integers, mirroring linne_encoder.c:686-696).
The float analysis runs in float64 on every device (see ops/__init__.py),
so on the CPU the bytes equal TpuEncoder's float64 CPU bytes.

Each batch leaves the device as one int32 tensor: the side columns (flags,
the block's residual width, pre-emphasis state, per-layer unit counts and
shifts, Rice order, then the coefficient and k2 planes byte-packed four to
a word) followed by the residual plane at W bits per sample
(ops/bitpack.py), in the reference's layout. It goes in one non-blocking
copy into pinned host memory; a CUDA event per batch tells the drain when
it has landed, and PIPELINE_DEPTH batches stay in flight. W adapts per
block length: each batch is dispatched at the narrowest class of
_res_width_classes that covers the widest residual of the last drained
batch of that length. The int32 residual tensor stays on the device until
its batch is drained; the rare blocks whose residual is wider than W are
fetched from it at full width. The host's phases open spans
(utils/profiling.py: "encode", "encode.split", "encode.dispatch" with
".stage", ".launch" and ".fetch", "encode.drain" with ".wait",
".overflow" and ".pack", "encode.tails", "encode.frame", and with `-l`
"encode.train" around the trainer, with its counters `train_*`), and
`queue_waits` counts the copies that wait for all the work queued on the
device (the overflow fetch's pageable upload and blocking read, the ridge
terms' upload when a chain is built). With a device list (`devices=`,
parallel/mesh.py) each batch's rows split into one shard per entry, each
with its own copy, event and residual tensor.
"""

from __future__ import annotations

import functools
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import native
from .params import EncodeParameter, EncoderConfig, compress_viable
from ..constants import (
    BLOCK_TYPE_COMPRESS,
    BLOCK_TYPE_RAW,
    BLOCK_TYPE_SILENT,
    CH_PROCESS_MS,
    LOG2_NUM_UNITS_BITWIDTH,
    LPC_COEF_BITWIDTH,
    NUM_PREEMPH_FILTERS,
    TRAINING_LEARNING_RATE,
    TRAINING_LOSS_EPSILON,
    TRAINING_MAX_NUM_ITERATIONS,
)
from ..format.block import frame_block, write_raw_payload
from ..format.header import LinneHeader
from ..format.huffman import get_codebook
from ..presets import PRESETS

from ..ops import ANALYSIS_DTYPE
from ..ops import afmethod
from ..ops import analysis as A
from ..ops import intops as I
from ..ops import rice_search as R
from ..ops import training
from ..ops.bitpack import pack_geometry, pack_plane_words
from ..parallel.mesh import on_device, pad_rows, resolve_devices, shards
from ..utils.profiling import span
from .graphs import StageGraphs

_RAW_THRESHOLD = float(np.float32(0.95))


def _roundup(val: int, n: int) -> int:
    return ((val + n - 1) // n) * n


def _res_width_classes(bps: int) -> tuple:
    """Allowed bit widths of the residual plane's copy to the host, widest
    first. Residuals of compressible material fit well under the sample
    width, so the plane carries W bits per sample (two's complement); W is
    picked per batch from these classes (_pick_width), and blocks wider
    than the dispatched W come as full int32 rows (_drain_batch)."""
    return (14, 12, 10) if bps <= 16 else (24, 20)


def _res_pack_width(bps: int) -> int:
    """Widest (startup/default) residual-plane class."""
    return _res_width_classes(bps)[0]


class _G1Out(NamedTuple):
    """G1's outputs for a [B, C] batch (pre_stage, the layer fits, ridge
    selection): what G2 and the `-a`/`-l` stages read."""
    raw_flag: torch.Tensor     # [B]
    silent_flag: torch.Tensor  # [B]
    pprev: torch.Tensor        # [B, C, pre-emphasis filters]
    pcoef: torch.Tensor        # [B, C, pre-emphasis filters]
    buf: torch.Tensor          # [B, C, width] int32, pre-emphasised
    sig: torch.Tensor          # [B, C, num_analyze] float analysis input
    log2u: tuple               # a layer's [B, C] int32 log2 unit counts
    params: tuple              # a layer's [B, C, order] float coefficients
    ridge_val: torch.Tensor    # [B, C] the winning ridge term


class _StageChain(NamedTuple):
    """The stage chain of one block length (TorchEncoder._stage_chain)."""
    num_analyze: int
    g1: Callable                # blocks -> _G1Out
    middle: Optional[Callable]  # _G1Out -> refined params (-a, -l)
    g2: Callable                # (_G1Out, params, W) -> (packed, residual)
    analyze: Callable           # the eager chain: (blocks, W=None) -> dict


class TorchEncoder:
    """Batched block encoder. API mirrors the reference encoder handle
    (reference: include/linne_encoder.h:35-61) with a batched core."""

    PIPELINE_DEPTH = 3

    def __init__(self, config: Optional[EncoderConfig] = None,
                 batch_blocks: int = 64, tail_mode: str = "auto",
                 device=None, devices=None):
        """`tail_mode`: how partial trailing blocks (length <
        num_samples_per_block) are encoded. "host" always uses the
        byte-exact host encoder, "device" always runs the batched stages,
        "auto" (default) uses the host unless this encoder has already
        built the stages for that length. The rule depends only on the tail
        length and on which lengths were built, so encode_whole and
        encode_many emit the same bytes for the same input, and so do
        default-constructed TorchEncoder and TpuEncoder.

        `device`: where the stages run (default "cuda"; "cpu" only when
        asked for). `devices`: a device list instead (parallel/mesh.py):
        every dispatched batch's rows split over it, one contiguous shard
        per entry; blocks are independent, so the bytes equal the
        one-device encode's. batch_blocks is rounded up to a multiple of
        its length.

        Raises RuntimeError when the native host library cannot be built
        or loaded: the drain unpacks and packs every block with it."""
        native.lib()
        self.devices = resolve_devices(device, devices)
        self.config = config or EncoderConfig()
        self.config.validate()
        self.dtype = ANALYSIS_DTYPE
        self.batch_blocks = _roundup(batch_blocks, len(self.devices))
        if tail_mode not in ("auto", "device", "host"):
            raise ValueError(f"tail_mode {tail_mode!r}")
        self.tail_mode = tail_mode
        self.parameter: Optional[EncodeParameter] = None
        self.preset = None
        self.codebook = None
        self._analyze_cache = {}
        self._graphs = {}  # CUDA device -> its StageGraphs
        self._maxw_seen = {}  # block length -> widest residual seen
        # transfer counters over the encoder's life: the W of every
        # dispatched batch, the int32 rows fetched past W, the bytes
        # copied to the host (packed tensors and fetched rows), and the
        # copies that wait for all the work queued on the device (uploads
        # from pageable memory, blocking reads)
        self.batch_widths: List[int] = []
        self.overflow_rows = 0
        self.bytes_to_host = 0
        self.queue_waits = 0
        # `-l` counters over the encoder's life: the trainer's calls (one a
        # batch shard), its iterations, rows x iterations, the iterations
        # of rows still active (the rest update nothing), and host seconds
        # in the trainer (span "encode.train"; it syncs every iteration)
        self.train_batches = 0
        self.train_iterations = 0
        self.train_row_iterations = 0
        self.train_active_row_iterations = 0
        self.train_s = 0.0

    def set_encode_parameter(self, parameter: EncodeParameter) -> None:
        parameter.validate_against(self.config)
        self.parameter = parameter
        self.preset = PRESETS[parameter.preset]
        self.codebook = get_codebook(self.preset.coef_freq_table)
        self._analyze_cache = {}
        self._graphs = {}
        self._maxw_seen = {}

    # -- the per-batch stage chain -----------------------------------------

    def _analyze_fn(self, n: int):
        """The stage chain for block length n, eagerly: (analyze,
        num_analyze); analyze(blocks, W=None) maps a [B, C, >=n]
        int16/int32 device tensor to {"packed": [B, C, side_k + words]
        int32 (the side columns, then the residual plane at W bits),
        "residual": [B, C, n] int32}, W defaulting to the widest class."""
        chain = self._stage_chain(n)
        return chain.analyze, chain.num_analyze

    def _stage_chain(self, n: int) -> "_StageChain":
        """Build (and cache) the stage chain for block length n, split at
        the reference's stage boundaries into the two parts a CUDA device
        replays as graphs (codec/graphs.py): G1 (pre_stage, every
        fit_stage, select_stage) and G2 (finish_stage at a given W), with
        the eager `-a`/`-l` stages between them. Every constant tensor a
        stage reads is made once per device and kept by the chain, as long
        as the chain and the graphs captured from it live: a capture
        cannot copy host data to the device, and a graph reads the same
        memory at every replay. The ridge tensors are made here, the
        windows at the chain's first run (`windows`, ops/analysis.py)."""
        chain = self._analyze_cache.get(n)
        if chain is not None:
            return chain

        p = self.parameter
        dtype = self.dtype
        num_analyze = _roundup(n, 1 << LOG2_NUM_UNITS_BITWIDTH)
        num_analyze = min(p.num_samples_per_block,
                          max(self.preset.max_num_params, num_analyze))
        orders = self.preset.layer_num_params
        L = len(orders)
        ridges = self.preset.ridge_terms
        nridge = len(ridges)
        unit_choices = [A.candidate_units(o, num_analyze) for o in orders]
        ms = p.ch_process_method == CH_PROCESS_MS
        bps = p.bits_per_sample
        ridge_tensors = {}
        windows = {}  # (type, taps, dtype, device) -> window

        def ridge_vec(device):  # [nridge] on device, made once
            rv = ridge_tensors.get(device)
            if rv is None:
                rv = torch.tensor(ridges, dtype=dtype, device=device)
                self.queue_waits += 1
                ridge_tensors[device] = rv
            return rv

        for d in self.devices:
            ridge_vec(d)

        def pre_stage(blocks):  # [B, C, max(n, num_analyze)]
            blocks = blocks.to(torch.int32)
            raw_sig = I.normalize_to_float(blocks[..., :n], bps, dtype)
            est = A.estimate_code_length(raw_sig, orders[0], bps, windows)
            mean_est = torch.sum(est, dim=-1) / est.shape[-1] / bps
            raw_flag = mean_est >= _RAW_THRESHOLD
            silent_flag = ~torch.any(
                (blocks[..., :n] != 0).flatten(-2), dim=-1)

            buf = I.ms_transform(blocks) if ms else blocks
            prevs = []
            coefs = []
            for _stage in range(NUM_PREEMPH_FILTERS):
                prev = buf[..., 0]
                body = buf[..., :n]
                coef = I.preemphasis_coefficient(body, dtype)
                body = I.preemphasis_apply(body, coef)
                buf = torch.cat([body, buf[..., n:]], dim=-1)
                prevs.append(prev)
                coefs.append(coef)
            sig = I.normalize_to_float(buf[..., :num_analyze], bps, dtype)
            # ridge axis rides through the layer fits as a batch dimension
            sig_r = sig.unsqueeze(0).expand((nridge,) + tuple(sig.shape))
            return (raw_flag, silent_flag, torch.stack(prevs, dim=-1),
                    torch.stack(coefs, dim=-1), buf, sig_r)

        def fit_stage(sig_r, order):
            rv = ridge_vec(sig_r.device).reshape(
                (nridge,) + (1,) * (sig_r.dim() - 1))
            return A.fit_layer(sig_r, order, rv, windows)

        def select_stage(final_res, log2u_r, params_r):
            # winning ridge: first minimum, as the reference's strict-<
            # sweep; returns its per-layer selections and its ridge term
            final_loss = (torch.sum(torch.abs(final_res), dim=-1)
                          / final_res.shape[-1])
            best = torch.argmin(final_loss, dim=0)
            return ([A.take_ridge(l, best) for l in log2u_r],
                    [A.take_ridge(f, best) for f in params_r],
                    ridge_vec(best.device)[best])

        if p.num_afmethod_iterations > 0:
            af_stages = [
                afmethod.make_af_layer_stage(o, unit_choices[li],
                                             p.num_afmethod_iterations)
                for li, o in enumerate(orders)]
        else:
            af_stages = None
        if p.enable_learning:
            train = training.make_train_fn(
                orders, unit_choices, TRAINING_MAX_NUM_ITERATIONS,
                TRAINING_LEARNING_RATE, TRAINING_LOSS_EPSILON)
        else:
            train = None
        refine = af_stages is not None or train is not None

        def finish_stage(raw_flag, silent_flag, pprev, pcoef, buf, log2u,
                         params, W):
            # every layer in one launch: int_coef [B, C, sum of orders],
            # the layers side by side; rshifts [L, B, C]
            int_coef, rshifts = A.quantize_layers(params, LPC_COEF_BITWIDTH)
            x = buf[..., :n]
            col = 0
            for li, order in enumerate(orders):
                x = I.predict_cascade_layer(
                    x, int_coef[..., col:col + order], log2u[li],
                    rshifts[li], unit_choices[li])
                col += order
            porder, k2s = R.rice_search(x, dtype)
            # minimal two's-complement width of the block's residuals: x
            # fits w iff -2^(w-1) <= x < 2^(w-1); the exponent of frexp is
            # the bit length of m (exact: m < 2^31 is a float64 integer)
            flat = x.flatten(1)
            m = torch.maximum(flat.amax(dim=-1).long(),
                              -flat.amin(dim=-1).long() - 1)
            res_maxw = torch.frexp(m.to(torch.float64))[1] + 1
            B, C = x.shape[0], x.shape[1]

            def bc1(v):  # [B] -> [B, C, 1]
                return v.to(torch.int32)[:, None, None].expand(B, C, 1)

            parts = [bc1(raw_flag), bc1(silent_flag), bc1(res_maxw),
                     pprev, pcoef]
            for li in range(len(orders)):
                parts.append(log2u[li].unsqueeze(-1))
                parts.append(rshifts[li].unsqueeze(-1))
            parts.append(porder.unsqueeze(-1))
            # the coefficient and k2 planes hold bytes: the 8-bit plane
            # packing puts four to a word, little-endian
            parts.append(pack_plane_words(int_coef, 8))
            parts.append(pack_plane_words(k2s.to(torch.int32), 8))
            parts.append(pack_plane_words(x, W))
            packed = torch.cat([t.to(torch.int32) for t in parts], dim=-1)
            return packed, x

        def g1(blocks):
            raw_flag, silent_flag, pprev, pcoef, buf, sig_r = pre_stage(blocks)
            log2u_r = []
            params_r = []
            x = sig_r
            for order in orders:
                log2u, flat, x, _loss = fit_stage(x, order)
                log2u_r.append(log2u)
                params_r.append(flat)
            log2u, params, ridge_val = select_stage(x, log2u_r, params_r)
            return _G1Out(raw_flag, silent_flag, pprev, pcoef, buf, sig_r[0],
                          tuple(log2u), tuple(params), ridge_val)

        def middle(out):
            """The params that `-a` and `-l` refine from G1's."""
            params = list(out.params)
            if af_stages is not None:
                # AF-refined final pass: refit layer by layer with IRLS
                # under the winning ridge, cascading residuals
                xa = out.sig
                params = []
                for stage, layer_log2u in zip(af_stages, out.log2u):
                    flat, xa = stage(xa, layer_log2u, out.ridge_val)
                    params.append(flat)
            if train is not None:
                # rows train independently, so padding rows (all zero:
                # they stop after two iterations) change no real row
                with span("encode.train"):
                    t0 = time.perf_counter()
                    stops = torch.zeros(out.sig.shape[:-1],
                                        dtype=torch.int64,
                                        device=out.sig.device)
                    params, iterations = train(out.sig, params,
                                               list(out.log2u), stops)
                    self.train_batches += 1
                    self.train_iterations += iterations
                    self.train_row_iterations += stops.numel() * iterations
                    # the batch's one read of the count
                    self.train_active_row_iterations += int(stops.sum())
                    self.train_s += time.perf_counter() - t0
            return params

        def g2(out, params, W):
            return finish_stage(out.raw_flag, out.silent_flag, out.pprev,
                                out.pcoef, out.buf, list(out.log2u),
                                list(params), W)

        def analyze(blocks, W=None):
            if W is None:
                W = _res_pack_width(bps)
            out = g1(blocks)
            params = middle(out) if refine else out.params
            packed, residual = g2(out, params, W)
            return {"packed": packed, "residual": residual}

        chain = _StageChain(num_analyze, g1, middle if refine else None, g2,
                            analyze)
        self._analyze_cache[n] = chain
        return chain

    def _side_layout(self, n: int):
        """Offsets into the packed result (see finish_stage): [raw, silent,
        residual width] flags, pre-emphasis state, per-layer (log2u,
        rshift), porder, the byte-packed coefficient and k2 planes; the
        residual plane follows at side_k."""
        L = self.preset.num_layers
        total_order = sum(self.preset.layer_num_params)
        max_parts = 1 << R.max_porder_for(n)
        off_layers = 3 + 2 * NUM_PREEMPH_FILTERS
        off_porder = off_layers + 2 * L
        off_coefw = off_porder + 1
        off_k2w = off_coefw + (total_order + 3) // 4
        side_k = off_k2w + (max_parts + 3) // 4
        return off_layers, off_porder, off_coefw, off_k2w, side_k, max_parts

    def _pick_width(self, n: int) -> int:
        """Residual-plane width class for the next dispatch of length n:
        the narrowest class covering the widest residual that the last
        drained batch of this length produced (a misprediction costs an
        int32 row fetch, never a byte of the stream)."""
        classes = _res_width_classes(self.parameter.bits_per_sample)
        seen = self._maxw_seen.get(n)
        if seen is None:
            return classes[0]
        for w in reversed(classes):  # narrowest first
            if w >= seen:
                return w
        return classes[0]

    # -- serialization ------------------------------------------------------

    def _write_compress_payload(self, pprev, pcoef, log2u, rshift, coefs,
                                porder, k2s, residual_b: np.ndarray) -> bytes:
        """All side arrays are per-block [C, ...] int32; residual [C, n]."""
        p = self.parameter
        orders = self.preset.layer_num_params
        return native.pack_compress_payload(
            residual_b, coefs, log2u, rshift, pprev, pcoef, porder, k2s,
            self.codebook.codes_array, self.codebook.lens_array,
            p.bits_per_sample, np.asarray(orders, dtype=np.int32))

    # -- public API ---------------------------------------------------------

    def _header(self, num_samples: int) -> bytes:
        p = self.parameter
        return LinneHeader(
            num_channels=p.num_channels, num_samples=num_samples,
            sampling_rate=p.sampling_rate, bits_per_sample=p.bits_per_sample,
            num_samples_per_block=p.num_samples_per_block, preset=p.preset,
            ch_process_method=p.ch_process_method).pack()

    def _full_batches(self, blocks: np.ndarray):
        """Yield (chunk, block_len, real) batches of [N, C, spb] blocks,
        each padded to its _batch_cover."""
        spb = self.parameter.num_samples_per_block
        for start in range(0, blocks.shape[0], self.batch_blocks):
            chunk = blocks[start : start + self.batch_blocks]
            real = chunk.shape[0]
            cover = self._batch_cover(real)
            if real < cover:  # pad rows are dropped in the drain
                pad = np.zeros((cover - real,) + chunk.shape[1:], np.int32)
                chunk = np.concatenate([chunk, pad], axis=0)
            yield (chunk, spb, real)

    def encode_whole(self, channels: Sequence[np.ndarray],
                     num_samples: int, progress_cb=None) -> bytes:
        if self.parameter is None:
            raise RuntimeError("set_encode_parameter not called")
        with span("encode"):
            p = self.parameter
            spb = p.num_samples_per_block
            out = bytearray(self._header(num_samples))
            num_full = num_samples // spb
            tail = num_samples - num_full * spb
            signal = np.stack([np.asarray(c[:num_samples], dtype=np.int32)
                               for c in channels[: p.num_channels]])

            def gen_batches():
                if num_full:
                    blocks = signal[:, : num_full * spb].reshape(
                        p.num_channels, num_full, spb).transpose(1, 0, 2)
                    yield from self._full_batches(blocks)
                if tail:
                    tail_sig = signal[:, num_full * spb :]
                    if not compress_viable(self.preset, spb, tail):
                        # too short for any unit split (the reference
                        # segfaults on such tails): frame raw/silent on
                        # the host
                        yield self._frame_short_block(tail_sig, tail)
                        return
                    if self._use_host_tail(tail):
                        yield self._encode_tail_host(tail_sig, tail)
                        return
                    tail_block = np.zeros((1, p.num_channels, tail), np.int32)
                    tail_block[0] = tail_sig
                    yield (tail_block, tail, 1)

            done = 0
            for item in self._pipeline(gen_batches()):
                if isinstance(item, bytes):  # host-framed short block
                    out += item
                    done = num_samples
                else:
                    out += b"".join(self._drain_batch(*item))
                    done += item[3] * item[2]  # real blocks * block length
                if progress_cb is not None:
                    progress_cb(min(done, num_samples), num_samples)
            return bytes(out)

    def _pipeline(self, batch_args):
        """Dispatch ahead by PIPELINE_DEPTH, yielding dispatched items in
        order for draining. Pre-framed bytes (host-encoded short blocks)
        pass through after the batches in flight, preserving block order."""
        pending = deque()
        for args in batch_args:
            if isinstance(args, bytes):
                while pending:
                    yield pending.popleft()
                yield args
                continue
            if len(pending) >= self.PIPELINE_DEPTH:
                yield pending.popleft()
            pending.append(self._dispatch_batch(*args))
        while pending:
            yield pending.popleft()

    def _batch_cover(self, real: int) -> int:
        """Device batch rows for a partial batch of `real` real blocks: the
        pow-2 cover, floored at 8 and capped at batch_blocks. Rows are
        independent, so the padding changes no emitted byte."""
        c = 8
        while c < real:
            c *= 2
        return min(c, self.batch_blocks)

    def _use_host_tail(self, n: int) -> bool:
        """Whether tail blocks of length n take the byte-exact host encoder
        (see tail_mode in __init__)."""
        if self.tail_mode == "host":
            return True
        if self.tail_mode == "device":
            return False
        return n not in self._analyze_cache

    def _encode_tail_host(self, block_sig: np.ndarray, n: int) -> bytes:
        """Frame one partial block via the byte-exact host encoder. Every
        tail gets a fresh encoder: the reference encodes each track with
        its own encoder state, so tail bytes do not depend on other tracks
        and tails can encode on worker threads in any order."""
        from ..exact.encoder import ExactEncoder

        enc = ExactEncoder(self.config)
        enc.set_encode_parameter(self.parameter)
        nch = self.parameter.num_channels
        return enc.encode_block([block_sig[c, :n] for c in range(nch)], n)

    def _frame_short_block(self, block_sig: np.ndarray, n: int) -> bytes:
        """Host-framed raw/silent block for lengths with no admissible unit
        split (shorter than the largest layer order)."""
        p = self.parameter
        if not np.any(block_sig[:, :n]):
            return frame_block(BLOCK_TYPE_SILENT, n, b"")
        payload = write_raw_payload(
            [block_sig[ch, :n] for ch in range(p.num_channels)],
            p.bits_per_sample)
        return frame_block(BLOCK_TYPE_RAW, n, payload)

    def _stage_graphs(self, device: torch.device):
        """The StageGraphs of a CUDA device, made at its first batch; None
        for the CPU, which runs the stage chain eagerly."""
        if device.type != "cuda":
            return None
        if device.index is None:  # "cuda": the card that is current
            device = torch.device("cuda", torch.cuda.current_device())
        graphs = self._graphs.get(device)
        if graphs is None:
            graphs = self._graphs[device] = StageGraphs(device)
        return graphs

    def _run_stages(self, rows: torch.Tensor, n: int, device: torch.device,
                    W: Optional[int] = None):
        """The stage chain on one shard's [B, C, width] rows (a host or a
        device tensor) on `device` at residual width W (default the widest
        class): (packed, residual). On a CUDA device the stages run as the
        device's graphs (codec/graphs.py; eagerly at a shape's first
        batches): the rows are copied into G1's static input, then G1 runs,
        then (with `-a`/`-l`) the eager middle on G1's outputs, its params
        copied into G2's static inputs, then G2. `residual` is a copy the
        caller may keep; `packed` may be G2's static output, valid until
        the next run of this device's graphs. The CPU runs the chain
        eagerly."""
        chain = self._stage_chain(n)
        if W is None:
            W = _res_pack_width(self.parameter.bits_per_sample)
        graphs = self._stage_graphs(device)
        if graphs is None:
            out = chain.analyze(rows.to(device), W)
            return out["packed"], out["residual"]
        shape = (n, rows.shape[0], rows.shape[1], rows.dtype)
        blocks = graphs.buffer(("blocks",) + shape, rows.shape, rows.dtype)
        blocks.copy_(rows, non_blocking=True)
        out = graphs.run(("g1",) + shape, chain.g1, (blocks,))
        params = out.params
        if chain.middle is not None:
            params = []
            for li, p in enumerate(chain.middle(out)):
                held = graphs.buffer(("params",) + shape + (li,), p.shape,
                                     p.dtype)
                held.copy_(p)
                params.append(held)
        packed, residual = graphs.run(
            ("g2",) + shape + (W,), functools.partial(chain.g2, W=W),
            (out, tuple(params)))
        # kept per dispatch: the next batches' replays overwrite the static
        # residual before this batch drains and fetches its overflow rows
        return packed, residual.clone()

    def _dispatch_batch(self, blocks: np.ndarray, n: int,
                        real: Optional[int] = None):
        """Launch the stages on one [B, C, >=n] batch at the residual
        width _pick_width chooses and start the copy of the packed result
        to the host. Returns the item _drain_batch takes."""
        with span("encode.dispatch"):
            with span("encode.dispatch.stage"):
                num_analyze = self._stage_chain(n).num_analyze
                W = self._pick_width(n)
                self.batch_widths.append(W)
                width = max(n, num_analyze)
                if blocks.shape[-1] < width:
                    pad = np.zeros(
                        blocks.shape[:-1] + (width - blocks.shape[-1],),
                        dtype=np.int32)
                    blocks = np.concatenate([blocks, pad], axis=-1)
                if real is None:
                    real = blocks.shape[0]
                if self.parameter.bits_per_sample <= 16:
                    up = blocks.astype(np.int16)  # halve the upload
                else:
                    up = np.ascontiguousarray(blocks, dtype=np.int32)
                # rows beyond the real ones (zero, dropped in the drain)
                # make the shards equal
                up = pad_rows(up, len(self.devices))
            outs = []
            for d, a, b in shards(self.devices, up.shape[0]):
                with on_device(d):
                    with span("encode.dispatch.stage"):
                        rows = torch.from_numpy(up[a:b])
                        if d.type == "cuda":
                            rows = rows.pin_memory()  # a non-blocking upload
                    with span("encode.dispatch.launch"):
                        packed, residual = self._run_stages(rows, n, d, W)
                    with span("encode.dispatch.fetch"):
                        if d.type == "cuda":
                            host = torch.empty(packed.shape,
                                               dtype=torch.int32,
                                               pin_memory=True)
                            host.copy_(packed, non_blocking=True)
                            ready = torch.cuda.Event()
                            ready.record(torch.cuda.current_stream(d))
                        else:
                            host, ready = packed, None
                # the residual stays on the device for the overflow fetch
                outs.append((host, ready, residual, a))
        return (outs, blocks, n, real, W)

    def _encode_batch(self, blocks: np.ndarray, n: int) -> bytes:
        """blocks: [B, C, >=n] int32; returns framed block bytes."""
        return b"".join(self._drain_batch(*self._dispatch_batch(blocks, n)))

    def encode_block(self, channels: Sequence[np.ndarray], n: int) -> bytes:
        """Encode ONE framed block (API parity with
        LINNEEncoder_EncodeBlock, include/linne_encoder.h). For throughput
        use encode_whole/encode_many — they batch blocks."""
        p = self.parameter
        with span("encode"):
            block = np.zeros((1, p.num_channels, n), dtype=np.int32)
            for c in range(p.num_channels):
                block[0, c] = np.asarray(channels[c][:n], dtype=np.int32)
            if not compress_viable(self.preset, p.num_samples_per_block, n):
                return self._frame_short_block(block[0], n)
            if n < p.num_samples_per_block and self._use_host_tail(n):
                return self._encode_tail_host(block[0], n)
            return self._encode_batch(block, n)

    def encode_many(self, tracks: Sequence[Sequence[np.ndarray]],
                    num_samples: Sequence[int]) -> List[bytes]:
        """Encode a corpus: full blocks from ALL tracks are batched
        together, tails are grouped by length. Returns one .lnn byte string
        per track. Tails follow the same rule as encode_whole
        (_use_host_tail), so the two APIs produce identical bytes."""
        with span("encode"):
            p = self.parameter
            spb = p.num_samples_per_block
            nch = p.num_channels
            tail_pool = None
            try:
                with span("encode.split"):
                    track_lengths = []
                    placements = []  # (track, block in track), in order
                    all_full = []
                    tails = {}  # length -> list of (track, block, data)
                    for ti, (chans, ns) in enumerate(zip(tracks,
                                                         num_samples)):
                        sig = np.stack([np.asarray(c[:ns], dtype=np.int32)
                                        for c in chans[:nch]])
                        track_lengths.append(ns)
                        nfull = ns // spb
                        for b in range(nfull):
                            all_full.append(sig[:, b * spb : (b + 1) * spb])
                            placements.append((ti, b))
                        tail = ns - nfull * spb
                        if tail:
                            tails.setdefault(tail, []).append(
                                (ti, nfull, sig[:, nfull * spb :]))

                    per_track_blocks = {ti: {} for ti in range(len(tracks))}

                    # classify tails before the device loop: host tails are
                    # standalone blocks, so they encode on worker threads
                    # while this thread feeds the device; the decision must
                    # not see lengths built later here
                    host_tail_members = []  # (ti, b, data, tail_len)
                    device_tails = []
                    for tail_len, members in tails.items():
                        if not compress_viable(self.preset, spb, tail_len):
                            for ti, b, data in members:
                                per_track_blocks[ti][b] = \
                                    self._frame_short_block(data, tail_len)
                        elif self._use_host_tail(tail_len):
                            host_tail_members.extend(
                                (ti, b, data, tail_len)
                                for ti, b, data in members)
                        else:
                            device_tails.append((tail_len, members))

                    tail_futures = []
                    if host_tail_members:
                        tail_pool = ThreadPoolExecutor(max_workers=min(
                            len(host_tail_members), os.cpu_count() or 1))
                        tail_futures = [
                            tail_pool.submit(self._encode_tail_host, data, tl)
                            for (_ti, _b, data, tl) in host_tail_members]
                    full_blocks = np.stack(all_full) if all_full else None
                if full_blocks is not None:
                    start = 0
                    for item in self._pipeline(
                            self._full_batches(full_blocks)):
                        framed = self._drain_batch(*item)
                        for off, block_bytes in enumerate(framed):
                            ti, b = placements[start + off]
                            per_track_blocks[ti][b] = block_bytes
                        start += item[3]
                with span("encode.tails"):
                    for tail_len, members in device_tails:
                        batch = np.stack([m[2] for m in members])
                        framed = self._drain_batch(
                            *self._dispatch_batch(batch, tail_len))
                        for (ti, b, _), block_bytes in zip(members, framed):
                            per_track_blocks[ti][b] = block_bytes
                    for (ti, b, _d, _tl), fut in zip(host_tail_members,
                                                     tail_futures):
                        per_track_blocks[ti][b] = fut.result()
            finally:
                if tail_pool is not None:
                    tail_pool.shutdown()

            with span("encode.frame"):
                return [self._header(ns) + b"".join(
                            per_track_blocks[ti][b]
                            for b in sorted(per_track_blocks[ti]))
                        for ti, ns in enumerate(track_lengths)]

    @staticmethod
    def _unpack_bytes(words: np.ndarray, count: int,
                      signed: bool) -> np.ndarray:
        """[..., K] int32 words -> [..., count] int32 byte values."""
        w = np.ascontiguousarray(words).view(np.uint8)
        w = w.reshape(words.shape[:-1] + (-1,))[..., :count]
        if signed:
            return w.view(np.int8).astype(np.int32)
        return w.astype(np.int32)

    def _drain_batch(self, out, blocks: np.ndarray, n: int, real: int,
                     W: int) -> List[bytes]:
        """Wait for one dispatched batch's packed shards to reach the host
        and frame its first `real` blocks. Blocks whose residual is wider
        than W take their int32 rows from the shard that holds them; raw
        and silent blocks read no residual."""
        with span("encode.drain"):
            with span("encode.drain.wait"):
                for _host, ready, _res, _a in out:
                    if ready is not None:
                        ready.synchronize()
            parts = [host.numpy() for host, _ready, _res, _a in out]
            packed = (parts[0] if len(parts) == 1
                      else np.concatenate(parts))  # [B, C, side_k + words]
            self.bytes_to_host += packed.nbytes
            p = self.parameter
            total_order = sum(self.preset.layer_num_params)
            (off_layers, off_porder, off_coefw, off_k2w, side_k,
             max_parts) = self._side_layout(n)
            side = packed[..., :side_k]
            words = packed[..., side_k:]
            raw = side[:, 0, 0] != 0
            silent = side[:, 0, 1] != 0
            maxw = side[:, 0, 2]
            # feed the width choice of the next batch of this length from
            # the blocks that carry residuals
            live = ~raw[:real] & ~silent[:real]
            if live.any():
                self._maxw_seen[n] = int(maxw[:real][live].max())
            over = np.nonzero((maxw[:real] > W) & live)[0]
            full = {}  # block -> its int32 residual rows, fetched past W
            with span("encode.drain.overflow"):
                for _host, _ready, residual, a in out:
                    mine = over[(over >= a) & (over < a + residual.shape[0])]
                    if mine.size:
                        idx = torch.from_numpy(mine - a).to(residual.device)
                        rows = residual.index_select(0, idx).cpu().numpy()
                        # the pageable upload of idx and the blocking read
                        self.queue_waits += 2
                        full.update(zip(mine.tolist(), rows))
                        self.overflow_rows += int(mine.size)
                        self.bytes_to_host += rows.nbytes

            def residual_of(b: int) -> np.ndarray:
                """Block b's [C, n] residual: unpacked from the W-bit plane
                on the packing thread (the native unpack runs without the
                GIL), or its fetched int32 rows."""
                if b in full:
                    return full[b][:, :n]
                g, _ = pack_geometry(W)
                return native.unpack_bits(words[b], W, _roundup(n, g))[:, :n]

            with span("encode.drain.pack"):
                pprev = side[..., 3 : 3 + NUM_PREEMPH_FILTERS]
                pcoef = side[..., 3 + NUM_PREEMPH_FILTERS : off_layers]
                log2u = side[..., off_layers : off_porder : 2]
                rshift = side[..., off_layers + 1 : off_porder : 2]
                porder = side[..., off_porder]
                coefs = self._unpack_bytes(side[..., off_coefw:off_k2w],
                                           total_order, signed=True)
                k2s = self._unpack_bytes(side[..., off_k2w:side_k],
                                         max_parts, signed=False)

                def pack_one(b: int) -> bytes:
                    if raw[b]:
                        payload = write_raw_payload(
                            [blocks[b, ch, :n]
                             for ch in range(p.num_channels)],
                            p.bits_per_sample)
                        btype = BLOCK_TYPE_RAW
                    elif silent[b]:
                        payload = b""
                        btype = BLOCK_TYPE_SILENT
                    else:
                        payload = self._write_compress_payload(
                            pprev[b], pcoef[b], log2u[b], rshift[b],
                            coefs[b], porder[b], k2s[b], residual_of(b))
                        btype = BLOCK_TYPE_COMPRESS
                    return frame_block(btype, n, payload)

                # blocks pack independently; the native payload packer runs
                # without the GIL, so thread on multicore hosts
                ncpu = os.cpu_count() or 1
                if real > 1 and ncpu > 1:
                    with ThreadPoolExecutor(max_workers=min(ncpu, 8)) as ex:
                        return list(ex.map(pack_one, range(real)))
                return [pack_one(b) for b in range(real)]
