"""Batched block encoder on torch tensors — the main encode path.
Counterpart of linne_tpu/codec/encoder.py:TpuEncoder.

Whole tracks are split into [blocks, channels, block_len] tensors. One
batch runs a chain of stages on the device (pre-processing: estimator, MS
transform, pre-emphasis; one unit x ridge sweep per layer; ridge selection;
with `-a N` an IRLS refit of each layer under the winning ridge
(ops/afmethod.py), with `-l` momentum training of the whole cascade
(ops/training.py); quantization, integer predict cascade and Rice parameter
search); the host then only packs bits with the native library.

Emitted streams are always losslessly decodable by the reference decoder
(integer predict/Rice semantics are wire-exact, and the residual is
recomputed from the quantized integers, mirroring linne_encoder.c:686-696).
The float analysis runs in float64 on every device (see ops/__init__.py),
so on the CPU the bytes equal TpuEncoder's float64 CPU bytes.

Each batch's int32 side tensor and int32 residual plane leave the device
in one non-blocking copy into pinned host memory; a CUDA event per batch
tells the drain when it has landed, and PIPELINE_DEPTH batches stay in
flight. With a device list (`devices=`, parallel/mesh.py) each batch's rows
split into one shard per entry, each with its own copy and event.
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

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
    PREEMPH_COEF_SHIFT,
    RSHIFT_BITWIDTH,
    TRAINING_LEARNING_RATE,
    TRAINING_LOSS_EPSILON,
    TRAINING_MAX_NUM_ITERATIONS,
)
from ..format.bitstream import BitWriter
from ..format.block import frame_block, write_raw_payload
from ..format.header import LinneHeader
from ..format.huffman import get_codebook
from ..format.rice import encode_plane_with_params
from ..format.zigzag import zigzag_encode_array, zigzag_encode_scalar
from ..presets import PRESETS

from ..ops import ANALYSIS_DTYPE
from ..ops import afmethod
from ..ops import analysis as A
from ..ops import intops as I
from ..ops import rice_search as R
from ..ops import training
from ..parallel.mesh import on_device, pad_rows, resolve_devices, shards

_RAW_THRESHOLD = float(np.float32(0.95))


def _roundup(val: int, n: int) -> int:
    return ((val + n - 1) // n) * n


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
        its length."""
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

    def set_encode_parameter(self, parameter: EncodeParameter) -> None:
        parameter.validate_against(self.config)
        self.parameter = parameter
        self.preset = PRESETS[parameter.preset]
        self.codebook = get_codebook(self.preset.coef_freq_table)
        self._analyze_cache = {}

    # -- the per-batch stage chain -----------------------------------------

    def _analyze_fn(self, n: int):
        """Build (and cache) the stage chain for block length n. Returns
        (analyze, num_analyze); analyze maps a [B, C, >=n] int16/int32
        device tensor to the packed [B, C, side_k + n] int32 result."""
        fn = self._analyze_cache.get(n)
        if fn is not None:
            return fn

        p = self.parameter
        dtype = self.dtype
        num_analyze = _roundup(n, 1 << LOG2_NUM_UNITS_BITWIDTH)
        num_analyze = min(p.num_samples_per_block,
                          max(self.preset.max_num_params, num_analyze))
        orders = self.preset.layer_num_params
        ridges = self.preset.ridge_terms
        nridge = len(ridges)
        unit_choices = [A.candidate_units(o, num_analyze) for o in orders]
        ms = p.ch_process_method == CH_PROCESS_MS
        bps = p.bits_per_sample

        def pre_stage(blocks):  # [B, C, max(n, num_analyze)]
            blocks = blocks.to(torch.int32)
            raw_sig = I.normalize_to_float(blocks[..., :n], bps, dtype)
            est = A.estimate_code_length(raw_sig, orders[0], bps)
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
            rv = torch.tensor(ridges, dtype=sig_r.dtype,
                              device=sig_r.device).reshape(
                (nridge,) + (1,) * (sig_r.dim() - 1))
            return A.fit_layer(sig_r, order, rv)

        def select_stage(final_res, log2u_r, params_r):
            # winning ridge: first minimum, as the reference's strict-<
            # sweep; returns its per-layer selections and its ridge term
            final_loss = (torch.sum(torch.abs(final_res), dim=-1)
                          / final_res.shape[-1])
            best = torch.argmin(final_loss, dim=0)
            rv = torch.tensor(ridges, dtype=dtype, device=best.device)
            return ([A.take_ridge(l, best) for l in log2u_r],
                    [A.take_ridge(f, best) for f in params_r], rv[best])

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

        def finish_stage(raw_flag, silent_flag, pprev, pcoef, buf, log2u,
                         params):
            int_coefs = []
            rshifts = []
            for li in range(len(orders)):
                ic, rs = A.quantize_coefficients(params[li],
                                                 LPC_COEF_BITWIDTH)
                int_coefs.append(ic)
                rshifts.append(rs)
            x = buf[..., :n]
            for li in range(len(orders)):
                x = I.predict_cascade_layer(x, int_coefs[li], log2u[li],
                                            rshifts[li], unit_choices[li])
            porder, k2s = R.rice_search(x, dtype)
            B, C = x.shape[0], x.shape[1]

            def bc1(v):  # [B] -> [B, C, 1]
                return v.to(torch.int32)[:, None, None].expand(B, C, 1)

            parts = [bc1(raw_flag), bc1(silent_flag), pprev, pcoef]
            for li in range(len(orders)):
                parts.append(log2u[li].unsqueeze(-1))
                parts.append(rshifts[li].unsqueeze(-1))
            parts.append(porder.unsqueeze(-1))
            parts.extend(int_coefs)
            parts.append(k2s)
            parts.append(x)
            return torch.cat([t.to(torch.int32) for t in parts], dim=-1)

        def analyze(blocks):
            raw_flag, silent_flag, pprev, pcoef, buf, sig_r = pre_stage(blocks)
            log2u_r = []
            params_r = []
            x = sig_r
            for order in orders:
                log2u, flat, x, _loss = fit_stage(x, order)
                log2u_r.append(log2u)
                params_r.append(flat)
            log2u, params, ridge_val = select_stage(x, log2u_r, params_r)
            if af_stages is not None:
                # AF-refined final pass: refit layer by layer with IRLS
                # under the winning ridge, cascading residuals
                xa = sig_r[0]
                params = []
                for stage, layer_log2u in zip(af_stages, log2u):
                    flat, xa = stage(xa, layer_log2u, ridge_val)
                    params.append(flat)
            if train is not None:
                # rows train independently, so padding rows (all zero:
                # they stop after two iterations) change no real row
                params, _iterations = train(sig_r[0], params, log2u)
            return finish_stage(raw_flag, silent_flag, pprev, pcoef, buf,
                                log2u, params)

        self._analyze_cache[n] = (analyze, num_analyze)
        return self._analyze_cache[n]

    def _side_layout(self, n: int):
        """Offsets into the packed result (see finish_stage): flags,
        pre-emphasis state, per-layer (log2u, rshift), porder, the
        coefficient plane, the k2 plane, then the residual plane."""
        L = self.preset.num_layers
        total_order = sum(self.preset.layer_num_params)
        max_parts = 1 << R.max_porder_for(n)
        off_layers = 2 + 2 * NUM_PREEMPH_FILTERS
        off_porder = off_layers + 2 * L
        off_coef = off_porder + 1
        off_k2 = off_coef + total_order
        side_k = off_k2 + max_parts
        return off_layers, off_porder, off_coef, off_k2, side_k

    # -- serialization ------------------------------------------------------

    def _write_compress_payload(self, pprev, pcoef, log2u, rshift, coefs,
                                porder, k2s, residual_b: np.ndarray) -> bytes:
        """All side arrays are per-block [C, ...] int32; residual [C, n]."""
        p = self.parameter
        orders = self.preset.layer_num_params
        if native.available():
            return native.pack_compress_payload(
                residual_b, coefs, log2u, rshift, pprev, pcoef, porder, k2s,
                self.codebook.codes_array, self.codebook.lens_array,
                p.bits_per_sample, np.asarray(orders, dtype=np.int32))
        w = BitWriter()
        for ch in range(p.num_channels):
            for stage in range(NUM_PREEMPH_FILTERS):
                w.put(zigzag_encode_scalar(int(pprev[ch, stage])),
                      p.bits_per_sample + 1)
                w.put(int(pcoef[ch, stage]), PREEMPH_COEF_SHIFT - 1)
        for ch in range(p.num_channels):
            base = 0
            for li in range(self.preset.num_layers):
                w.put(int(log2u[ch, li]), LOG2_NUM_UNITS_BITWIDTH)
                w.put(int(rshift[ch, li]), RSHIFT_BITWIDTH)
                layer_coefs = coefs[ch, base : base + orders[li]]
                base += orders[li]
                for u in zigzag_encode_array(layer_coefs).tolist():
                    self.codebook.put(w, u)
        for ch in range(p.num_channels):
            encode_plane_with_params(
                w, residual_b[ch], int(porder[ch]), k2s[ch])
        w.flush()
        return w.getvalue()

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
                    # too short for any unit split (the reference segfaults
                    # on such tails): frame raw/silent on the host
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

    def _dispatch_batch(self, blocks: np.ndarray, n: int,
                        real: Optional[int] = None):
        """Launch the stages on one [B, C, >=n] batch and start the copy of
        the packed result to the host. Returns the item _drain_batch
        takes."""
        fn, num_analyze = self._analyze_fn(n)
        width = max(n, num_analyze)
        if blocks.shape[-1] < width:
            pad = np.zeros(blocks.shape[:-1] + (width - blocks.shape[-1],),
                           dtype=np.int32)
            blocks = np.concatenate([blocks, pad], axis=-1)
        if real is None:
            real = blocks.shape[0]
        if self.parameter.bits_per_sample <= 16:
            up = blocks.astype(np.int16)  # halve the upload
        else:
            up = np.ascontiguousarray(blocks, dtype=np.int32)
        # rows beyond the real ones (zero, dropped in the drain) make the
        # shards equal
        up = pad_rows(up, len(self.devices))
        outs = []
        for d, a, b in shards(self.devices, up.shape[0]):
            with on_device(d):
                packed = fn(torch.from_numpy(up[a:b]).to(d))
                if d.type == "cuda":
                    host = torch.empty(packed.shape, dtype=torch.int32,
                                       pin_memory=True)
                    host.copy_(packed, non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record(torch.cuda.current_stream(d))
                else:
                    host, ready = packed, None
            outs.append((host, ready))
        return (outs, blocks, n, real)

    def _encode_batch(self, blocks: np.ndarray, n: int) -> bytes:
        """blocks: [B, C, >=n] int32; returns framed block bytes."""
        return b"".join(self._drain_batch(*self._dispatch_batch(blocks, n)))

    def encode_block(self, channels: Sequence[np.ndarray], n: int) -> bytes:
        """Encode ONE framed block (API parity with
        LINNEEncoder_EncodeBlock, include/linne_encoder.h). For throughput
        use encode_whole/encode_many — they batch blocks."""
        p = self.parameter
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
        p = self.parameter
        spb = p.num_samples_per_block
        nch = p.num_channels

        track_lengths = []
        placements = []  # (track, block_index_in_track) in global order
        all_full = []
        tails = {}  # length -> list of (track_idx, block_idx, data)
        for ti, (chans, ns) in enumerate(zip(tracks, num_samples)):
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

        # classify tails before the device loop: host tails are standalone
        # blocks, so they encode on worker threads while this thread feeds
        # the device; the decision must not see lengths built later here
        host_tail_members = []  # (ti, b, data, tail_len)
        device_tails = []
        for tail_len, members in tails.items():
            if not compress_viable(self.preset, spb, tail_len):
                for ti, b, data in members:
                    per_track_blocks[ti][b] = self._frame_short_block(
                        data, tail_len)
            elif self._use_host_tail(tail_len):
                host_tail_members.extend(
                    (ti, b, data, tail_len) for ti, b, data in members)
            else:
                device_tails.append((tail_len, members))

        tail_pool = None
        tail_futures = []
        if host_tail_members:
            tail_pool = ThreadPoolExecutor(
                max_workers=min(len(host_tail_members), os.cpu_count() or 1))
            tail_futures = [
                tail_pool.submit(self._encode_tail_host, data, tl)
                for (_ti, _b, data, tl) in host_tail_members]
        try:
            if all_full:
                start = 0
                for item in self._pipeline(
                        self._full_batches(np.stack(all_full))):
                    framed = self._drain_batch(*item)
                    for off, block_bytes in enumerate(framed):
                        ti, b = placements[start + off]
                        per_track_blocks[ti][b] = block_bytes
                    start += item[3]
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

        return [self._header(ns) + b"".join(
                    per_track_blocks[ti][b]
                    for b in sorted(per_track_blocks[ti]))
                for ti, ns in enumerate(track_lengths)]

    def _drain_batch(self, out, blocks: np.ndarray, n: int,
                     real: int) -> List[bytes]:
        """Wait for one dispatched batch's packed shards to reach the host
        and frame its first `real` blocks."""
        for _host, ready in out:
            if ready is not None:
                ready.synchronize()
        parts = [host.numpy() for host, _ready in out]
        packed = (parts[0] if len(parts) == 1
                  else np.concatenate(parts))      # [B, C, side_k + n]
        p = self.parameter
        L = self.preset.num_layers
        off_layers, off_porder, off_coef, off_k2, side_k = (
            self._side_layout(n))
        raw = packed[:, 0, 0] != 0
        silent = packed[:, 0, 1] != 0
        pprev = packed[..., 2 : 2 + NUM_PREEMPH_FILTERS]
        pcoef = packed[..., 2 + NUM_PREEMPH_FILTERS : off_layers]
        log2u = packed[..., off_layers : off_porder : 2]
        rshift = packed[..., off_layers + 1 : off_porder : 2]
        porder = packed[..., off_porder]
        coefs = packed[..., off_coef:off_k2]
        k2s = packed[..., off_k2:side_k]
        res = packed[..., side_k : side_k + n]

        def pack_one(b: int) -> bytes:
            if raw[b]:
                payload = write_raw_payload(
                    [blocks[b, ch, :n] for ch in range(p.num_channels)],
                    p.bits_per_sample)
                btype = BLOCK_TYPE_RAW
            elif silent[b]:
                payload = b""
                btype = BLOCK_TYPE_SILENT
            else:
                payload = self._write_compress_payload(
                    pprev[b], pcoef[b], log2u[b], rshift[b], coefs[b],
                    porder[b], k2s[b], res[b])
                btype = BLOCK_TYPE_COMPRESS
            return frame_block(btype, n, payload)

        # blocks pack independently; the native payload packer runs without
        # the GIL, so thread on multicore hosts
        ncpu = os.cpu_count() or 1
        if real > 1 and ncpu > 1 and native.available():
            with ThreadPoolExecutor(max_workers=min(ncpu, 8)) as ex:
                return list(ex.map(pack_one, range(real)))
        return [pack_one(b) for b in range(real)]
