"""Byte-exact `.lnn` encoding with the analysis on a torch device.
Counterpart of linne_tpu/exact/device_encoder.py.

`DeviceExactEncoder` produces bitstreams byte-identical to the reference C
encoder (same contract as `ExactEncoder`), but runs the expensive per-block
network fitting — ridge sweep, unit-count search, Levinson-Durbin, greedy
layer cascade, error-feedback quantization (reference:
libs/linne_network/src/linne_network.c:582-630, libs/lpc/src/lpc.c:252-324,
981-1040) — batched over [blocks x channels] rows by `ops.exact_device`,
on the card by default, instead of the host oracle's sequential loops.

Why this decomposition is sound: at even unit sub-lengths (always true for
full blocks) the fits never *read* the shared `LPCCalculator` arena before
writing it, so every (block, channel) fit is independent — only two serial
strands remain, and both stay on the host:

- the block-type decision (`estimate_code_length`) reads one stale arena
  element left by the previous compressed block's fits
  (lpc.c:846-848); after each compressed block the device fit's arena
  writes are replayed into the host arena (`fold_parcor_state`) so the
  next decision sees identical state;
- the bitstream itself (entropy coding, framing) is serial by format.

`-a N` runs as a staged hybrid: the ridge sweep, the final pass's unit
searches and the layer forwards run on the device; the N-iteration IRLS
refit (lpc.c:578-661) runs on the host, because its Cholesky's libm
`pow(s, -0.5)` is not correctly rounded on glibc. `-l` training runs
host-side (native) per block in `_fit_quantize_channel`, seeded with the
device-prefit params. Tail blocks and any shape `exact_device.supported`
rejects take the host oracle fit for that block, preserving arena order.

With a device list (`devices=`, parallel/mesh.py) each fit chunk's rows
split into one contiguous shard per entry: fit rows are independent, so
the bytes equal the one-device encode's.

The card's float64 is IEEE and the fit runs the strict serial graph there
(ops/exact_device.py), so the device fit is bit-identical to the oracle by
construction. The margin guard stays all the same: every decision (unit
level, ridge term, quantizer rounding, zero cases, block-type threshold)
must clear the `_MARGIN_*` bounds or the row takes the host oracle.
"""

from __future__ import annotations

import threading
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..constants import CH_PROCESS_MS, LPC_COEF_BITWIDTH, NUM_PREEMPH_FILTERS
from ..codec.params import EncoderConfig, EncodeParameter
from ..ops import exact_device as _dev
from ..parallel.mesh import on_device, resolve_devices, shards
from .encoder import ExactEncoder
from .filters import ms_conversion, preemphasis, preemphasis_calculate_coefficient

# Fit rows per device batch.
_CHUNK = 128

# Byte-identity guard bounds. A fit row whose decision margins fall below
# the bounds is re-fit on the host oracle instead.
#   REL: relative margins (zero-signal epsilon tests, unit-level and
#        ridge-term argmin gaps, frexp/low rshift boundaries).
#   ABS: absolute distance of an error-feedback quantizer step to its
#        round-half-away boundary, in quantized-coefficient LSBs (param
#        drift enters scaled by 2^rshift <= 2^14, so the bound is wider).
_MARGIN_REL = 1e-9
_MARGIN_ABS = 1e-6


def preemph_plane(parameter, channels: Sequence[np.ndarray],
                  n: int) -> np.ndarray:
    """MS + two pre-emphasis stages for one block, on host int32 — the same
    transform `_encode_compress_payload` applies (linne_encoder.c:624-641),
    without side-info bookkeeping. Shared by the device-exact and
    thread-parallel exact prefit passes."""
    return preemph_plane_side(parameter, channels, n)[0]


def preemph_plane_side(parameter, channels: Sequence[np.ndarray], n: int
                       ) -> Tuple[np.ndarray, list]:
    """`preemph_plane` plus the per-channel [(prev, coef), ...] side-info
    stages the payload serializer writes — returned so the prefit's plane
    can be REUSED by `_encode_compress_payload` instead of recomputed (the
    transform is deterministic integer math, so the cached plane is the
    byte-identical one)."""
    buf = np.stack([c[:n].astype(np.int32) for c in
                    channels[: parameter.num_channels]])
    if parameter.ch_process_method == CH_PROCESS_MS:
        ms_conversion(buf[0], buf[1])
    stages_all = []
    for ch in range(parameter.num_channels):
        stages = []
        for _stage in range(NUM_PREEMPH_FILTERS):
            prev = int(buf[ch, 0])
            coef = preemphasis_calculate_coefficient(buf[ch], n)
            preemphasis(buf[ch], n, prev, coef)
            stages.append((prev, coef))
        stages_all.append(stages)
    return buf, stages_all


class _Pending(NamedTuple):
    """One dispatched fit chunk: per row shard, its two packed buffers
    (pinned host copies in flight on a card, the results themselves on the
    CPU) and the CUDA event that marks the copies done (None on the CPU);
    and the chunk's count of real (unpadded) rows."""
    parts: List[Tuple[torch.Tensor, torch.Tensor, "torch.cuda.Event | None"]]
    valid: int

    def fetch(self) -> Tuple[np.ndarray, np.ndarray]:
        for _f64, _i32, done in self.parts:
            if done is not None:
                done.synchronize()
        return tuple(
            np.concatenate([part[k].numpy() for part in self.parts]
                           )[: self.valid] for k in (0, 1))


class DeviceExactEncoder(ExactEncoder):
    """ExactEncoder with the per-block network fitting batched on device."""

    def __init__(self, config: EncoderConfig | None = None, device=None,
                 devices=None):
        """`device`: where the fits run (default "cuda"; "cpu" only when
        asked for). `devices`: a device list instead (parallel/mesh.py):
        each fit chunk's rows split over it; the chunk size must divide
        by its length."""
        super().__init__(config)
        self._devices = resolve_devices(device, devices)
        if _CHUNK % len(self._devices):
            raise ValueError(
                f"the fit chunk of {_CHUNK} rows does not divide over "
                f"{len(self._devices)} devices")
        self._fit_cache: Dict[int, dict] = {}
        # full-block MS+preemph planes + side stages from the prefit,
        # consumed (popped) by _ms_preemph_stages so the payload encode
        # skips the duplicate transform
        self._plane_cache: Dict[int, tuple] = {}
        self._cache_preinstalled = False  # set (one-shot) by encode_many
        self._block_index = -1
        # byte-identity guard state (see _MARGIN_* above): rows refused for
        # low margins take the host oracle; the block-type decision margin
        # is checked in _estimate_mean_ratio
        self.guard_rows_total = 0
        self.guard_rows_flagged = 0
        self.guard_decisions_flagged = 0
        self._arena_device_dirty = False
        self._prev_fit_input = None  # (plane copy, num_analyze) of the
        #                              last device-cached compress block

    # -- batched prepass ----------------------------------------------------

    def _preemph_plane(self, channels: Sequence[np.ndarray], n: int,
                       block_index: int | None = None) -> np.ndarray:
        plane, stages = preemph_plane_side(self.parameter, channels, n)
        if block_index is not None:
            self._plane_cache[block_index] = (plane, stages)
        return plane

    def _ms_preemph_stages(self, channels: Sequence[np.ndarray],
                           n: int) -> List[list]:
        cached = self._plane_cache.pop(self._block_index, None)
        if cached is None or n != self.parameter.num_samples_per_block:
            return super()._ms_preemph_stages(channels, n)
        plane, stages = cached
        nch = self.parameter.num_channels
        self.buffer_int[:nch, :n] = plane
        self.buffer_int[:nch, n:] = 0
        return stages

    def _prefit_blocks(self, channels: Sequence[np.ndarray],
                       num_samples: int) -> None:
        """Fit every full block on the device in _CHUNK-row batches.

        Fits are arena-independent, so this runs before any block-type
        decision; blocks later deemed RAW/SILENT simply discard their entry.
        """
        p = self.parameter
        bs = p.num_samples_per_block
        if not _dev.supported(self.preset.layer_num_params, bs):
            return
        nch = p.num_channels
        full = []
        pos = 0
        idx = 0
        while pos < num_samples:
            n = min(bs, num_samples - pos)
            if n == bs:
                full.append((idx, pos))
            idx += 1
            pos += n
        if not full:
            return

        fit, unpack = _dev.build_packed_fit_fn(
            self.preset.layer_num_params, self.preset.ridge_terms, bs,
            p.bits_per_sample, LPC_COEF_BITWIDTH)

        planes = np.empty((len(full), nch, bs), dtype=np.int32)
        for row, (bi, pos) in enumerate(full):
            planes[row] = self._preemph_plane(
                [c[pos : pos + bs] for c in channels], bs, block_index=bi)

        rows = planes.reshape(len(full) * nch, bs)
        fetched = _fetch_valid_rows(
            self._dispatch_fit_chunks(rows, fit, bs), unpack)

        # re-split per block
        flat = [_row_view(fetched, r) for r in range(len(full) * nch)]
        if p.num_afmethod_iterations > 0:
            finals = self._final_pass_rows(rows, fetched)
            for r in range(len(flat)):
                flat[r]["final"] = finals[r]
        flat = [self._apply_guard(r) for r in flat]
        for row, (bi, _pos) in enumerate(full):
            self._fit_cache[bi] = _merge_rows(
                flat[row * nch : (row + 1) * nch])

    def _row_flagged(self, row: dict) -> bool:
        """True when a fit row's guard margins sit too close to a decision
        boundary. With -a N the sweep's quantizer margins are superseded by
        the host-quantize margins collected in `_final_pass_rows` (plus the
        final-pass search margins)."""
        m = np.asarray(row["margins"], np.float64)
        final = row.get("final")
        if final is None:
            return bool(m[0] < _MARGIN_REL or m[1] < _MARGIN_REL
                        or m[2] < _MARGIN_ABS)
        fm = np.asarray(final["margins"], np.float64)
        return bool(m[0] < _MARGIN_REL or fm[0] < _MARGIN_REL
                    or fm[1] < _MARGIN_REL or fm[2] < _MARGIN_ABS)

    def _apply_guard(self, row: dict | None) -> dict | None:
        """Count and drop (-> host-oracle fit) low-margin fit rows."""
        if row is None:
            return None
        self.guard_rows_total += 1
        if self._row_flagged(row):
            self.guard_rows_flagged += 1
            return None
        return row

    def _put(self, arr: np.ndarray) -> List[torch.Tensor]:
        """One host array's rows as one tensor per shard, each on its
        device (to a card through pinned memory, so the copy does not wait
        for the stream)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        out = []
        for d, a, b in shards(self._devices, t.shape[0]):
            if d.type == "cuda":
                out.append(t[a:b].pin_memory().to(d, non_blocking=True))
            else:
                out.append(t[a:b].to(d))
        return out

    def _final_pass_rows(self, rows: np.ndarray, fetched: dict) -> list:
        """The -a N final refit pass (linne_network.c:628-629) over the
        sweep's fit rows: per layer, the unit-count search and the forward
        run on the device (ops/exact_device final-pass fns), the N-iteration
        auxiliary-function refit runs on the host — the IRLS Cholesky's
        libm `pow(s, -0.5)` is not reproducible on the card, and host-side
        it IS the oracle.

        Returns one dict per row: {"units" [L], "params" [per-layer f64],
        "int_coefs" [per-layer i32], "rshifts" [L], "final_arena"
        [per-layer fold_final_pass entries]}.
        """
        from .lpc import LpcState, WINDOW_WELCH, quantize_coefficients

        p = self.parameter
        af = p.num_afmethod_iterations
        bs = p.num_samples_per_block
        lps = tuple(self.preset.layer_num_params)
        R = rows.shape[0]
        terms_all = np.asarray(self.preset.ridge_terms, np.float64)[
            np.asarray(fetched["best_term"])[:R]]
        to_f64, searches, forwards = _dev.build_final_pass_fns(
            lps, bs, p.bits_per_sample)
        lpcc = LpcState(self.config.max_num_parameters_per_layer,
                        self.config.max_num_samples_per_block)

        out_rows = [
            {"units": [], "params": [], "int_coefs": [], "rshifts": [],
             "final_arena": [],
             # guard sensors: [search-sel, scale, round] mins over layers
             "margins": [np.inf, np.inf, np.inf]}
            for _ in range(R)
        ]
        for start in range(0, R, _CHUNK):
            chunk = rows[start : start + _CHUNK]
            tchunk = terms_all[start : start + _CHUNK]
            C = chunk.shape[0]
            pad = _CHUNK - C
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad, bs), np.int32)])
                tchunk = np.concatenate([tchunk, np.zeros(pad)])
            # one entry per row shard, each on its device
            buf = _each(to_f64, self._put(chunk))
            t = self._put(tchunk)
            for li, P in enumerate(lps):
                s = _each(searches[li], buf, t)
                units = _host(x["units"] for x in s)
                buf_np = _host(buf)  # one copy to the host per layer
                params = np.zeros((chunk.shape[0], P), np.float64)
                for r in range(C):
                    u = int(units[r])
                    npu = P // u
                    ns = bs // u
                    for unit in range(u):
                        coefs = lpcc.calculate_coef_af(
                            buf_np[r, unit * ns :], ns, npu, af,
                            WINDOW_WELCH, float(tchunk[r]))
                        params[r, unit * npu : (unit + 1) * npu] = coefs[::-1]
                buf = _each(forwards[li], buf, self._put(params),
                            [x["best"] for x in s])
                parc = _host(x["parcor"] for x in s)
                zc = _host(x["zc"] for x in s)
                best = _host(x["best"] for x in s)
                smargin = _host(x["margin"] for x in s)
                for r in range(C):
                    g = out_rows[start + r]
                    g["units"].append(int(units[r]))
                    g["params"].append(params[r])
                    g["final_arena"].append({
                        "parcor": parc[r], "zc": zc[r], "best": int(best[r]),
                    })
                    ic, rs = quantize_coefficients(
                        params[r], P, LPC_COEF_BITWIDTH)
                    g["int_coefs"].append(
                        np.ascontiguousarray(ic[:P], np.int32))
                    g["rshifts"].append(int(rs))
                    rm, sm = _dev.quantize_margins_np(
                        params[r], LPC_COEF_BITWIDTH)
                    g["margins"][0] = min(g["margins"][0], float(smargin[r]))
                    g["margins"][1] = min(g["margins"][1], sm)
                    g["margins"][2] = min(g["margins"][2], rm)
        return out_rows

    def _dispatch_fit_chunks(self, rows: np.ndarray, fit, bs: int
                             ) -> List[_Pending]:
        """Launch the fit of [rows, bs] inputs in _CHUNK-row batches, each
        chunk's row shards on their devices' current streams, each shard
        followed by one non-blocking copy of its two packed buffers into
        pinned host memory and a CUDA event recorded on its device; nothing
        waits for a card here, so it computes chunk i while the host
        enqueues chunk i + 1. On the CPU each fit runs to its end."""
        pending = []
        for start in range(0, rows.shape[0], _CHUNK):
            chunk = rows[start : start + _CHUNK]
            pad = _CHUNK - chunk.shape[0]
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad, bs), np.int32)])
            parts = []
            for x in self._put(chunk):
                with on_device(x.device):
                    f64, i32 = fit(x)
                    done = None
                    if x.device.type == "cuda":
                        f64 = _pinned_copy(f64)
                        i32 = _pinned_copy(i32)
                        done = torch.cuda.Event()
                        done.record()
                parts.append((f64, i32, done))
            pending.append(_Pending(parts, chunk.shape[0] - pad))
        return pending

    # -- decision-margin guard ------------------------------------------------

    def _estimate_mean_ratio(self, channels: Sequence[np.ndarray],
                             n: int) -> float:
        """Block-type estimate with the guard's decision-margin check: the
        estimate reads ONE stale arena double left by the previous
        compressed block's fits (lpc.c:846-848). If the RAW threshold
        comparison sits within the guard's bound AND the arena's last
        writer was a device fit, the previous block's channels are re-fit
        on the host oracle (full blocks are arena-read-free, so this
        reproduces the oracle's post-block state exactly) and the estimate
        is recomputed."""
        r = super()._estimate_mean_ratio(channels, n)
        from .encoder import _RAW_THRESHOLD

        if (self._arena_device_dirty and self._prev_fit_input is not None
                and abs(r - _RAW_THRESHOLD) / _RAW_THRESHOLD < _MARGIN_REL):
            self.guard_decisions_flagged += 1
            p = self.parameter
            plane, num_analyze = self._prev_fit_input
            scale = 2.0 ** (-(p.bits_per_sample - 1))
            for ch in range(p.num_channels):
                self.buffer_double[:num_analyze] = (
                    plane[ch, :num_analyze].astype(np.float64) * scale)
                self.network.set_units_and_parameters(
                    self.buffer_double, num_analyze,
                    p.num_afmethod_iterations, self.preset.ridge_terms)
            self._arena_device_dirty = False
            r = super()._estimate_mean_ratio(channels, n)
        return r

    # -- per-block hook ------------------------------------------------------

    def _fit_quantize_channel(self, buf, ch: int, n: int, num_analyze: int
                              ) -> Tuple[List[int], List[int],
                                         List[np.ndarray]]:
        cached = self._fit_cache.get(self._block_index)
        if cached is None:
            # host-oracle fit (tail block or unsupported shape): rewrites
            # the arena exactly
            self._arena_device_dirty = False
            return super()._fit_quantize_channel(buf, ch, n, num_analyze)
        if ch == 0:
            # retained for the decision-margin arena refresh (full blocks
            # only — their fits are arena-read-free, so re-running them
            # reproduces the oracle's post-block arena exactly)
            self._prev_fit_input = (
                buf[: self.parameter.num_channels, :num_analyze].copy(),
                num_analyze)
        if cached["per_ch"][ch] is None:
            # guard-flagged row: host-oracle fit, arena exact afterwards
            self._arena_device_dirty = False
            return super()._fit_quantize_channel(buf, ch, n, num_analyze)
        self._arena_device_dirty = True

        # Replay the device fit's arena writes so the next block-type
        # decision reads identical state, then return the prefit side info
        # directly — units, error-feedback int coefficients and rshifts all
        # come from the batched fit. With -a N the final refit pass carries
        # its own arena deposits and host-quantized coefficients; with -l
        # the (native) trainer then fine-tunes the prefit params here, in
        # block order, exactly as the oracle does after
        # set_units_and_parameters (linne_encoder.c:669-676).
        p = self.parameter
        lps = self.preset.layer_num_params
        offsets = np.concatenate([[0], np.cumsum(lps)])
        row = cached["per_ch"][ch]
        final = row.get("final")
        _dev.fold_parcor_state(
            self.network.lpcc.parcor_coef, row, 1, lps,
            self.preset.ridge_terms, p.num_samples_per_block,
            include_final=final is None)
        if final is None:
            units_row = [int(u) for u in cached["units"][ch]]
            rshift_row = [int(r) for r in row["rshifts"]]
            coef_row = [
                np.ascontiguousarray(
                    row["int_coefs"][offsets[li] : offsets[li + 1]],
                    np.int32)
                for li in range(len(lps))]
            params_layers = [
                np.asarray(row["params"][offsets[li] : offsets[li + 1]],
                           np.float64)
                for li in range(len(lps))]
        else:
            _dev.fold_final_pass(
                self.network.lpcc.parcor_coef, final["final_arena"], lps,
                p.num_samples_per_block)
            units_row = list(final["units"])
            rshift_row = list(final["rshifts"])
            coef_row = list(final["int_coefs"])
            params_layers = list(final["params"])

        if p.enable_learning:
            from ..constants import (TRAINING_LEARNING_RATE,
                                     TRAINING_LOSS_EPSILON,
                                     TRAINING_MAX_NUM_ITERATIONS)

            for li, layer in enumerate(self.network.layers):
                layer.num_units = units_row[li]
                layer.params[: layer.num_params] = params_layers[li]
            scale = 2.0 ** (-(p.bits_per_sample - 1))
            self.buffer_double[:num_analyze] = (
                buf[ch, :num_analyze].astype(np.float64) * scale)
            self.trainer.train(
                self.network, self.buffer_double, num_analyze,
                TRAINING_MAX_NUM_ITERATIONS, TRAINING_LEARNING_RATE,
                TRAINING_LOSS_EPSILON)
            units_row = [layer.num_units for layer in self.network.layers]
            rshift_row, coef_row = self._quantize_layers()
        return units_row, rshift_row, coef_row

    def encode_block(self, channels: Sequence[np.ndarray], n: int) -> bytes:
        self._block_index += 1
        return super().encode_block(channels, n)

    def encode_whole(self, channels: Sequence[np.ndarray],
                     num_samples: int, progress_cb=None) -> bytes:
        if self.parameter is None:
            raise RuntimeError("set_encode_parameter not called")
        if self._cache_preinstalled:  # one-shot, set by encode_many
            self._cache_preinstalled = False
        else:
            self._fit_cache = {}
            self._plane_cache = {}
            self._block_index = -1
            self._prefit_blocks(channels, num_samples)
        return super().encode_whole(channels, num_samples, progress_cb)

    def encode_many(self, tracks: Sequence[Sequence[np.ndarray]],
                    num_samples: Sequence[int]) -> List[bytes]:
        """Encode a corpus byte-exactly with the full blocks of ALL tracks
        pooled into shared device fit batches. Each track is framed by a
        FRESH encoder (reference semantics: one encoder state per file)."""
        if self.parameter is None:
            raise RuntimeError("set_encode_parameter not called")
        p = self.parameter
        bs = p.num_samples_per_block
        nch = p.num_channels
        outs: List[bytes] = []
        if not _dev.supported(self.preset.layer_num_params, bs):
            for chans, ns in zip(tracks, num_samples):
                enc = DeviceExactEncoder(self.config, devices=self._devices)
                enc.set_encode_parameter(p)
                outs.append(enc.encode_whole(chans, ns))
            return outs

        fit, unpack = _dev.build_packed_fit_fn(
            self.preset.layer_num_params, self.preset.ridge_terms, bs,
            p.bits_per_sample, LPC_COEF_BITWIDTH)

        # locate every full block across the corpus (cheap, no transforms)
        placements = []  # (track_idx, block_idx, sample_pos)
        for ti, (chans, ns) in enumerate(zip(tracks, num_samples)):
            pos = 0
            bi = 0
            while pos < ns:
                n = min(bs, ns - pos)
                if n == bs:
                    placements.append((ti, bi, pos))
                bi += 1
                pos += n

        row_of_block: List[List[Tuple[int, int]]] = [[] for _ in tracks]
        for k, (ti, bi, _pos) in enumerate(placements):
            row_of_block[ti].append((bi, k * nch))

        get_row = None
        plane_store: Dict[Tuple[int, int], tuple] = {}
        # chunk-sized groups of whole blocks; each group's MS+preemph planes
        # and side stages are kept for the per-track payload encodes (the
        # transform runs ONCE)
        blocks_per_chunk = max(1, _CHUNK // nch)
        groups = [placements[gs : gs + blocks_per_chunk]
                  for gs in range(0, len(placements), blocks_per_chunk)]

        def gather(group) -> np.ndarray:
            chunk_rows = np.empty((len(group) * nch, bs), np.int32)
            for gi, (ti, bi, pos) in enumerate(group):
                plane, stages = preemph_plane_side(
                    p, [c[pos : pos + bs] for c in tracks[ti]], bs)
                plane_store[(ti, bi)] = (plane, stages)
                chunk_rows[gi * nch : (gi + 1) * nch] = plane
            return chunk_rows

        if placements and p.num_afmethod_iterations > 0:
            # the final refit pass is a device<->host ping-pong per layer,
            # so the sweep is fetched up front (no overlap)
            row_pieces = [gather(group) for group in groups]
            pending = [pend for rows_g in row_pieces for pend in
                       self._dispatch_fit_chunks(rows_g, fit, bs)]
            rows = np.concatenate(row_pieces, axis=0)
            fetched = _fetch_valid_rows(pending, unpack)
            finals = self._final_pass_rows(rows, fetched)

            def get_row(r: int, _f=fetched, _fin=finals):
                d = _row_view(_f, r)
                d["final"] = _fin[r]
                return self._apply_guard(d)
        elif placements:
            _fetch_row = self._overlapped_fit(groups, gather, fit, bs,
                                              unpack)

            def get_row(r: int, _fr=_fetch_row):
                return self._apply_guard(_fr(r))

        for ti, (chans, ns) in enumerate(zip(tracks, num_samples)):
            enc = DeviceExactEncoder(self.config, devices=self._devices)
            enc.set_encode_parameter(p)
            if get_row is not None:
                enc._fit_cache = {
                    bi: _merge_rows([get_row(r + c) for c in range(nch)])
                    for bi, r in row_of_block[ti]}
                enc._plane_cache = {
                    bi: plane_store.pop((ti, bi))
                    for bi, _r in row_of_block[ti]}
                enc._cache_preinstalled = True
            enc._block_index = -1
            outs.append(enc.encode_whole(chans, ns))
            # rows are counted here by get_row; decisions by each track's
            # encoder
            self.guard_decisions_flagged += enc.guard_decisions_flagged
        return outs


    def _overlapped_fit(self, groups, gather, fit, bs: int, unpack):
        """Gather, fit and fetch the chunk groups on a worker thread while
        the caller runs the serial host strands (block-type decisions,
        integer predict, entropy packing) for tracks whose fits already
        landed. The worker launches group i, then unpacks group i - 1,
        whose copies are done by then, so it never waits on the card; torch
        ops, event waits and the native host calls all release the GIL.
        Returns get_row(r) -> row dict, blocking only until row r's group
        is in."""
        nch = self.parameter.num_channels
        results: List[dict] = [None] * len(groups)
        done = [threading.Event() for _ in groups]
        err: List[BaseException] = []

        def finish(gi: int, pending: List[_Pending]) -> None:
            results[gi] = _fetch_valid_rows(pending, unpack)
            done[gi].set()

        def work():
            try:
                prev = None
                for gi, group in enumerate(groups):
                    pending = self._dispatch_fit_chunks(gather(group), fit,
                                                        bs)
                    if prev is not None:
                        finish(*prev)
                    prev = (gi, pending)
                finish(*prev)
            except BaseException as e:  # surfaced on the caller's next wait
                err.append(e)
                for ev in done:
                    ev.set()

        threading.Thread(target=work, daemon=True).start()
        bounds = np.cumsum([0] + [len(g) * nch for g in groups])

        def get_row(r: int) -> dict:
            gi = int(np.searchsorted(bounds, r, "right")) - 1
            done[gi].wait()
            if err:
                raise err[0]
            return _row_view(results[gi], r - int(bounds[gi]))

        return get_row


def _each(fn, *shard_args) -> list:
    """fn over the row shards, shard by shard, each with its device
    current."""
    out = []
    for args in zip(*shard_args):
        with on_device(args[0].device):
            out.append(fn(*args))
    return out


def _host(tensors) -> np.ndarray:
    """Row shards joined in order on the host."""
    return np.concatenate([t.cpu().numpy() for t in tensors])


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    """Start a non-blocking copy of a card tensor into pinned host memory
    on the current stream; the caller records an event after it."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _fetch_valid_rows(pending: List[_Pending], unpack) -> dict:
    """Wait for every dispatched chunk's two packed buffers and unpack them
    into one row-concatenated dict (padded tail rows dropped)."""
    parts = [pend.fetch() for pend in pending]
    if len(parts) == 1:
        return unpack(*parts[0])
    return unpack(np.concatenate([p[0] for p in parts], axis=0),
                  np.concatenate([p[1] for p in parts], axis=0))


def _row_view(out: dict, r: int) -> dict:
    """Slice one batch row out of a device fit result (arena included)."""
    return {
        "units": out["units"][r],
        "params": out["params"][r],
        "int_coefs": out["int_coefs"][r],
        "rshifts": out["rshifts"][r],
        "best_term": out["best_term"][r : r + 1],
        "arena_parcor": out["arena_parcor"][r : r + 1],
        "arena_zc": out["arena_zc"][r : r + 1],
        "arena_best": out["arena_best"][r : r + 1],
        "margins": out["margins"][r],
    }


def _merge_rows(rows: List[dict]) -> dict:
    """Bundle one block's per-channel rows for the payload hook. Entries may
    be None (guard-flagged rows) — those channels take the host oracle fit
    in `_fit_quantize_channel`."""
    return {
        "units": [None if r is None else r["units"] for r in rows],
        "params": [None if r is None else r["params"] for r in rows],
        "per_ch": rows,
    }
