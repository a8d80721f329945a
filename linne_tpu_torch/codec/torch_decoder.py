"""Batched decoder on torch tensors: corpus-scale reconstruction.
Counterpart of linne_tpu/codec/tpu_decoder.py:TpuDecoder.

The host (native library) does the serial entropy decode of every block.
The reconstruction IIR cascade — the decode hot loop — then runs as
batched `synthesize_rows` launches over ALL (stream, block, channel, unit)
segments at once, grouped per layer by (units, samples per unit, taps per
unit): each group is gathered from one int32 tensor R with index_select,
synthesized by the CUDA kernel, and scattered back with index_copy_.
De-emphasis and the MS inverse run in the native library (or numpy).

`decode_many` pools the rows of a whole corpus into the same launches, so
a launch carries more independent recurrences as the corpus grows. With a
device list (`devices=`, parallel/mesh.py) each block-length group's
blocks split into contiguous shards, one per entry, and each shard runs
the layer loop on its own device. For single-block latency use
codec.decoder.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import native
from .params import DecoderConfig
from ..constants import (
    BLOCK_TYPE_RAW,
    BLOCK_TYPE_SILENT,
    CH_PROCESS_MS,
    HEADER_SIZE,
)
from ..format.block import (
    BLOCK_HEADER_SIZE,
    parse_block_header,
    read_raw_payload,
)
from ..format.header import FormatError, LinneHeader, check_stream_capacity
from ..format.huffman import get_codebook
from ..presets import PRESETS

from ..ops.synthesis import synthesize_rows
from ..parallel.mesh import on_device, resolve_devices, shards


class TorchDecoder:
    def __init__(self, config: Optional[DecoderConfig] = None,
                 device=None, devices=None):
        """`device`: where the reconstruction runs (default "cuda"; "cpu"
        only when asked for). `devices`: a device list instead
        (parallel/mesh.py): each block-length group's rows are split over
        it, a contiguous shard of whole blocks per entry; rows are
        independent through every layer's synthesis, so the output equals
        the one-device decode's."""
        self.devices = resolve_devices(device, devices)
        self.config = config or DecoderConfig()
        self.header = None

    # -- host entropy stage --------------------------------------------------

    def _parse_stream(self, data: bytes):
        """Entropy-decode every block of one stream on the host. Returns
        (header, orders, blocks) with blocks = [(start, n, kind, payload)]."""
        header = LinneHeader.unpack(data)
        check_stream_capacity(header, len(data))
        preset = PRESETS[header.preset]
        cb = get_codebook(preset.coef_freq_table)
        orders = np.asarray(preset.layer_num_params, dtype=np.int32)
        nch = header.num_channels
        bps = header.bits_per_sample

        blocks = []  # (start_sample, n, kind, payload arrays)
        offset = HEADER_SIZE
        progress = 0
        while progress < header.num_samples and offset < len(data):
            bh = parse_block_header(
                data[offset:], check_crc=self.config.check_crc)
            payload = data[offset + BLOCK_HEADER_SIZE : offset + 6 + bh.block_size]
            n = bh.num_samples
            if bh.block_type == BLOCK_TYPE_SILENT:
                blocks.append((progress, n, "silent", None))
            elif bh.block_type == BLOCK_TYPE_RAW:
                channels, _ = read_raw_payload(payload, nch, n, bps)
                blocks.append((progress, n, "raw", np.stack(channels)))
            else:
                if native.available():
                    try:
                        unpacked = native.unpack_compress_payload(
                            payload, cb.node0_array, cb.node1_array, cb.root,
                            cb.num_symbols, nch, n, bps, orders)
                    except native.StreamDecodeError as e:
                        raise FormatError(str(e)) from e
                else:
                    unpacked = self._unpack_payload_py(
                        payload, nch, n, bps, preset.layer_num_params, cb)
                blocks.append((progress, n, "compress", unpacked))
            offset += bh.total_size
            progress += n
        if progress < header.num_samples:
            # a cleanly-truncated body must not decode to a silently
            # zero-filled tail (same contract as the native stream scan)
            raise FormatError(
                f"stream body ends after {progress} of "
                f"{header.num_samples} samples")
        return header, orders, blocks

    @staticmethod
    def _unpack_payload_py(payload, nch, n, bps, layer_num_params, cb):
        """Pure-python compress-payload unpack in the same tuple layout as
        native.unpack_compress_payload (no-compiler fallback)."""
        from ..format.block import read_compress_payload

        side, residual_list, consumed = read_compress_payload(
            payload, nch, n, bps, layer_num_params, cb)
        residuals = np.stack(residual_list)
        coefs = np.stack([
            np.concatenate(side.coefs[ch]).astype(np.int32)
            for ch in range(nch)])
        log2u = np.asarray(
            [[(u - 1).bit_length() for u in side.num_units[ch]]
             for ch in range(nch)], np.int32)
        rshifts = np.asarray(side.rshifts, np.int32)
        pprev = np.asarray(
            [[pc[0] for pc in side.preemph[ch]] for ch in range(nch)],
            np.int32)
        pcoef = np.asarray(
            [[pc[1] for pc in side.preemph[ch]] for ch in range(nch)],
            np.int32)
        return (residuals, coefs, log2u, rshifts, pprev, pcoef, consumed)

    # -- device synthesis stage ----------------------------------------------

    def _synthesize_pooled(self, streams) -> dict:
        """Pooled synthesis materialized per block: {(si, block_idx):
        planes [nch, n]} of reconstructed (pre-de-emphasis) planes, for the
        no-native assemble path."""
        planes = {}
        nch = streams[0][1].num_channels if streams else 0
        for n, host_R, members in self._synthesize_pooled_rows(streams):
            for pos, (si, i) in enumerate(members):
                planes[(si, i)] = np.ascontiguousarray(
                    host_R[pos * nch : (pos + 1) * nch, :n])
        return planes

    def _synthesize_pooled_rows(self, streams) -> list:
        """Run the reversed layer cascade for every compress block of every
        stream in `streams` = [(si, header, orders, blocks)], with all rows
        pooled into shared launches. All streams must share the same preset
        (orders) and channel count. Returns one entry per block length:
        (n, host_R [rows, n], members [(si, block_idx)]), where block
        (si, i) at position pos owns the nch consecutive rows starting at
        pos * nch."""
        if not streams:
            return []
        orders = streams[0][2]
        nch = streams[0][1].num_channels
        by_key = {}
        by_len = {}
        for si, _header, _orders, blocks in streams:
            for i, (_s, n, kind, b) in enumerate(blocks):
                if kind == "compress":
                    by_key[(si, i)] = b
                    by_len.setdefault(n, []).append((si, i))
        out_groups = []
        for n, members_n in by_len.items():
            # every shard is enqueued before any is read back
            shard_R = [self._synthesize_shard(d, members_n[a:b], by_key, n,
                                              orders, nch)
                       for d, a, b in shards(self.devices, len(members_n))]
            host = [R.cpu().numpy() for R in shard_R]
            out_groups.append((n, host[0] if len(host) == 1
                               else np.concatenate(host), members_n))
        return out_groups

    @staticmethod
    def _synthesize_shard(device, members, by_key, n, orders, nch
                          ) -> torch.Tensor:
        """The reversed layer cascade of one contiguous shard of a
        block-length group's compress blocks, on `device`. Returns R [rows,
        n] int32 there, where block `members[pos]` owns the nch rows from
        pos * nch."""
        stacked = np.concatenate([by_key[m][0] for m in members])
        with on_device(device):
            R = torch.from_numpy(stacked).to(device)  # [rows, n] int32
            for li in range(len(orders) - 1, -1, -1):
                base_off = int(orders[:li].sum())
                order = int(orders[li])
                groups = {}
                for pos, key in enumerate(members):
                    _r, coefs, log2u, rshifts, _pp, _pc, _c = by_key[key]
                    for ch in range(nch):
                        u = 1 << int(log2u[ch, li])
                        npu = order // u
                        ns = n // u
                        if ns <= npu:
                            continue
                        g = groups.setdefault((u, ns, npu), ([], [], []))
                        g[0].append(pos * nch + ch)
                        g[1].append(coefs[ch, base_off : base_off + order])
                        g[2].append(rshifts[ch, li])
                for (u, ns, npu), (rows, crows, rsv) in groups.items():
                    m = len(rows)
                    idx = torch.tensor(rows, dtype=torch.int64, device=device)
                    c = torch.from_numpy(
                        np.stack(crows).reshape(m * u, npu)).to(device)
                    rs = torch.from_numpy(
                        np.repeat(np.asarray(rsv, np.int32), u)).to(device)
                    sel = R.index_select(0, idx)           # [m, n]
                    seg = sel[:, : u * ns].reshape(m * u, ns).contiguous()
                    sel[:, : u * ns] = synthesize_rows(seg, c, rs).reshape(
                        m, u * ns)
                    R.index_copy_(0, idx, sel)
        return R

    # -- host finishing stage ------------------------------------------------

    @staticmethod
    def _assemble_rows(header, blocks, groups, si) -> List[np.ndarray]:
        """Native finishing: one GIL-released linne_finish_rows call per
        (stream, block-length group) scatters the synthesized rows into the
        output planes and runs de-emphasis + MS inverse."""
        nch = header.num_channels
        out = np.zeros((nch, header.num_samples), dtype=np.int32)
        ms = header.ch_process_method == CH_PROCESS_MS
        for start, n, kind, b in blocks:
            if kind == "raw":
                out[:, start : start + n] = b
        for n, host_R, members in groups:
            mine = [(pos, i) for pos, (s, i) in enumerate(members)
                    if s == si]
            if not mine:
                continue
            row0 = np.asarray([pos * nch for pos, _ in mine], np.int32)
            starts = np.asarray([blocks[i][0] for _, i in mine], np.int64)
            pprev = np.ascontiguousarray(
                np.stack([blocks[i][3][4] for _, i in mine]), dtype=np.int32)
            pcoef = np.ascontiguousarray(
                np.stack([blocks[i][3][5] for _, i in mine]), dtype=np.int32)
            native.finish_rows(host_R, row0, starts, n, pprev, pcoef, out, ms)
        return [out[ch] for ch in range(nch)]

    @staticmethod
    def _assemble(header, blocks, planes, si) -> List[np.ndarray]:
        """No-native finishing: de-emphasis + MS inverse per block."""
        from ..exact.filters import multistage_deemphasis

        nch = header.num_channels
        out = [np.zeros(header.num_samples, dtype=np.int32)
               for _ in range(nch)]
        for idx, (start, n, kind, b) in enumerate(blocks):
            if kind == "silent":
                continue
            if kind == "raw":
                for ch in range(nch):
                    out[ch][start : start + n] = b[ch]
                continue
            _res, _coefs, _l2, _rs, pprev, pcoef, _c = b
            plane = planes[(si, idx)]
            for ch in range(nch):
                multistage_deemphasis(
                    plane[ch], n,
                    ((int(pprev[ch, 0]), int(pcoef[ch, 0])),
                     (int(pprev[ch, 1]), int(pcoef[ch, 1]))))
            if header.ch_process_method == CH_PROCESS_MS:
                m = plane[0]
                s = plane[1]
                m -= s >> 1
                s += m
            for ch in range(nch):
                out[ch][start : start + n] = plane[ch]
        return out

    # -- public API ----------------------------------------------------------

    def decode_many(self, datas: Sequence[bytes]) -> List[List[np.ndarray]]:
        """Decode a corpus of .lnn streams with the reconstruction rows of
        ALL streams pooled into shared launches (grouped by preset and
        channel count). Returns one channel list per stream."""
        if len(datas) > 1:
            # streams parse independently; the native payload unpack runs
            # without the GIL
            with ThreadPoolExecutor(
                    max_workers=min(len(datas), os.cpu_count() or 1)) as ex:
                parsed = list(ex.map(self._parse_stream, datas))
        else:
            parsed = [self._parse_stream(d) for d in datas]
        classes = {}
        for si, (header, _orders, _blocks) in enumerate(parsed):
            key = (header.preset, header.num_channels)
            classes.setdefault(key, []).append(si)
        results: List[Optional[List[np.ndarray]]] = [None] * len(datas)
        for sis in classes.values():
            streams = [(si,) + parsed[si] for si in sis]
            if native.available():
                groups = self._synthesize_pooled_rows(streams)
                for si in sis:
                    header, _orders, blocks = parsed[si]
                    results[si] = self._assemble_rows(
                        header, blocks, groups, si)
            else:
                planes = self._synthesize_pooled(streams)
                for si in sis:
                    header, _orders, blocks = parsed[si]
                    results[si] = self._assemble(header, blocks, planes, si)
        self.header = parsed[-1][0] if parsed else None
        return results

    def decode_whole(self, data: bytes) -> List[np.ndarray]:
        return self.decode_many([data])[0]
