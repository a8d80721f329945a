"""Batched decoder on torch tensors: corpus-scale reconstruction.
Counterpart of linne_tpu/codec/tpu_decoder.py:TpuDecoder.

The host does the serial entropy decode of every block with the native
host library (native.py), which the decoder requires: it is built with g++
at first use, and a missing one raises at construction. The
reconstruction IIR cascade — the decode hot loop — then runs as batched
`synthesize_rows` launches over ALL (stream, block, channel, unit)
segments at once, grouped per layer by (units, samples per unit, taps per
unit): each group is gathered from one int32 tensor R with index_select,
synthesized by the CUDA kernel, and scattered back with index_copy_.
De-emphasis and the MS inverse run in the native library.

`decode_many` pools the rows of a whole corpus into the same launches, so
a launch carries more independent recurrences as the corpus grows. With a
device list (`devices=`, parallel/mesh.py) each block-length group's
blocks split into contiguous shards, one per entry, and each shard runs
the layer loop on its own device. For single-block latency use
codec.decoder.

Transfers are slim both ways. Up: each shard's residual rows as int16,
the rare rows that do not fit patched in at int32 by one index_copy_. Down:
per row an overflow flag, then the reconstruction at W = bps + 2 bits
(_download_width, ops/bitpack.py), which holds every row of a valid
stream; a flagged row is fetched again at int32 from the shard that holds
it. Pools larger than 2 x _DL_CHUNK_ROWS rows come down in row chunks, each
its own non-blocking copy into pinned memory behind a CUDA event, so the
host unpacks chunk k while the later chunks land.

The host's phases open spans (utils/profiling.py: "decode",
"decode.parse", "decode.upload", "decode.layers", "decode.download" with
".wait" and ".refetch", "decode.assemble"), and `queue_waits` counts the
copies that wait for all the work queued on the device: the residual
upload and its int32 patch, each synthesis group's index, coefficient and
shift uploads, and the flagged refetch's upload and blocking read.
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
from ..format.header import (
    FormatError,
    LinneHeader,
    check_decoder_capacity,
    check_stream_capacity,
)
from ..format.huffman import get_codebook
from ..presets import PRESETS

from ..ops.bitpack import pack_geometry, pack_plane_words
from ..ops.synthesis import synthesize_rows
from ..parallel.mesh import on_device, resolve_devices, shards
from ..utils.profiling import span

# Rows per chunk of the streamed reconstruction download.
_DL_CHUNK_ROWS = 128


def _download_width(bps: int) -> int:
    """Reconstruction samples of a valid stream are bounded by bps+1 bits
    (before de-emphasis, MS side channel): the download packs at bps+2;
    any row a hostile stream pushes past that is flagged on the device and
    fetched again at full width."""
    return min(bps + 2, 30)


def _pack_download(R: torch.Tensor, W: int) -> torch.Tensor:
    """[rows, n] int32 -> [rows, 1 + words]: the row's overflow flag (a
    sample outside W bits) in column 0, then the W-bit plane."""
    lim = 1 << (W - 1)
    flags = torch.any((R >= lim) | (R < -lim), dim=-1)
    return torch.cat([flags.to(torch.int32)[:, None],
                      pack_plane_words(R, W)], dim=-1)


def _start_download(packed: torch.Tensor) -> list:
    """Start the copy of a packed [rows, K] tensor to the host: one chunk,
    or chunks of _DL_CHUNK_ROWS rows for more than 2 x _DL_CHUNK_ROWS, each
    a non-blocking copy into pinned memory with the event that tells when
    it has landed (None on the CPU). Returns [(first row, host, event)]."""
    rows = packed.shape[0]
    step = _DL_CHUNK_ROWS if rows > 2 * _DL_CHUNK_ROWS else max(rows, 1)
    chunks = []
    for start in range(0, rows, step):
        part = packed[start : start + step]
        if part.is_cuda:
            host = torch.empty(part.shape, dtype=torch.int32,
                               pin_memory=True)
            host.copy_(part, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(part.device))
        else:
            host, ready = part, None
        chunks.append((start, host, ready))
    return chunks


class TorchDecoder:
    def __init__(self, config: Optional[DecoderConfig] = None,
                 device=None, devices=None):
        """`device`: where the reconstruction runs (default "cuda"; "cpu"
        only when asked for). `devices`: a device list instead
        (parallel/mesh.py): each block-length group's rows are split over
        it, a contiguous shard of whole blocks per entry; rows are
        independent through every layer's synthesis, so the output equals
        the one-device decode's.

        Raises RuntimeError when the native host library cannot be built
        or loaded: it unpacks every compressed payload and the download,
        and assembles the output planes."""
        native.lib()
        self.devices = resolve_devices(device, devices)
        self.config = config or DecoderConfig()
        self.header = None
        # transfer counters over the decoder's life: bytes uploaded and
        # downloaded (packed planes, flags and refetched rows), download
        # chunks, rows flagged past the download width, and the copies
        # that wait for all the work queued on the device (uploads from
        # pageable memory, blocking reads)
        self.bytes_up = 0
        self.bytes_down = 0
        self.download_chunks = 0
        self.flagged_rows = 0
        self.queue_waits = 0

    # -- host entropy stage --------------------------------------------------

    def _parse_stream(self, data: bytes):
        """Entropy-decode every block of one stream on the host. Returns
        (header, orders, blocks) with blocks = [(start, n, kind, payload)]."""
        header = LinneHeader.unpack(data)
        check_decoder_capacity(header, self.config)
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
            n = bh.num_samples
            # the block scan of the native decoder (linne_decode_stream):
            # a frame shorter than its fixed fields, or a block that runs
            # past the header's num_samples, is malformed; finish_rows
            # would write such a block past the output planes
            if bh.block_size < 5:
                raise FormatError(f"block size {bh.block_size} is below 5")
            if progress + n > header.num_samples:
                raise FormatError(
                    f"block of {n} samples at {progress} runs past the "
                    f"header's {header.num_samples} samples")
            payload = data[offset + BLOCK_HEADER_SIZE : offset + 6 + bh.block_size]
            if bh.block_type == BLOCK_TYPE_SILENT:
                blocks.append((progress, n, "silent", None))
            elif bh.block_type == BLOCK_TYPE_RAW:
                channels, _ = read_raw_payload(payload, nch, n, bps)
                blocks.append((progress, n, "raw", np.stack(channels)))
            else:
                try:
                    unpacked = native.unpack_compress_payload(
                        payload, cb.node0_array, cb.node1_array, cb.root,
                        cb.num_symbols, nch, n, bps, orders)
                except native.StreamDecodeError as e:
                    raise FormatError(str(e)) from e
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

    # -- device synthesis stage ----------------------------------------------

    def _synthesize_pooled_rows(self, streams) -> list:
        """Run the reversed layer cascade for every compress block of every
        stream in `streams` = [(si, header, orders, blocks)], with all rows
        pooled into shared launches. All streams must share the same preset
        (orders), channel count and sample width. Returns one entry per
        block length: (n, host_R [rows, >=n], members [(si, block_idx)]),
        where block (si, i) at position pos owns the nch consecutive rows
        starting at pos * nch."""
        if not streams:
            return []
        orders = streams[0][2]
        nch = streams[0][1].num_channels
        W = _download_width(streams[0][1].bits_per_sample)
        g, _wpg = pack_geometry(W)
        by_key = {}
        by_len = {}
        for si, _header, _orders, blocks in streams:
            for i, (_s, n, kind, b) in enumerate(blocks):
                if kind == "compress":
                    by_key[(si, i)] = b
                    by_len.setdefault(n, []).append((si, i))
        out_groups = []
        for n, members_n in by_len.items():
            # every shard's cascade and download are enqueued before any
            # is read back
            spans = shards(self.devices, len(members_n))
            shard_R = [self._synthesize_shard(d, members_n[a:b], by_key, n,
                                              orders, nch)
                       for d, a, b in spans]
            with span("decode.download"):
                downs = []
                for R in shard_R:
                    with on_device(R.device):
                        downs.append(_start_download(_pack_download(R, W)))
                host_R = np.empty((len(members_n) * nch, -(-n // g) * g),
                                  np.int32)
                for (_d, a, b), R, chunks in zip(spans, shard_R, downs):
                    self._download(R, chunks, W, n, host_R[a * nch : b * nch])
            out_groups.append((n, host_R, members_n))
        return out_groups

    def _download(self, R, chunks, W, n, out) -> None:
        """Unpack one shard's downloaded chunks (see _start_download) into
        out [rows, >=n], each as soon as it has landed, while the later
        ones are still copying; rows flagged past W take their int32
        values from the shard's R."""
        flags = np.empty(out.shape[0], np.int32)
        for start, part, ready in chunks:
            if ready is not None:
                with span("decode.download.wait"):
                    ready.synchronize()
            words = part.numpy()
            stop = start + words.shape[0]
            flags[start:stop] = words[:, 0]
            self.bytes_down += words.nbytes
            native.unpack_bits(words[:, 1:], W, out.shape[1], out[start:stop])
        self.download_chunks += len(chunks)
        wide = np.nonzero(flags)[0]
        if wide.size:
            with span("decode.download.refetch"):
                idx = torch.from_numpy(wide).to(R.device)
                full = R.index_select(0, idx).cpu().numpy()
            # the pageable upload of idx and the blocking read
            self.queue_waits += 2
            out[wide, :n] = full
            self.flagged_rows += int(wide.size)
            self.bytes_down += full.nbytes

    def _synthesize_shard(self, device, members, by_key, n, orders, nch
                          ) -> torch.Tensor:
        """The reversed layer cascade of one contiguous shard of a
        block-length group's compress blocks, on `device`. The residual
        rows go up as int16, the rows that do not fit patched in at int32.
        Returns R [rows, n] int32 there, where block `members[pos]` owns
        the nch rows from pos * nch."""
        with span("decode.upload"):
            stacked = np.concatenate([by_key[m][0] for m in members])
            wide = np.nonzero((stacked.max(axis=1) > 32767)
                              | (stacked.min(axis=1) < -32768))[0]
            up16 = torch.from_numpy(stacked.astype(np.int16))
            self.bytes_up += up16.numel() * 2
            with on_device(device):
                R = up16.to(device).to(torch.int32)  # [rows, n]
                self.queue_waits += 1
                if wide.size:
                    full = torch.from_numpy(stacked[wide])
                    R.index_copy_(0, torch.from_numpy(wide).to(device),
                                  full.to(device))
                    self.queue_waits += 2
                    self.bytes_up += full.numel() * 4 + wide.size * 8
        with on_device(device), span("decode.layers"):
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
                        # a row with no taps (more units than the layer's
                        # order, which only a corrupt stream carries) or
                        # no sample past its taps stays as it is, and so
                        # does the tail past u * ns: the layer loop of
                        # native/linne_host.cpp (synth_layers_multi) runs
                        # npu = 0 through synth_unit_plain, which
                        # subtracts half >> rshift = 0 at every step
                        if npu == 0 or ns <= npu:
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
                    self.queue_waits += 3
                    sel = R.index_select(0, idx)           # [m, n]
                    seg = sel[:, : u * ns].reshape(m * u, ns).contiguous()
                    sel[:, : u * ns] = synthesize_rows(seg, c, rs).reshape(
                        m, u * ns)
                    R.index_copy_(0, idx, sel)
        return R

    # -- host finishing stage ------------------------------------------------

    @staticmethod
    def _assemble_rows(header, blocks, groups, si) -> List[np.ndarray]:
        """Finishing: one GIL-released linne_finish_rows call per
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

    # -- public API ----------------------------------------------------------

    def decode_many(self, datas: Sequence[bytes]) -> List[List[np.ndarray]]:
        """Decode a corpus of .lnn streams with the reconstruction rows of
        ALL streams pooled into shared launches (grouped by preset and
        channel count). Returns one channel list per stream."""
        with span("decode"):
            with span("decode.parse"):
                if len(datas) > 1:
                    # streams parse independently; the native payload
                    # unpack runs without the GIL
                    with ThreadPoolExecutor(max_workers=min(
                            len(datas), os.cpu_count() or 1)) as ex:
                        parsed = list(ex.map(self._parse_stream, datas))
                else:
                    parsed = [self._parse_stream(d) for d in datas]
            classes = {}
            for si, (header, _orders, _blocks) in enumerate(parsed):
                # the sample width sets the download width, so it is part
                # of the pooling key
                key = (header.preset, header.num_channels,
                       header.bits_per_sample)
                classes.setdefault(key, []).append(si)
            results: List[Optional[List[np.ndarray]]] = [None] * len(datas)
            for sis in classes.values():
                streams = [(si,) + parsed[si] for si in sis]
                groups = self._synthesize_pooled_rows(streams)
                with span("decode.assemble"):
                    for si in sis:
                        header, _orders, blocks = parsed[si]
                        results[si] = self._assemble_rows(
                            header, blocks, groups, si)
            self.header = parsed[-1][0] if parsed else None
            return results

    def decode_whole(self, data: bytes) -> List[np.ndarray]:
        return self.decode_many([data])[0]
