"""Byte-exact `.lnn` encoding with the per-block fitting (and optional `-l`
training) parallelized across host threads. Counterpart of
linne_tpu/exact/parallel_encoder.py; host threads only.

`ParallelExactEncoder` produces bitstreams byte-identical to the reference C
encoder (same contract as `ExactEncoder`) while running the expensive
per-(block, channel) work — the ridge/unit network fit
(linne_network.c:582-630) and, unlike `DeviceExactEncoder`, the 2000-iteration
momentum trainer (linne_network.c:805-873) — concurrently in a thread pool.
The native exact helpers are plain ctypes calls, so every fit/train releases
the GIL and the pool scales with host cores (the reference encoder is
single-threaded by design; this is the multicore analog of the device path's
batched fits).

Why threading preserves byte-identity:

- fits never *read* the shared `LPCCalculator` arena before writing it when
  every unit sub-length is even (always true for full blocks — the same
  `exact_device.supported` envelope the device-exact path uses), so each
  (block, channel) fit in a PRIVATE `NetworkState` computes exactly the
  serial fit's outputs;
- training reads only the layer parameters and the block signal — never the
  arena — and is per-(block, channel) independent (linne_network.c:805-873);
- the one cross-fit arena read, `parcor_coef[order0]` inside the next
  block-type decision (lpc.c:846-848), is rewritten by EVERY fit: each
  layer's u=1 unit level deposits `parcor[0:order]`, and every preset
  structure has a layer with order > order0 (asserted below). Replaying each
  private fit's `parcor_coef[0:max_order]` into the shared arena in encode
  order therefore reproduces the serial arena for every future read;
- blocks later decided RAW/SILENT simply discard their prefit entry — the
  serial encoder never ran those fits, so nothing is replayed (their arena
  writes never happened there either);
- `-a N` AF refits change nothing above: the oracle computes the IRLS
  normal equations and Cholesky solve in FRESH arrays (exact/lpc.py
  `_af_matrix_and_vector`/`_cholesky_solve`) yet is byte-identical to the
  reference C binary across the `-a` cells of the golden matrix — which
  pins that no stale AF scratch in the C arena (lpc.c:452-509) ever feeds
  emitted bits; the native helpers keep scratch in locals and touch only
  the caller's (here: thread-private) arena arrays.

`-l` IS supported — it is the regime where threads matter most. Tail blocks
and unsupported shapes fall back to the serial in-place path per block,
preserving arena order exactly like the device-exact encoder.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Sequence

import numpy as np

from ..constants import (
    TRAINING_LEARNING_RATE,
    TRAINING_LOSS_EPSILON,
    TRAINING_MAX_NUM_ITERATIONS,
)
from ..codec.params import EncoderConfig
from ..ops import exact_device as _dev
from .device_encoder import preemph_plane
from .encoder import ExactEncoder
from .network import NetworkState, TrainerState


class ParallelExactEncoder(ExactEncoder):
    """ExactEncoder with per-(block, channel) fit+train on a thread pool."""

    def __init__(self, config: EncoderConfig | None = None,
                 num_threads: int | None = None):
        super().__init__(config)
        self.num_threads = num_threads or (os.cpu_count() or 1)
        self._fit_cache: Dict[int, list] = {}
        self._cache_preinstalled = False  # set (one-shot) by encode_many
        self._block_index = -1
        self._tls = threading.local()

    # -- threaded prefit -----------------------------------------------------

    def _thread_safe(self) -> bool:
        orders = self.preset.layer_num_params
        bs = self.parameter.num_samples_per_block
        # the arena-coverage condition from the module docstring: some layer
        # must rewrite parcor[order0] in every fit (true for all 8 presets)
        return (_dev.supported(orders, bs)
                and max(orders) > orders[0])

    def _tls_state(self):
        st = getattr(self._tls, "state", None)
        if st is None:
            cfg = self.config
            net = NetworkState(
                cfg.max_num_samples_per_block, cfg.max_num_layers,
                cfg.max_num_parameters_per_layer)
            net.set_layer_structure(
                self.parameter.num_samples_per_block,
                self.preset.layer_num_params)
            trainer = TrainerState(
                cfg.max_num_layers, cfg.max_num_parameters_per_layer)
            st = (net, trainer)
            self._tls.state = st
        return st

    def _fit_job(self, plane_ch: np.ndarray, num_analyze: int) -> tuple:
        """One (block, channel) fit (+ optional training) in a private
        NetworkState. Returns (units, params, parcor[0:max_order])."""
        p = self.parameter
        net, trainer = self._tls_state()
        data = plane_ch.astype(np.float64) * 2.0 ** (-(p.bits_per_sample - 1))
        net.set_units_and_parameters(
            data, num_analyze, p.num_afmethod_iterations,
            self.preset.ridge_terms)
        if p.enable_learning:
            trainer.train(net, data, num_analyze,
                          TRAINING_MAX_NUM_ITERATIONS,
                          TRAINING_LEARNING_RATE, TRAINING_LOSS_EPSILON)
        units = [L.num_units for L in net.layers]
        params = [L.params[: L.num_params].copy() for L in net.layers]
        parcor = net.lpcc.parcor_coef[: max(self.preset.layer_num_params)].copy()
        return units, params, parcor

    def _prefit_planes(self, plane_jobs: list) -> list:
        """Run [(plane [nch, bs])] through the pool; returns per-plane lists
        of per-channel job results."""
        from concurrent.futures import ThreadPoolExecutor

        bs = self.parameter.num_samples_per_block
        nch = self.parameter.num_channels
        flat = [(pi, ch) for pi in range(len(plane_jobs))
                for ch in range(nch)]
        with ThreadPoolExecutor(max_workers=self.num_threads) as ex:
            results = list(ex.map(
                lambda job: self._fit_job(plane_jobs[job[0]][job[1]], bs),
                flat))
        per_plane = [[None] * nch for _ in plane_jobs]
        for (pi, ch), r in zip(flat, results):
            per_plane[pi][ch] = r
        return per_plane

    def _full_block_layout(self, num_samples: int) -> list:
        bs = self.parameter.num_samples_per_block
        full = []
        pos = 0
        idx = 0
        while pos < num_samples:
            n = min(bs, num_samples - pos)
            if n == bs:
                full.append((idx, pos))
            idx += 1
            pos += n
        return full

    def _prefit_blocks(self, channels: Sequence[np.ndarray],
                       num_samples: int) -> None:
        if not self._thread_safe():
            return
        bs = self.parameter.num_samples_per_block
        full = self._full_block_layout(num_samples)
        if not full:
            return
        planes = [preemph_plane(self.parameter,
                                [c[pos : pos + bs] for c in channels], bs)
                  for _bi, pos in full]
        per_plane = self._prefit_planes(planes)
        for (bi, _pos), rows in zip(full, per_plane):
            self._fit_cache[bi] = rows

    # -- per-block hook -------------------------------------------------------

    def _fit_quantize_channel(self, buf, ch, n, num_analyze):
        cached = self._fit_cache.get(self._block_index)
        if cached is None:
            return super()._fit_quantize_channel(buf, ch, n, num_analyze)

        # Install the pooled job's post-train fit, replay its arena writes
        # (module docstring: every fit rewrites parcor[0:max_order] in full,
        # so the copy IS the serial post-fit state for every future read),
        # then quantize on the shared path. The serial fit and trainer are
        # bypassed — the cached params already include both.
        units, params, parcor = cached[ch]
        for li, layer in enumerate(self.network.layers):
            layer.num_units = units[li]
            layer.params[: layer.num_params] = params[li]
        max_order = max(self.preset.layer_num_params)
        self.network.lpcc.parcor_coef[:max_order] = parcor
        rshift_row, coef_row = self._quantize_layers()
        return list(units), rshift_row, coef_row

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
            self._block_index = -1
            self._prefit_blocks(channels, num_samples)
        return super().encode_whole(channels, num_samples, progress_cb)

    def encode_many(self, tracks: Sequence[Sequence[np.ndarray]],
                    num_samples: Sequence[int]) -> List[bytes]:
        """Encode a corpus with the full blocks of ALL tracks pooled into
        one thread-pool pass. Each track is framed by a FRESH encoder
        (reference semantics: one encoder state per file)."""
        if self.parameter is None:
            raise RuntimeError("set_encode_parameter not called")
        p = self.parameter
        outs: List[bytes] = []
        if not self._thread_safe():
            for chans, ns in zip(tracks, num_samples):
                enc = ParallelExactEncoder(self.config, self.num_threads)
                enc.set_encode_parameter(p)
                outs.append(enc.encode_whole(chans, ns))
            return outs

        bs = p.num_samples_per_block
        placements = []  # (track_idx, block_idx)
        planes = []
        for ti, (chans, ns) in enumerate(zip(tracks, num_samples)):
            for bi, pos in self._full_block_layout(ns):
                placements.append((ti, bi))
                planes.append(preemph_plane(
                    p, [c[pos : pos + bs] for c in chans], bs))
        per_plane = self._prefit_planes(planes) if planes else []

        caches: List[Dict[int, list]] = [dict() for _ in tracks]
        for (ti, bi), rows in zip(placements, per_plane):
            caches[ti][bi] = rows
        for ti, (chans, ns) in enumerate(zip(tracks, num_samples)):
            enc = ParallelExactEncoder(self.config, self.num_threads)
            enc.set_encode_parameter(p)
            enc._fit_cache = caches[ti]
            enc._cache_preinstalled = True
            enc._block_index = -1
            outs.append(enc.encode_whole(chans, ns))
        return outs
