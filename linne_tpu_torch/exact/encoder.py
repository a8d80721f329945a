"""Bit-exact host encoder — the oracle path.

Produces `.lnn` files byte-identical to the reference C encoder
(reference: libs/linne_encoder/src/linne_encoder.c) by running the exact
analysis math of `exact` in the same order the C encoder does:
block-type decision, MS transform, two pre-emphasis stages, per-channel
network fitting (ridge sweep + unit search + optional training), joint
error-feedback quantization per layer, integer predict cascade, then payload
serialization.

The batched path (`codec.encoder.TorchEncoder`) shares the format layer
and integer semantics but batches the analysis on the device; this module
is the correctness reference for it and encodes its partial tail blocks.
The port's own copy of linne_tpu/exact/encoder.py.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

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
from .. import native as _native
from ..codec.params import EncodeParameter, EncoderConfig, compress_viable
from ..format.block import (
    CompressBlockSideInfo,
    frame_block,
    write_compress_payload,
    write_raw_payload,
)
from ..format.header import LinneHeader
from ..format.huffman import get_codebook
from ..presets import PRESETS
from .filters import ms_conversion, preemphasis, preemphasis_calculate_coefficient
from .intlpc import predict
from .lpc import quantize_coefficients
from .network import NetworkState, TrainerState

_RAW_THRESHOLD = float(np.float32(0.95))


def _roundup(val: int, n: int) -> int:
    return ((val + n - 1) // n) * n


class ExactEncoder:
    def __init__(self, config: EncoderConfig | None = None):
        self.config = config or EncoderConfig()
        self.config.validate()
        cfg = self.config
        self.network = NetworkState(
            cfg.max_num_samples_per_block, cfg.max_num_layers,
            cfg.max_num_parameters_per_layer)
        self.trainer = TrainerState(
            cfg.max_num_layers, cfg.max_num_parameters_per_layer)
        self.buffer_int = np.zeros(
            (cfg.max_num_channels, cfg.max_num_samples_per_block),
            dtype=np.int32)
        self.buffer_double = np.zeros(
            cfg.max_num_samples_per_block, dtype=np.float64)
        self.parameter: EncodeParameter | None = None
        self.preset = None
        self.codebook = None

    def set_encode_parameter(self, parameter: EncodeParameter) -> None:
        parameter.validate_against(self.config)
        self.parameter = parameter
        self.preset = PRESETS[parameter.preset]
        self.network.set_layer_structure(
            parameter.num_samples_per_block, self.preset.layer_num_params)
        self.codebook = get_codebook(self.preset.coef_freq_table)

    # -- block-type decision ----------------------------------------------

    def _decide_block_type(self, channels: Sequence[np.ndarray], n: int) -> int:
        p = self.parameter
        if not compress_viable(self.preset, p.num_samples_per_block, n):
            # blocks shorter than the largest layer order have no admissible
            # unit split; the reference C encoder segfaults here — emit the
            # (decodable-everywhere) raw/silent forms instead
            for ch in range(p.num_channels):
                if np.any(channels[ch][:n]):
                    return BLOCK_TYPE_RAW
            return BLOCK_TYPE_SILENT
        if self._estimate_mean_ratio(channels, n) >= _RAW_THRESHOLD:
            return BLOCK_TYPE_RAW
        for ch in range(p.num_channels):
            if np.any(channels[ch][:n]):
                return BLOCK_TYPE_COMPRESS
        return BLOCK_TYPE_SILENT

    def _estimate_mean_ratio(self, channels: Sequence[np.ndarray],
                             n: int) -> float:
        """Estimated mean code length as a fraction of bits_per_sample —
        the value the RAW-vs-COMPRESS threshold compares
        (linne_encoder.c:497-516). Overridable: the device-exact encoder
        wraps it with the hardware byte-identity guard's decision-margin
        check (the estimate reads one stale arena double)."""
        p = self.parameter
        scale = 2.0 ** (-(p.bits_per_sample - 1))
        mean_length = 0.0
        for ch in range(p.num_channels):
            self.buffer_double[:n] = channels[ch][:n].astype(np.float64) * scale
            mean_length += self.network.estimate_code_length(
                self.buffer_double, n, p.bits_per_sample)
        mean_length /= p.num_channels
        mean_length /= p.bits_per_sample
        return mean_length

    # -- compress payload --------------------------------------------------

    def _ms_preemph_stages(self, channels: Sequence[np.ndarray],
                           n: int) -> List[list]:
        """Fill `buffer_int` with this block's MS + pre-emphasized plane and
        return the per-channel [(prev, coef), ...] side-info stages
        (linne_encoder.c:624-641). Overridable hook: the device-exact
        encoder substitutes the plane its prefit already computed."""
        p = self.parameter
        buf = self.buffer_int
        for ch in range(p.num_channels):
            buf[ch, :n] = channels[ch][:n]
            buf[ch, n:] = 0
        if p.ch_process_method == CH_PROCESS_MS:
            ms_conversion(buf[0, :n], buf[1, :n])
        stages_all = []
        for ch in range(p.num_channels):
            stages = []
            for _stage in range(NUM_PREEMPH_FILTERS):
                prev = int(buf[ch, 0])
                coef = preemphasis_calculate_coefficient(buf[ch], n)
                preemphasis(buf[ch], n, prev, coef)
                stages.append((prev, coef))
            stages_all.append(stages)
        return stages_all

    def _fit_quantize_channel(self, buf: np.ndarray, ch: int, n: int,
                              num_analyze: int
                              ) -> Tuple[List[int], List[int],
                                         List[np.ndarray]]:
        """Fit (+ optional training) and 8-bit-quantize one channel of a
        compress block (linne_encoder.c:657-684). Overridable hook: the
        device-exact and thread-parallel encoders substitute prefit results
        here (replaying the fit's arena writes) without touching the rest
        of the serialization path."""
        p = self.parameter
        scale = 2.0 ** (-(p.bits_per_sample - 1))
        self.buffer_double[:num_analyze] = (
            buf[ch, :num_analyze].astype(np.float64) * scale)
        self.network.set_units_and_parameters(
            self.buffer_double, num_analyze,
            p.num_afmethod_iterations, self.preset.ridge_terms)
        if p.enable_learning:
            self.trainer.train(
                self.network, self.buffer_double, num_analyze,
                TRAINING_MAX_NUM_ITERATIONS, TRAINING_LEARNING_RATE,
                TRAINING_LOSS_EPSILON)
        units_row = [layer.num_units for layer in self.network.layers]
        rshift_row, coef_row = self._quantize_layers()
        return units_row, rshift_row, coef_row

    def _quantize_layers(self) -> Tuple[List[int], List[np.ndarray]]:
        rshift_row: List[int] = []
        coef_row: List[np.ndarray] = []
        for layer in self.network.layers:
            int_coef, rshift = quantize_coefficients(
                layer.params, layer.num_params, LPC_COEF_BITWIDTH)
            rshift_row.append(rshift)
            coef_row.append(int_coef)
        return rshift_row, coef_row

    def _encode_compress_payload(self, channels: Sequence[np.ndarray],
                                 n: int) -> bytes:
        p = self.parameter
        preset = self.preset
        nch = p.num_channels
        buf = self.buffer_int

        side = CompressBlockSideInfo()
        side.preemph = self._ms_preemph_stages(channels, n)

        # analysis length: round up to the unit-field grid, clip to
        # [max layer order, block size] (linne_encoder.c:643-655)
        max_params = preset.max_num_params
        num_analyze = _roundup(n, 1 << LOG2_NUM_UNITS_BITWIDTH)
        num_analyze = min(p.num_samples_per_block, max(max_params, num_analyze))

        all_units: List[List[int]] = []
        all_rshifts: List[List[int]] = []
        all_coefs: List[List[np.ndarray]] = []
        for ch in range(nch):
            units_row, rshift_row, coef_row = self._fit_quantize_channel(
                buf, ch, n, num_analyze)
            all_units.append(units_row)
            all_rshifts.append(rshift_row)
            all_coefs.append(coef_row)
        side.num_units = all_units
        side.rshifts = all_rshifts
        side.coefs = all_coefs

        residuals = []
        use_native = _native.available()
        predict_fn = _native.predict_layer if use_native else predict
        for ch in range(nch):
            signal = buf[ch, :n].copy()
            for l, layer_np in enumerate(preset.layer_num_params):
                signal = predict_fn(
                    signal, n, all_coefs[ch][l], all_units[ch][l],
                    all_rshifts[ch][l])
            residuals.append(signal)

        if use_native:
            # native emission: exact Rice search (bit-identical to
            # format.rice.choose_partition) + the same native bit packer the
            # production drain uses. Byte-equality with the python
            # write_compress_payload is pinned by the golden suites and
            # tests/test_exact_native_helpers.py.
            from ..format.rice import _max_porder

            orders = np.asarray(preset.layer_num_params, dtype=np.int32)
            res = np.stack(residuals).astype(np.int32)
            porders = np.empty(nch, dtype=np.int32)
            k2s = np.zeros((nch, 1 << _max_porder(n)), dtype=np.int32)
            for ch in range(nch):
                po, k2 = _native.exact_rice_search(res[ch])
                porders[ch] = po
                k2s[ch, : k2.shape[0]] = k2
            coefs_flat = np.stack([
                np.concatenate(all_coefs[ch]).astype(np.int32)
                for ch in range(nch)])
            log2u = np.asarray(
                [[(u - 1).bit_length() for u in row] for row in all_units],
                dtype=np.int32)
            rsh = np.asarray(all_rshifts, dtype=np.int32)
            pprev = np.asarray(
                [[pc[0] for pc in side.preemph[ch]] for ch in range(nch)],
                dtype=np.int32)
            pcoef = np.asarray(
                [[pc[1] for pc in side.preemph[ch]] for ch in range(nch)],
                dtype=np.int32)
            return _native.pack_compress_payload(
                res, coefs_flat, log2u, rsh, pprev, pcoef, porders, k2s,
                self.codebook.codes_array, self.codebook.lens_array,
                p.bits_per_sample, orders)

        return write_compress_payload(
            side, residuals, p.bits_per_sample, self.codebook)

    # -- public API --------------------------------------------------------

    def encode_block(self, channels: Sequence[np.ndarray], n: int) -> bytes:
        if self.parameter is None:
            raise RuntimeError("set_encode_parameter not called")
        p = self.parameter
        if n > p.num_samples_per_block:
            raise ValueError("too many samples for one block")
        block_type = self._decide_block_type(channels, n)
        if block_type == BLOCK_TYPE_RAW:
            payload = write_raw_payload(
                [c[:n] for c in channels[: p.num_channels]], p.bits_per_sample)
        elif block_type == BLOCK_TYPE_SILENT:
            payload = b""
        else:
            payload = self._encode_compress_payload(channels, n)
        return frame_block(block_type, n, payload)

    def encode_whole(self, channels: Sequence[np.ndarray],
                     num_samples: int, progress_cb=None) -> bytes:
        if self.parameter is None:
            raise RuntimeError("set_encode_parameter not called")
        p = self.parameter
        header = LinneHeader(
            num_channels=p.num_channels,
            num_samples=num_samples,
            sampling_rate=p.sampling_rate,
            bits_per_sample=p.bits_per_sample,
            num_samples_per_block=p.num_samples_per_block,
            preset=p.preset,
            ch_process_method=p.ch_process_method,
        )
        out = bytearray(header.pack())
        progress = 0
        while progress < num_samples:
            n = min(p.num_samples_per_block, num_samples - progress)
            block = self.encode_block(
                [c[progress : progress + n] for c in channels], n)
            out += block
            progress += n
            if progress_cb is not None:
                progress_cb(progress, num_samples)
        return bytes(out)
