"""Public encoder/decoder configuration types.

Mirrors the reference's config/parameter structs
(reference: include/linne_encoder.h:8-25, include/linne_decoder.h:8-13).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..constants import CH_PROCESS_MS, CH_PROCESS_NONE, MAX_NUM_CHANNELS
from ..presets import PRESETS


@dataclass
class EncoderConfig:
    """Capacity bounds fixed at encoder creation."""

    max_num_channels: int = MAX_NUM_CHANNELS
    max_num_samples_per_block: int = 16 * 1024
    max_num_layers: int = 5
    max_num_parameters_per_layer: int = 128

    def validate(self) -> None:
        if self.max_num_channels <= 0:
            raise ValueError("max_num_channels must be positive")
        if self.max_num_samples_per_block <= 0:
            raise ValueError("max_num_samples_per_block must be positive")
        if self.max_num_layers <= 0:
            raise ValueError("max_num_layers must be positive")
        if self.max_num_parameters_per_layer <= 0:
            raise ValueError("max_num_parameters_per_layer must be positive")
        if self.max_num_parameters_per_layer > self.max_num_samples_per_block:
            raise ValueError("block must be larger than the layer order")


@dataclass
class EncodeParameter:
    num_channels: int
    bits_per_sample: int
    sampling_rate: int
    num_samples_per_block: int = 5 * 2048
    preset: int = 0
    ch_process_method: int = CH_PROCESS_NONE
    enable_learning: bool = False
    num_afmethod_iterations: int = 0

    def validate_against(self, config: EncoderConfig) -> None:
        if not (0 < self.num_channels <= config.max_num_channels):
            raise ValueError("num_channels out of range")
        if self.bits_per_sample <= 0:
            raise ValueError("bits_per_sample must be positive")
        if self.sampling_rate <= 0:
            raise ValueError("sampling_rate must be positive")
        if not (0 < self.num_samples_per_block
                <= config.max_num_samples_per_block):
            raise ValueError("num_samples_per_block out of range")
        if not (0 <= self.preset < len(PRESETS)):
            raise ValueError("preset out of range")
        if self.ch_process_method not in (CH_PROCESS_NONE, CH_PROCESS_MS):
            raise ValueError("invalid ch_process_method")
        if self.ch_process_method == CH_PROCESS_MS and self.num_channels < 2:
            raise ValueError("MS processing requires >= 2 channels")
        preset = PRESETS[self.preset]
        if preset.num_layers > config.max_num_layers:
            raise ValueError("preset exceeds max_num_layers")
        for p in preset.layer_num_params:
            if p > config.max_num_parameters_per_layer:
                raise ValueError("preset exceeds max_num_parameters_per_layer")
            if self.num_samples_per_block <= p:
                raise ValueError("block must be larger than every layer order")


def analysis_length(preset, num_samples_per_block: int, n: int) -> int:
    """Samples the analysis runs on for an n-sample block: n rounded up to a
    unit multiple, at least the largest layer order, capped at the block
    size (reference: linne_encoder.c:643-655)."""
    rounded = ((n + 7) // 8) * 8  # 1 << LOG2_NUM_UNITS_BITWIDTH
    return min(num_samples_per_block, max(preset.max_num_params, rounded))


def compress_viable(preset, num_samples_per_block: int, n: int) -> bool:
    """Whether an n-sample block can carry a compress payload: every layer
    needs at least one admissible unit split (samples-per-unit strictly
    greater than params-per-unit, linne_network.c:284-295). Blocks shorter
    than the largest layer order have none — the reference C encoder
    SEGFAULTS on such tails (e.g. a 37-sample tail at -m 7); this framework
    falls back to a RAW/SILENT block instead."""
    num_analyze = analysis_length(preset, num_samples_per_block, n)
    for order in preset.layer_num_params:
        u = 1
        ok = False
        while u <= min(128, order):
            if (order % u == 0 and num_analyze % u == 0
                    and (num_analyze // u) > (order // u)):
                ok = True
                break
            u <<= 1
        if not ok:
            return False
    return True


@dataclass
class DecoderConfig:
    max_num_channels: int = MAX_NUM_CHANNELS
    max_num_layers: int = 5
    max_num_parameters_per_layer: int = 128
    check_crc: bool = True
    # threads for whole-stream decode (blocks are independent);
    # 0 = all hardware threads, 1 = serial
    num_threads: int = 0
