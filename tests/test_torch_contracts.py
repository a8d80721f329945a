"""API contracts of the port: the counterpart of tests/test_contracts.py
for linne_tpu_torch's copies of the parameter, header and host decoder
classes, and for TorchEncoder and TorchDecoder where they have the same
entry (parameter validation, encode before set_encode_parameter, header
strictness, the decoder config's capacity checks, bad sync codes)."""

import dataclasses

import numpy as np
import pytest

from linne_tpu.codec.decoder import Decoder as JaxDecoder
from linne_tpu.codec.params import DecoderConfig as JaxDecoderConfig
from linne_tpu.format.header import FormatError as JaxFormatError
from linne_tpu_torch.codec.decoder import Decoder
from linne_tpu_torch.codec.encoder import TorchEncoder
from linne_tpu_torch.codec.params import (
    DecoderConfig,
    EncodeParameter,
    EncoderConfig,
)
from linne_tpu_torch.codec.torch_decoder import TorchDecoder
from linne_tpu_torch.constants import (
    CH_PROCESS_MS,
    CODEC_VERSION,
    FORMAT_VERSION,
    HEADER_SIZE,
)
from linne_tpu_torch.exact.device_encoder import DeviceExactEncoder
from linne_tpu_torch.exact.encoder import ExactEncoder
from linne_tpu_torch.format.header import FormatError, LinneHeader


def _stream(nch=2, preset=0, n=600):
    """A short valid stream: one tail block."""
    rng = np.random.default_rng(nch + preset)
    sig = np.round(rng.normal(0, 2000, (nch, n))).astype(np.int32)
    enc = ExactEncoder()
    enc.set_encode_parameter(EncodeParameter(
        num_channels=nch, bits_per_sample=16, sampling_rate=44100,
        num_samples_per_block=4096, preset=preset,
        ch_process_method=CH_PROCESS_MS if nch > 1 else 0))
    return enc.encode_whole([sig[c] for c in range(nch)], n)


# whole-stream decoders from a port DecoderConfig; the JAX package's host
# Decoder is the reference
_DECODERS = {
    "Decoder": Decoder,
    "TorchDecoder": lambda cfg: TorchDecoder(cfg, device="cpu"),
    "JaxDecoder": lambda cfg: JaxDecoder(
        JaxDecoderConfig(**dataclasses.asdict(cfg))),
}


class TestEncoderConfig:
    def test_defaults_valid(self):
        EncoderConfig().validate()

    @pytest.mark.parametrize("field,value", [
        ("max_num_channels", 0),
        ("max_num_samples_per_block", 0),
        ("max_num_layers", 0),
        ("max_num_parameters_per_layer", 0),
    ])
    @pytest.mark.parametrize("entry", ["validate", "TorchEncoder"])
    def test_zero_fields_rejected(self, field, value, entry):
        cfg = EncoderConfig()
        setattr(cfg, field, value)
        with pytest.raises(ValueError):
            if entry == "validate":
                cfg.validate()
            else:
                TorchEncoder(config=cfg, device="cpu")

    def test_block_must_exceed_order(self):
        cfg = EncoderConfig(max_num_samples_per_block=64,
                            max_num_parameters_per_layer=128)
        with pytest.raises(ValueError):
            cfg.validate()


_ENCODERS = {
    "exact": ExactEncoder,
    "torch": lambda: TorchEncoder(device="cpu"),
    "exact_device": lambda: DeviceExactEncoder(device="cpu"),
}


class TestEncodeParameter:
    def _base(self, **kw):
        d = dict(num_channels=2, bits_per_sample=16, sampling_rate=44100)
        d.update(kw)
        return EncodeParameter(**d)

    def test_valid(self):
        self._base().validate_against(EncoderConfig())

    @pytest.mark.parametrize("kw", [
        dict(num_channels=0),
        dict(num_channels=99),
        dict(bits_per_sample=0),
        dict(sampling_rate=0),
        dict(num_samples_per_block=0),
        dict(preset=8),
        dict(preset=-1),
        dict(ch_process_method=7),
        dict(num_channels=1, ch_process_method=CH_PROCESS_MS),
        dict(num_samples_per_block=100, preset=5),  # layer order 128 > 100
    ])
    @pytest.mark.parametrize("entry", ["validate_against", "torch",
                                       "exact_device"])
    def test_invalid_rejected(self, kw, entry):
        param = self._base(**kw)
        with pytest.raises(ValueError):
            if entry == "validate_against":
                param.validate_against(EncoderConfig())
            else:
                _ENCODERS[entry]().set_encode_parameter(param)

    @pytest.mark.parametrize("encoder", ["exact", "torch", "exact_device"])
    def test_encode_before_set_parameter(self, encoder):
        with pytest.raises(RuntimeError):
            _ENCODERS[encoder]().encode_whole([np.zeros(16, np.int32)], 16)


class TestHeader:
    def _header(self, **kw):
        d = dict(num_channels=2, num_samples=1000, sampling_rate=44100,
                 bits_per_sample=16, num_samples_per_block=4096, preset=0,
                 ch_process_method=1)
        d.update(kw)
        return LinneHeader(**d)

    def test_roundtrip(self):
        h = self._header()
        h2 = LinneHeader.unpack(h.pack())
        assert h2.num_channels == 2
        assert h2.num_samples == 1000
        assert h2.sampling_rate == 44100
        assert h2.bits_per_sample == 16
        assert h2.num_samples_per_block == 4096
        assert h2.preset == 0
        assert h2.ch_process_method == 1
        assert h2.format_version == FORMAT_VERSION
        assert h2.codec_version == CODEC_VERSION

    def test_size(self):
        assert len(self._header().pack()) == HEADER_SIZE

    @pytest.mark.parametrize("byte", [7, 11])  # format, codec version
    @pytest.mark.parametrize("entry", ["unpack", "Decoder", "TorchDecoder"])
    def test_version_strictness(self, byte, entry):
        data = bytearray(_stream())
        data[byte] ^= 1
        with pytest.raises(FormatError):
            if entry == "unpack":
                LinneHeader.unpack(bytes(data))
            elif entry == "Decoder":
                Decoder().decode_whole(bytes(data))
            else:
                TorchDecoder(device="cpu").decode_whole(bytes(data))

    @pytest.mark.parametrize("mutate", [
        lambda h: setattr(h, "num_channels", 0),
        lambda h: setattr(h, "num_samples", 0),
        lambda h: setattr(h, "sampling_rate", 0),
        lambda h: setattr(h, "bits_per_sample", 0),
        lambda h: setattr(h, "num_samples_per_block", 0),
        lambda h: setattr(h, "preset", 9),
        lambda h: setattr(h, "ch_process_method", 2),
    ])
    def test_invalid_fields(self, mutate):
        h = self._header()
        mutate(h)
        with pytest.raises(FormatError):
            h.pack()

    def test_ms_mono_rejected(self):
        with pytest.raises(FormatError):
            self._header(num_channels=1, ch_process_method=1).pack()


class TestDecoderContracts:
    def test_decode_block_before_header(self):
        dec = Decoder()
        with pytest.raises(RuntimeError):
            dec.decode_block(b"\xff\xff" + b"\x00" * 20)

    def test_capacity_checks(self):
        h = LinneHeader(num_channels=8, num_samples=100, sampling_rate=44100,
                        bits_per_sample=16, num_samples_per_block=4096,
                        preset=7, ch_process_method=1)
        dec = Decoder(DecoderConfig(max_num_channels=2))
        with pytest.raises(FormatError):
            dec.set_header(h)
        dec = Decoder(DecoderConfig(max_num_parameters_per_layer=64))
        with pytest.raises(FormatError):
            dec.set_header(h)  # preset 7 needs order 128

    @pytest.mark.parametrize("config,nch,preset", [
        (DecoderConfig(max_num_channels=1), 2, 0),
        (DecoderConfig(max_num_parameters_per_layer=64), 1, 7),
        (DecoderConfig(max_num_layers=2), 1, 2),
    ])
    @pytest.mark.parametrize("entry", ["Decoder", "TorchDecoder",
                                       "JaxDecoder"])
    def test_capacity_checks_on_whole_streams(self, config, nch, preset,
                                              entry):
        """decode_whole applies the config's capacity to the stream's
        header: channels, layer order (preset 7's 128), layers (preset
        2's three). The JAX package's host Decoder, under the same
        config, is the reference."""
        data = _stream(nch, preset)
        make = _DECODERS[entry]
        with pytest.raises((FormatError, JaxFormatError)):
            make(config).decode_whole(data)
        # the default config decodes the same stream
        out = make(DecoderConfig()).decode_whole(data)
        assert len(out) == nch

    def test_bad_sync_code(self):
        h = LinneHeader(num_channels=1, num_samples=100, sampling_rate=44100,
                        bits_per_sample=16, num_samples_per_block=4096,
                        preset=0, ch_process_method=0)
        dec = Decoder()
        dec.set_header(h)
        with pytest.raises(FormatError):
            dec.decode_block(b"\x12\x34" + b"\x00" * 30)

    @pytest.mark.parametrize("entry", ["Decoder", "TorchDecoder"])
    def test_bad_sync_code_in_a_stream(self, entry):
        data = bytearray(_stream())
        data[HEADER_SIZE:HEADER_SIZE + 2] = b"\x12\x34"
        dec = Decoder() if entry == "Decoder" else TorchDecoder(device="cpu")
        with pytest.raises(FormatError):
            dec.decode_whole(bytes(data))
