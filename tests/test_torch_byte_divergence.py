"""How far the port's `-l` and `-a` bytes stray from TpuEncoder's on the
CPU, on a corpus of music-like tracks.

Both encoders analyze in float64, but XLA and torch sum the loss, the
gradients and the Gram products in other orders, and L1 momentum descent
and IRLS amplify the last-bit differences. So the block bytes may differ
where training runs long; the streams must stay lossless. The test counts
the compressed blocks whose bytes differ and the size delta, and prints
one line per case:

    JAX_PLATFORMS=cpu python -m pytest -m slow -s tests/test_torch_byte_divergence.py

Corpus: 4 x 10 s stereo 16-bit tracks at 44.1 kHz (chip_smoke.py's
make_track, seeds 0-3), block 10240, through encode_many on both sides.
"""

import numpy as np
import pytest

from chip_smoke import make_track
from linne_tpu.codec import params as jax_params
from linne_tpu.codec.encoder import TpuEncoder
from linne_tpu_torch.codec.decoder import Decoder
from linne_tpu_torch.codec.encoder import TorchEncoder
from linne_tpu_torch.codec.params import EncodeParameter
from linne_tpu_torch.constants import CH_PROCESS_MS, HEADER_SIZE
from linne_tpu_torch.format.block import parse_block_header

pytestmark = pytest.mark.slow

_SPB = 10240

# (flags, preset, -a N, -l)
_CASES = [("-l", 0, 0, True), ("-l", 1, 0, True), ("-a 2", 7, 2, False)]


def _param(preset, af, learn, cls=EncodeParameter):
    return cls(
        num_channels=2, bits_per_sample=16, sampling_rate=44100,
        num_samples_per_block=_SPB, preset=preset,
        ch_process_method=CH_PROCESS_MS, num_afmethod_iterations=af,
        enable_learning=learn)


def _blocks(data: bytes) -> list:
    """The framed blocks of one stream, in order."""
    out = []
    off = HEADER_SIZE
    while off < len(data):
        total = parse_block_header(data[off:]).total_size
        out.append(data[off : off + total])
        off += total
    return out


@pytest.mark.parametrize("flags,preset,af,learn", _CASES)
def test_port_bytes_against_tpu_encoder(flags, preset, af, learn):
    tracks = [make_track(10.0, seed) for seed in range(4)]
    chans = [[t[0], t[1]] for t in tracks]
    lengths = [t.shape[1] for t in tracks]

    port = TorchEncoder(device="cpu")
    port.set_encode_parameter(_param(preset, af, learn))
    ours = port.encode_many(chans, lengths)
    ref = TpuEncoder()
    ref.set_encode_parameter(
        _param(preset, af, learn, jax_params.EncodeParameter))
    theirs = ref.encode_many(chans, lengths)

    differ = total = 0
    for sig, a, b in zip(tracks, ours, theirs):
        for data in (a, b):
            assert np.array_equal(np.stack(Decoder().decode_whole(data)),
                                  sig)
        ba, bb = _blocks(a), _blocks(b)
        assert len(ba) == len(bb)
        total += len(ba)
        differ += sum(x != y for x, y in zip(ba, bb))
    size_a = sum(len(d) for d in ours)
    size_b = sum(len(d) for d in theirs)
    full = sum(n // _SPB for n in lengths)
    print(f"\nbyte divergence {flags} -m {preset}: {differ} of {total} "
          f"blocks differ ({full} full blocks through the batched stages, "
          f"the tails through the host encoder); port {size_a} bytes, "
          f"TpuEncoder {size_b} bytes, delta {size_a - size_b:+d} "
          f"({100.0 * (size_a - size_b) / size_b:+.5f} %)")
    # the bound README states: sizes within 0.1 %, as card against CPU
    assert abs(size_a - size_b) <= 0.001 * size_b
