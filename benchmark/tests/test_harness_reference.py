"""The plain reference: it reads a tiny stream of the program's, gives
back its samples, works out the same side information on the CPU, and
refuses a stream with a flipped byte. (The tests may import the program;
the reference itself does not.)"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import tiny_files
from benchmark import material
from benchmark.entries import encode
from benchmark.reference import analysis, integer, stream


@pytest.fixture(scope="module")
def tiny():
    files = tiny_files("cd-m7.encode", tracks=2, seconds=0.75)
    t = files["traffic"]
    corpus = material.make_corpus(t["material"], 2, 0.75, 44100, 1, 31337,
                                  "cpu")
    prog = encode.Program(files["config"], t, "cpu", corpus)
    streams = prog(*prog.inputs([0, 1]))
    return files["config"], corpus, streams


def _layers(g, orders):
    return [tuple(torch.from_numpy(np.ascontiguousarray(v)) for v in lay)
            for lay in encode.side_layers(g, slice(None), orders)]


def test_round_trip(tiny):
    config, corpus, streams = tiny
    orders = config["layer_num_params"]
    p = stream.parse_streams(streams, orders)
    assert p.bad == [None, None]
    for n, g in p.groups.items():
        layers = _layers(g, orders)
        x = integer.synthesize(torch.from_numpy(g.residual), True,
                               torch.from_numpy(g.pprev),
                               torch.from_numpy(g.pcoef), layers)
        for r, (si, bi) in enumerate(p.members[n]):
            start = sum(b[1] for b in p.blocks[si][:bi])
            want = corpus.tracks[si][:, start : start + n]
            assert np.array_equal(x[r].numpy(), want)
            res = integer.residual_of(torch.from_numpy(want[None]).long(),
                                      True, torch.from_numpy(g.pprev[r:r + 1]),
                                      torch.from_numpy(g.pcoef[r:r + 1]),
                                      [tuple(v[r:r + 1] for v in lay)
                                       for lay in layers])
            assert torch.equal(res[0], torch.from_numpy(g.residual[r]))


def test_side_information_of_full_blocks(tiny):
    config, corpus, streams = tiny
    orders = config["layer_num_params"]
    p = stream.parse_streams(streams, orders)
    g = p.groups[10240]
    blocks = [p.members[10240][r] for r in range(len(p.members[10240]))]
    x = np.stack([corpus.tracks[si][:, bi * 10240 : (bi + 1) * 10240]
                  for si, bi in blocks])
    side = analysis.analyse(torch.from_numpy(x), orders,
                            config["ridge_terms"], 16, True)
    for name in encode.FIELDS:
        assert np.array_equal(getattr(side, name).numpy(), getattr(g, name))


def test_reader_matches_the_programs_reader(tiny):
    from linne_tpu_torch.format.block import read_compress_payload
    from linne_tpu_torch.format.huffman import get_codebook
    from linne_tpu_torch.presets import PRESETS

    config, _corpus, streams = tiny
    orders = tuple(config["layer_num_params"])
    cb = get_codebook(PRESETS[config["preset"]].coef_freq_table)
    p = stream.parse_streams(streams, orders)
    for si, data in enumerate(streams):
        frames = stream.read_frames(data, stream.read_header(data))
        for bi, f in enumerate(frames):
            if f.block_type != stream.BLOCK_COMPRESS:
                continue
            side, res, _ = read_compress_payload(f.payload, 2, f.num_samples,
                                                 16, orders, cb)
            _t, n, key, r = p.blocks[si][bi]
            g = p.groups[key]
            for ch in range(2):
                assert np.array_equal(g.residual[r, ch], res[ch])
                assert np.array_equal(g.coefs[r, ch],
                                      np.concatenate(side.coefs[ch]))


def test_crc_and_huffman_match_the_programs():
    from linne_tpu_torch.format.crc16 import crc16
    from linne_tpu_torch.format.huffman import get_codebook
    from linne_tpu_torch.presets import COEF_FREQ_TABLE

    rng = np.random.default_rng(3)
    spans = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
             for n in (0, 1, 2, 5, 300, 4097)]
    assert list(stream.crc16_many(spans)) == [crc16(s) for s in spans]
    assert stream.COEF_FREQ_TABLE == tuple(COEF_FREQ_TABLE)
    cb = get_codebook(COEF_FREQ_TABLE)
    assert stream.huffman_codes(COEF_FREQ_TABLE) == list(cb.codes)


@pytest.mark.parametrize("where", [40, 200, -3])
def test_a_flipped_byte_is_refused(tiny, where):
    config, _corpus, streams = tiny
    data = bytearray(streams[0])
    data[where] ^= 0x10
    p = stream.parse_streams([bytes(data)], config["layer_num_params"])
    assert p.bad[0] is not None
