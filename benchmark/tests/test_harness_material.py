"""The corpus generator: the same seed gives the same tracks, another seed
other samples of the same set of tracks."""

from __future__ import annotations

import numpy as np

from conftest import tiny_files
from benchmark import material


def _corpus(seed):
    t = tiny_files("cd-m7.encode")["traffic"]
    return material.make_corpus(t["material"], 6, 0.5, 44100, 2, seed, "cpu")


def test_same_seed_same_tracks():
    a, b = _corpus(2**31 + 17), _corpus(2**31 + 17)
    assert all(np.array_equal(x, y) for x, y in zip(a.tracks, b.tracks))
    assert a.folders == b.folders == [[0, 1], [2, 3], [4, 5]]


def test_other_seed_other_samples_same_design():
    a, b = _corpus(5), _corpus(6)
    assert not any(np.array_equal(x, y) for x, y in zip(a.tracks, b.tracks))
    # the same silent tracks, a shuffle apart
    zeros = lambda c: sorted(int(np.count_nonzero(t == 0) > 1000)
                             for t in c.tracks)
    assert zeros(a) == zeros(b)
    assert all(t.dtype == np.int32 and t.shape == (2, 22050)
               for t in a.tracks)
    assert all(np.abs(t).max() <= 32768 for t in a.tracks)


def test_design_is_fixed():
    m = tiny_files("cd-m7.encode")["traffic"]["material"]
    d1, d2 = material.design(m, 64), material.design(m, 64)
    assert all(np.array_equal(d1[k], d2[k]) for k in d1)
    assert (d1["silence_kind"] > 0).sum() == m["silent_tracks"]
    assert (d1["burst_s"] > 0).sum() == m["burst_tracks"]
