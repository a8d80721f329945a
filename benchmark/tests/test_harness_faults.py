"""A run with the timed path broken underneath comes out not correct, once
for each fault the cells can have: an answer altered where it is made, a
stale answer (the program returns what it returned before), half of a
call's answers left out (copies of the other half in their place). The
runs skip the look for a card and run on the CPU at a tiny size."""

from __future__ import annotations

import numpy as np
import pytest

from conftest import bench, tiny_files
from benchmark import run


class Broken:
    """The program, with its answers changed by `fault`."""

    def __init__(self, prog, fault):
        self._prog = prog
        self._fault = fault
        self._last = None

    def __getattr__(self, name):
        return getattr(self._prog, name)

    def __call__(self, *args):
        out = list(self._prog(*args))
        changed = self._fault(out, self._last)
        self._last = out
        return changed


def altered(out, last):
    first = out[0]
    if isinstance(first, bytes):
        data = bytearray(first)
        data[len(data) // 2] ^= 0x01
        return [bytes(data)] + out[1:]
    chans = [np.array(c, copy=True) for c in first]
    chans[0][len(chans[0]) // 2] += 1
    return [chans] + out[1:]


def stale(out, last):
    return last if last is not None else out


def half_left_out(out, last):
    h = len(out) // 2
    return out[:h] + out[:len(out) - h]


@pytest.mark.parametrize("cell", ["cd-m0.encode", "cd-m7.decode"])
@pytest.mark.parametrize("fault", [altered, stale, half_left_out])
def test_fault_is_not_correct(cell, fault):
    files = tiny_files(cell, tracks=4, seconds=0.5)
    files["traffic"]["folder_tracks"] = 2
    r = run.run_cell(bench(), cell, 99, 0.1, False, "cpu", files,
                     hook=lambda p: Broken(p, fault))
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("cell", ["cd-m0.encode", "cd-m7.decode"])
def test_sound_run_is_correct(cell):
    files = tiny_files(cell, tracks=4, seconds=0.5)
    files["traffic"]["folder_tracks"] = 2
    r = run.run_cell(bench(), cell, 99, 0.1, False, "cpu", files)
    assert r["correct"] is True and r["failed"] == 0
    assert list(r["checks"])[-1] and list(r)[-1] == "checks"
