"""The controls: the reference in the program's place one precision below
the configuration's comes out not correct. On the CPU at a small size
here; the `cuda` tests run them at the cells' own size on a card."""

from __future__ import annotations

import pytest

from conftest import bench, tiny_files
from benchmark import control, run


def test_encode_control_fails_on_the_cpu():
    files = tiny_files("cd-m7.encode", tracks=4, seconds=1.0, blocks=16)
    got = control.encode_control(files, 5, "cpu")
    assert got["side_info_mismatch_pct"] > files["limits"][
        "side_info_mismatch_pct"]


def test_decode_control_fails_on_the_cpu():
    files = tiny_files("cd-m7.decode", tracks=4, seconds=0.5)
    files["traffic"]["folder_tracks"] = 4
    got = control.decode_control(files, 5, "cpu", precision="tf32")
    assert got["samples_wrong"] > files["limits"]["samples_wrong"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["cd-m7.encode", "cd-m0.encode"])
def test_encode_control_fails_at_the_cells_size(card, cell):
    files = run.cell_files(bench(), cell)
    for seed in (11, 12, 13):
        got = control.encode_control(files, seed, card)
        assert got["side_info_mismatch_pct"] > files["limits"][
            "side_info_mismatch_pct"]


@pytest.mark.cuda
def test_decode_control_fails_at_the_cells_size(card):
    files = run.cell_files(bench(), "cd-m7.decode")
    for seed in (11, 12, 13):
        got = control.decode_control(files, seed, card, precision="tf32")
        assert got["samples_wrong"] > files["limits"]["samples_wrong"]
