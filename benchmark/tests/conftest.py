"""Shared helpers of the harness's tests: the cells' files at a size the
CPU runs in seconds, and the `cuda` marker's fixture."""

from __future__ import annotations

import copy
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402


def bench() -> dict:
    return run.load_json(ROOT / "BENCHMARK.json")


def tiny_files(cell: str, tracks: int = 2, seconds: float = 1.0,
               blocks: int = 8) -> dict:
    """The cell's files with a corpus of `tracks` tracks of `seconds`, one
    track a folder and batches of 8 blocks; widths and presets as they
    are."""
    files = copy.deepcopy(run.cell_files(bench(), cell))
    t = files["traffic"]
    t.update(corpus_tracks=tracks, folder_tracks=1, track_seconds=seconds,
             batch_blocks=8, warmup_max_passes=1)
    t["material"] = dict(t["material"], silent_tracks=1, burst_tracks=1)
    if "analysis_blocks" in t["check"]:
        t["check"]["analysis_blocks"] = blocks
    return files


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
