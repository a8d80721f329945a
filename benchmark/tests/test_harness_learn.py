"""The `-l` cell (`cd-m7-l.encode`): its files found by name, the imports
rule for its plain trainer, its readers on a program without the
trainer's counters (the parent), and its judge against streams with a
fault: one residual bit flipped, the training skipped, the trainer in
float32. The program and the reference run on the CPU at blocks of 2048
samples, one short track."""

from __future__ import annotations

import copy
import importlib
import json
import subprocess
import sys

import pytest

from conftest import ROOT, bench, tiny_files
from benchmark import learn_control, material, run
from benchmark.entries import learn_encode

CELL = "cd-m7-l.encode"
N = 2048


def test_files_are_found_by_name():
    files = run.cell_files(bench(), CELL)
    assert files["cell"]["chips"] == 1
    assert files["config"]["learning"] is True
    assert files["config"]["preset"] == 7
    assert files["traffic"]["entry"] == "learn_encode"
    assert files["traffic"]["batch_blocks"] == 128
    entry = importlib.import_module("benchmark.entries.learn_encode")
    assert set(entry.NAMES) == set(files["limits"])
    for key, kind in (("end_to_end", "end_to_end"), ("per_layer", "metrics")):
        for m in run.metrics_of(bench(), key, CELL):
            assert (ROOT / "benchmark" / kind / f"{m['name']}.py").exists()
    end = {m["name"] for m in run.metrics_of(bench(), "end_to_end", CELL)}
    # the card time a minute of audio is left out: the trainer's
    # iterations, and so the card's work, depend on the seed's samples
    assert end == {"stream_pct", "setup_s"}
    per_layer = run.metrics_of(bench(), "per_layer", CELL)
    assert {m["name"] for m in per_layer} == {
        "train_iterations_per_batch", "train_active_row_pct",
        "train_wall_pct", "device_idle_pct.learn", "graph_replay_pct.learn"}
    assert all(m["moves"] in end for m in per_layer)


def test_the_trainer_reference_imports_nothing_of_the_program():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, json\n"
         "import benchmark.reference.training\n"
         "print(json.dumps(sorted({m.split('.')[0] "
         "for m in sys.modules})))\n"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
             "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "linne_tpu",
                      "linne_tpu_torch"}


def test_readers_leave_out_what_the_parent_lacks():
    parent = {"graph_eager_runs": 0, "graph_captures": 0,
              "graph_replays": 12, "bytes_to_host": 1, "overflow_rows": 0,
              "batches": 12}
    ctx = {"counters": parent, "window_s": 51.0}
    for name in ("train_iterations_per_batch", "train_active_row_pct",
                 "train_wall_pct"):
        assert run.reader("metrics", name).read(ctx) is None
    ctx["counters"] = dict(parent, train_batches=4, train_iterations=400,
                           train_row_iterations=102400,
                           train_active_row_iterations=10240, train_s=25.5)
    assert run.reader("metrics", "train_iterations_per_batch").read(
        ctx) == 100.0
    assert run.reader("metrics", "train_active_row_pct").read(ctx) == 10.0
    assert run.reader("metrics", "train_wall_pct").read(ctx) == 50.0


def _files():
    """The cell at blocks of 2048: one track of 0.2 s (four full blocks and
    a tail), no silence or burst, every block in the check's sample."""
    files = copy.deepcopy(tiny_files(CELL, tracks=1, seconds=0.2, blocks=4))
    files["config"]["format"]["num_samples_per_block"] = N
    files["traffic"]["material"].update(silent_tracks=0, burst_tracks=0)
    return files


@pytest.fixture(scope="module")
def sound():
    """(files, corpus, the program's outputs, the judge's numbers) of the
    cell at the tiny size."""
    files = _files()
    t = files["traffic"]
    corpus = material.make_corpus(t["material"], 1, t["track_seconds"],
                                  44100, 1, 7, "cpu")
    prog = learn_encode.Program(files["config"], t, "cpu", corpus)
    outputs = list(zip([0], prog(*prog.inputs([0]))))
    counters = prog.counters()
    judged = learn_encode.judge(files["config"], t, corpus, outputs, 7,
                                "cpu")
    return files, corpus, outputs, judged, counters


def test_a_sound_run_passes(sound):
    files, _corpus, _outputs, judged, counters = sound
    n = judged["numbers"]
    assert n == {"invalid_streams": 0, "lossless_failures": 0,
                 "learned_side_info_mismatch_pct": 0.0,
                 "learned_l1_excess_pct": 0.0}
    assert judged["compared_blocks"] == 4
    assert counters["train_batches"] == 1
    assert counters["train_iterations"] == max(judged["reference_stops"])


def test_a_flipped_residual_bit_is_caught(sound):
    files, corpus, outputs, _judged, _counters = sound
    data = bytearray(outputs[0][1])
    data[len(data) // 2] ^= 0x01  # in a block's Rice-coded residual
    judged = learn_encode.judge(files["config"], files["traffic"], corpus,
                                [(0, bytes(data))], 7, "cpu")
    n = judged["numbers"]
    assert n["invalid_streams"] + n["lossless_failures"] > 0
    assert not all(judged["verdict"])


@pytest.mark.parametrize("control", ["skip", "float32"])
def test_a_broken_trainer_is_caught(sound, control, monkeypatch):
    files, corpus, _outputs, _judged, _counters = sound
    from linne_tpu_torch.ops import training

    _real, make = learn_control.broken_trainer(control)
    monkeypatch.setattr(training, "make_train_fn", make)
    t = files["traffic"]
    prog = learn_encode.Program(files["config"], t, "cpu", corpus)
    outputs = list(zip([0], prog(*prog.inputs([0]))))
    judged = learn_encode.judge(files["config"], t, corpus, outputs, 7,
                                "cpu")
    n = judged["numbers"]
    assert n["invalid_streams"] == 0 and n["lossless_failures"] == 0
    limits = files["limits"]
    assert (n["learned_side_info_mismatch_pct"]
            > limits["learned_side_info_mismatch_pct"]
            or n["learned_l1_excess_pct"] > limits["learned_l1_excess_pct"])
