"""A cell and a per-layer metric added as new files, in a copy of the
benchmark, are picked up by the harness without an edit to any file that
is there (BENCHMARK.json, the index, gains their entries)."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT, tiny_files


def _digests(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_and_metric_are_found(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "benchmark")
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    files = tiny_files("cd-m0.encode")
    # the new files: a traffic mix, the cell's limits, a metric's reader
    (tmp_path / "benchmark/traffic/tiny_folders.json").write_text(
        json.dumps(files["traffic"]))
    (tmp_path / "benchmark/limits/cd-m0.tiny.json").write_text(
        json.dumps(files["limits"]))
    (tmp_path / "benchmark/metrics/batches_per_folder.py").write_text(
        "def read(ctx):\n"
        "    return ctx['counters']['batches'] / (ctx['audio_s'] / 10.0)\n")
    b["workloads"].append({"name": "cd-m0.tiny", "config": "cd-m0",
                           "traffic": "tiny_folders", "chips": 1,
                           "why": "a test cell"})
    b["per_layer"].append({"name": "batches_per_folder", "unit": "1",
                           "better": "lower", "source": "program_counter",
                           "layer": "stage dispatch (codec/graphs.py)",
                           "moves": "encode_device_ms_per_audio_min",
                           "workloads": ["cd-m0.tiny"]})
    for m in b["end_to_end"]:
        if "workloads" in m and "cd-m0.encode" in m["workloads"]:
            m["workloads"].append("cd-m0.tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = ("import json\n"
            "from benchmark import run\n"
            "b = run.load_json(run.ROOT / 'BENCHMARK.json')\n"
            "r = run.run_cell(b, 'cd-m0.tiny', 3, 0.1, True, 'cpu')\n"
            "print(json.dumps(r))\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"]
    assert "batches_per_folder" in r["metrics"]
    after = _digests(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
