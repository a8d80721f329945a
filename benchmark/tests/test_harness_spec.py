"""BENCHMARK.json against the benchmark's contract, and each cell's files
found by name."""

from __future__ import annotations

import re

import pytest

from conftest import ROOT, bench
from benchmark import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
B = bench()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(B["command"]) <= 32
    assert all(_line(w) for w in B["command"])
    assert 1 <= len(B["paths"]) <= 16
    for p in B["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (B["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_and_units():
    names = ([c["name"] for c in B["configs"]]
             + [w["name"] for w in B["workloads"]]
             + [m["name"] for m in B["end_to_end"] + B["per_layer"]])
    names += [w["traffic"] for w in B["workloads"]]
    names += [k for c in B["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for group in ("configs", "workloads"):
        got = [x["name"] for x in B[group]]
        assert len(got) == len(set(got))
    metrics = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


def test_configs():
    assert 1 <= len(B["configs"]) <= 24
    used = {w["config"] for w in B["workloads"]}
    files = set()
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in B["paths"])
        assert (ROOT / c["file"]).is_file()
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        cfg = run.load_json(ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]


def test_workloads():
    assert 1 <= len(B["workloads"]) <= 24
    pairs = set()
    four = 0
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert four <= max(1, len(B["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    cells = [w["name"] for w in B["workloads"]]
    assert 1 <= len(e2e) <= 16 and 1 <= len(B["per_layer"]) <= 128
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in B["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in B["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells), (m["name"], cell)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    layers = {}
    for m in B["per_layer"]:  # one name a layer, letter for letter
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for cell in cells:
        own = [m for m in B["end_to_end"] if cell in m.get("workloads",
                                                            cells)]
        assert "setup_s" in [m["name"] for m in own] and len(own) >= 2
        assert any(cell in m.get("workloads", cells) for m in B["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_cell_files_found_by_name(cell):
    files = run.cell_files(B, cell)
    entry = files["traffic"]["entry"]
    assert (ROOT / "benchmark" / "entries" / f"{entry}.py").is_file()
    mod = __import__(f"benchmark.entries.{entry}", fromlist=["NAMES"])
    assert set(files["limits"]) == set(mod.NAMES)
    for key, folder in (("end_to_end", "end_to_end"),
                        ("per_layer", "metrics")):
        for m in run.metrics_of(B, key, cell):
            assert (ROOT / "benchmark" / folder / f"{m['name']}.py").is_file()
