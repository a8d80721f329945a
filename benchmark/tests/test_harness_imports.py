"""No module that a run or the reference imports has the top-level name
`jax`, `jaxlib`, `flax` or `linne_tpu` (names compared whole: the port,
`linne_tpu_torch`, is another name); the reference imports nothing of the
port either."""

from __future__ import annotations

import ast
import json
import pathlib
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "linne_tpu"}
BENCH = ROOT / "benchmark"


def _imports(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_name_no_forbidden_module():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _imports(path) & FORBIDDEN, path


def test_reference_sources_import_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert not _imports(path) & (FORBIDDEN | {"linne_tpu_torch"}), path


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
             "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys, json\n"
        "sys.path.insert(0, 'benchmark/tests')\n"
        "from conftest import bench, tiny_files\n"
        "from benchmark import run\n"
        "r = run.run_cell(bench(), 'cd-m0.encode', 7, 0.1, True, 'cpu',\n"
        "                 tiny_files('cd-m0.encode'))\n"
        "assert r['correct'], r\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    top = _modules_after(code)
    assert "linne_tpu_torch" in top
    assert not top & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import sys, json\n"
        "import benchmark.reference.analysis, benchmark.reference.integer\n"
        "import benchmark.reference.stream\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    top = _modules_after(code)
    assert not top & (FORBIDDEN | {"linne_tpu_torch"})
