#!/usr/bin/env python3
"""Run one benchmark cell of the port (`linne_tpu_torch`) once.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout. The cell is an entry of `workloads` in
BENCHMARK.json; its configuration, its traffic (`benchmark/traffic/
<traffic>.json`), its limits (`benchmark/limits/<cell>.json`), its entry
into the program (`benchmark/entries/<entry>.py`) and every metric's
reader (`benchmark/end_to_end/<metric>.py`, `benchmark/metrics/
<metric>.py`) are files found by name, so a cell, a mix or a metric is
added by adding files.

A run: checks for the cards the cell asks for; makes the corpus from the
seed on the card; builds the program's objects and warms them on the
corpus until a whole pass over it runs without a first-time shape (set-up
ends here); then runs a closed loop of one client for `--seconds`: one
folder at a time, the next sent when the last returns, counting whole
folders up to the first that ends after the deadline, the window taken to
that folder's end (traced with `torch.profiler` under `--trace 1`); frees
the program's state, judges every output of the window against the plain
reference (benchmark/reference) and prints each number compared beside
its limit on standard error, then one JSON line on standard output: the
end-to-end metrics (`--trace 0`) or the per-layer ones (`--trace 1`).
A cell with an end-to-end metric read from the device (`source`
`device_trace`) records the card's activity alone in its `--trace 0`
window, so that the metric has its trace.
It exits non-zero without a result when a card is missing or when JAX or
the JAX package was loaded.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "linne_tpu")

# every build and kernel cache in the checkout, at fixed paths (the
# program builds its own kernels into linne_tpu_torch/csrc/build)
_CACHE = ROOT / ".bench_cache"
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(_CACHE / _sub)
os.environ["USE_FLAX"] = "0"
# the benchmark's modules import as the package `benchmark`, never from
# the script's own folder
sys.path[:] = [p for p in sys.path
               if pathlib.Path(p or ".").resolve() != HERE]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(kind: str, name: str):
    """The module of `benchmark/<kind>/<name>.py`."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(bench: dict, name: str) -> dict:
    """Everything a cell is made of, found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[cell["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")
    return {"cell": cell, "config": config, "traffic": traffic,
            "limits": limits}


def metrics_of(bench: dict, key: str, cell: str) -> list:
    return [m for m in bench[key] if cell in m.get("workloads", [cell])]


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device: str, files: dict | None = None, hook=None) -> dict:
    """One run of a cell on `device`; returns the result object (without
    printing). `files` replaces the cell's files, `hook(program)` may wrap
    the program (tests)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import material
    from benchmark import trace_summary as tracing

    t0 = _T0
    files = files or cell_files(bench, name)
    config, traffic = files["config"], files["traffic"]
    entry = importlib.import_module(f"benchmark.entries.{traffic['entry']}")
    f = config["format"]
    cuda = torch.device(device).type == "cuda"

    if cuda:
        torch.zeros(1, device=device)
    log(f"torch and the card ready {time.perf_counter() - t0:.2f} s from "
        "start")
    corpus = material.make_corpus(
        traffic["material"], traffic["corpus_tracks"],
        traffic["track_seconds"], f["sampling_rate"],
        traffic["folder_tracks"], seed, device)
    if cuda:  # the peak read after the window is the program's
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    log(f"corpus: {len(corpus.tracks)} tracks in {len(corpus.folders)} "
        f"folders, {time.perf_counter() - t0:.2f} s from start")
    prog = entry.Program(config, traffic, device, corpus)
    if hook is not None:
        prog = hook(prog)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # warm-up: whole passes over the corpus until one changes nothing
    passes = 0
    while True:
        before = prog.counters()
        for folder in corpus.folders:
            prog(*prog.inputs(folder))
        sync()
        passes += 1
        if prog.settled(before, prog.counters()) or passes >= traffic[
                "warmup_max_passes"]:
            break
    log(f"warm-up: {passes} passes, settled "
        f"{prog.settled(before, prog.counters())}")
    # what set-up made lives to the end: the collector's full passes in
    # the window need not scan it again
    gc.collect()
    gc.freeze()

    counters0 = prog.counters()
    done = []  # (folder index, outputs)
    ends = []  # each folder's end on the host clock
    prof = None
    device_only = cuda and not trace and any(
        m["source"] == "device_trace"
        for m in metrics_of(bench, "end_to_end", name))
    if trace:
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
    elif device_only:
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    w0 = time.perf_counter()
    setup_s = w0 - t0
    with record_function(tracing.WINDOW):
        k = 0
        while True:
            fi = k % len(corpus.folders)
            with record_function("bench.folder"):
                out = prog(*prog.inputs(corpus.folders[fi]))
            done.append((fi, out))
            ends.append(time.perf_counter())
            k += 1
            if ends[-1] - w0 >= seconds:
                break
    w1 = time.perf_counter()
    sync()
    if prof is not None:
        prof.__exit__(None, None, None)
    window_s = w1 - w0
    counters1 = prog.counters()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    summary = busy_s = None
    if trace:
        summary = tracing.summarize(prof.events())
        busy_s = summary.busy_s
    elif prof is not None:
        busy_s = tracing.device_busy_s(
            prof.profiler.kineto_results.events())
    prof = None
    program_inputs = getattr(prog, "streams", None)
    prog.close()
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    spans = sorted(b - a for a, b in zip([w0] + ends[:-1], ends))
    log(f"window: {len(done)} folders in {window_s:.3f} s (a folder "
        f"{spans[0]:.3f} / {spans[len(spans) // 2]:.3f} / {spans[-1]:.3f} s "
        f"least / median / most); set-up {setup_s:.3f} s")

    outputs = []
    counts = {}
    for fi, out in done:
        for ti, o in zip(corpus.folders[fi], out):
            outputs.append((ti, o))
            counts[ti] = counts.get(ti, 0) + 1
    tj = time.perf_counter()
    judged = entry.judge(config, traffic, corpus, outputs, seed, device)
    log(f"judged in {time.perf_counter() - tj:.2f} s "
        f"{judged.get('times', '')} {judged.get('block_types', '')}")
    spb = f["num_samples_per_block"]
    ctx = {
        "config": config, "traffic": traffic, "corpus": corpus,
        "entry": entry, "judged": judged, "counts": counts,
        "outputs": outputs, "program_inputs": program_inputs,
        "setup_s": setup_s, "window_s": window_s,
        "audio_s": sum(corpus.num_samples[ti] for ti, _ in outputs)
        / f["sampling_rate"],
        "full_blocks": sum(corpus.num_samples[ti] // spb
                           for ti, _ in outputs),
        "counters": {k: counters1[k] - counters0[k] for k in counters0},
        "trace": summary,
        "device_busy_s": busy_s,
    }
    key = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(bench, key, name):
        kind = "metrics" if trace else "end_to_end"
        value = reader(kind, m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    limits = files["limits"]
    numbers = judged["numbers"]
    checks = {k: {"value": numbers[k], "limit": limits[k]}
              for k in entry.NAMES}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if cuda:
        dev["power_limit"] = power_limit()
    result = {"correct": bool(correct), "attempted": len(outputs),
              "failed": sum(1 for v in judged["verdict"] if not v),
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in summary.device_ops],
            "idle_gaps": [[n, s] for n, s in summary.idle_gaps]}
    result["checks"] = checks
    if judged.get("bad"):
        log(f"faults: {judged['bad']}")
    return result


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    bench = load_json(ROOT / "BENCHMARK.json")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=bench["run_seconds"])
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    files = cell_files(bench, args.workload)

    import torch

    chips = files["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"the cell needs {chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", files)
    found = loaded_forbidden()
    if found:
        log(f"modules that must not load were loaded: {found}")
        return 4
    log(f"card: {result['device']['power_limit']}")
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
