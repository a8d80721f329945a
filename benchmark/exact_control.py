#!/usr/bin/env python3
"""The controls of the byte-exact cell's comparison
(`exact_block_mismatches`, benchmark/entries/exact_encode.py). Each puts
something other than the upstream encoder's analysis in the program's
place; a control that the check cannot tell from the program would show
the check blind.

- `reference32`: the plain reference computed one precision below what
  the configuration states (float32), on the tracks and blocks the check
  samples from the seed, its blocks counted against the float64
  reference's by the check's own comparison (`same_block`) and held to
  the cell's limit (no program runs);
- `batched`: a run of the cell (`run.run_cell`) whose outputs come from
  the batched `TorchEncoder` at the configuration's preset (float64;
  its card kernels take no other precision); the run's checks are
  printed as the cell prints them.

    python3 benchmark/exact_control.py --workload CELL --control NAME \\
        --seeds N [N ...] [--seconds S]

prints one JSON line a seed. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[:] = [p for p in sys.path if pathlib.Path(p or ".").resolve()
                   != ROOT / "benchmark"]
    sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402  (first: its settings)


def reference32(files: dict, seed: int, device: str) -> dict:
    import numpy as np

    from benchmark import material
    from benchmark.entries import exact_encode
    from benchmark.reference import exact

    config, traffic = files["config"], files["traffic"]
    f = config["format"]
    corpus = material.make_corpus(
        traffic["material"], traffic["corpus_tracks"],
        traffic["track_seconds"], f["sampling_rate"],
        traffic["folder_tracks"], seed, device)
    picked = exact_encode.sample_tracks(traffic, range(len(corpus.tracks)),
                                        seed)
    blocks = traffic["check"]["blocks"]
    tracks = [corpus.tracks[ti] for ti in picked]
    want = exact.analyse_tracks(tracks, blocks, config)
    low = exact.analyse_tracks(tracks, blocks, config, np.float32)
    differ = sum(
        not exact_encode.same_block(y.block_type,
                                    lambda name: getattr(y, name), x)
        for a, b in zip(want, low) for x, y in zip(a, b))
    return {"exact_block_mismatches": differ,
            "blocks": blocks * len(picked),
            "correct": differ <= files["limits"]["exact_block_mismatches"]}


class Batched:
    """The batched encoder in the byte-exact program's place."""

    def __init__(self, prog, files: dict, device: str):
        from benchmark.entries import encode

        traffic = dict(files["traffic"], batch_blocks=128)
        self.prog = encode.Program(files["config"], traffic, device,
                                   prog.corpus)
        self.exact = prog

    def __getattr__(self, name):
        return getattr(self.prog, name)

    def __call__(self, tracks, lengths):
        return self.prog(tracks, lengths)

    def close(self) -> None:
        self.prog.close()
        self.exact.close()


def batched(files: dict, seed: int, device: str, seconds: float) -> dict:
    bench = run.load_json(ROOT / "BENCHMARK.json")
    r = run.run_cell(bench, files["cell"]["name"], seed, seconds, False,
                     device, files,
                     hook=lambda prog: Batched(prog, files, device))
    return {k: c["value"] for k, c in r["checks"].items()} | {
        "correct": r["correct"], "attempted": r["attempted"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control", required=True,
                    choices=("reference32", "batched"))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0,
                    help="the batched control's window")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = run.load_json(ROOT / "BENCHMARK.json")
    files = run.cell_files(bench, args.workload)
    for seed in args.seeds:
        if args.control == "reference32":
            out = reference32(files, seed, args.device)
        else:
            out = batched(files, seed, args.device, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
