#!/usr/bin/env python3
"""The controls of the `-l` cell's comparison: the program with its trainer
broken in one way, judged by the cell's judge at the cell's own size. Each
must come out not correct.

- `skip`: the training skipped, G1's fitted parameters passed through;
- `float32`: the trainer run in float32 (the signal and the parameters
  rounded to float32, the trained parameters widened back);
- `cap10`: the trainer stopped after 10 iterations;
- `none`: the program as it is (a sound reading).

    python3 benchmark/learn_control.py --workload cd-m7-l.encode \
        --controls none skip cap10 float32 [none ...] --seeds N [N ...]

makes each seed's corpus once and, for each control in turn, encodes
every folder of it once with one encoder, as the cell's window does, and
prints one JSON line: the judge's numbers, whether they pass the cell's
limits, and a digest of the streams (a control named twice runs twice,
and two runs of one seed must give one digest). The judge's reference
depends on the seed alone, so it is computed once a seed. The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def broken_trainer(control: str):
    """A stand-in for `training.make_train_fn` that breaks the trainer as
    `control` says."""
    import torch

    from linne_tpu_torch.ops import training

    real = training.make_train_fn

    def make(orders, unit_choices, max_iters, *args, **kw):
        if control == "cap10":
            return real(orders, unit_choices, 10, *args, **kw)
        inner = real(orders, unit_choices, max_iters, *args, **kw)

        def train(sig, params, log2u, stops=None):
            if control == "skip":
                return list(params), 0
            out, its = inner(sig.to(torch.float32),
                             [p.to(torch.float32) for p in params], log2u,
                             stops)
            return [p.to(sig.dtype) for p in out], its
        return train
    return real, make


def control_run(files: dict, control: str, seed: int, device: str,
                corpus) -> dict:
    from benchmark.entries import learn_encode
    from linne_tpu_torch.ops import training

    config, traffic = files["config"], files["traffic"]
    real, make = broken_trainer(control)
    if control != "none":
        training.make_train_fn = make
    try:
        prog = learn_encode.Program(config, traffic, device, corpus)
        tick = time.perf_counter()
        outputs = []
        for folder in corpus.folders:
            outputs.extend(zip(folder, prog(*prog.inputs(folder))))
        encode_s = time.perf_counter() - tick
        prog.close()
    finally:
        training.make_train_fn = real
    tick = time.perf_counter()
    judged = learn_encode.judge(config, traffic, corpus, outputs, seed,
                                device)
    numbers = judged["numbers"]
    limits = files["limits"]
    return {"control": control, "seed": seed, "numbers": numbers,
            "correct": all(numbers[k] <= limits[k]
                           for k in learn_encode.NAMES),
            "compared": judged["compared_blocks"], "encode_s": encode_s,
            "digest": hashlib.sha256(b"".join(
                data for _ti, data in outputs)).hexdigest()[:16],
            "judge_s": time.perf_counter() - tick}


def main(argv=None) -> int:
    from benchmark import material, run
    from benchmark.entries import learn_encode

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="cd-m7-l.encode")
    ap.add_argument("--controls", required=True, nargs="+",
                    choices=("skip", "float32", "cap10", "none"))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    files = run.cell_files(bench, args.workload)
    config, traffic = files["config"], files["traffic"]
    real = learn_encode.reference
    for seed in args.seeds:
        corpus = material.make_corpus(
            traffic["material"], traffic["corpus_tracks"],
            traffic["track_seconds"], config["format"]["sampling_rate"],
            traffic["folder_tracks"], seed, args.device)
        memo = {}

        def reference(config, corpus, blocks, device):
            key = tuple(blocks)
            if key not in memo:
                memo[key] = real(config, corpus, blocks, device)
            return memo[key]

        learn_encode.reference = reference
        try:
            for control in args.controls:
                print(json.dumps(control_run(files, control, seed,
                                             args.device, corpus)),
                      flush=True)
        finally:
            learn_encode.reference = real
    return 0


if __name__ == "__main__":
    sys.exit(main())
