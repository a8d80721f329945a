#!/usr/bin/env python3
"""The controls of the cells' comparisons: the plain reference put in the
program's place, computed one precision below what the configuration
states, at the cell's own size. Each must come out not correct.

- Encode cells: the reference analysis in float32 gives the side
  information of the blocks the check samples from the seed; the check's
  number `side_info_mismatch_pct` is read against the float64 reference.
- Decode cells: the program's streams of one folder (as the cell's set-up
  makes them) are decoded by the reference with each prediction sum in
  float32 (`--precision float32`), or with TF32 operands as well
  (`--precision tf32`); the check's number `samples_wrong` is read
  against the tracks.

    python3 benchmark/control.py --workload CELL --seeds N [N ...]

prints one JSON line a seed. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def encode_control(files: dict, seed: int, device: str) -> dict:
    import torch

    from benchmark import material
    from benchmark.entries import encode

    config, traffic = files["config"], files["traffic"]
    corpus = material.make_corpus(
        traffic["material"], traffic["corpus_tracks"],
        traffic["track_seconds"], config["format"]["sampling_rate"],
        traffic["folder_tracks"], seed, device)
    sample = encode.sample_blocks(config, traffic, corpus,
                                  range(len(corpus.tracks)), seed)
    ref = encode.reference_side_info(config, corpus, sample, device,
                                     torch.float64)
    low = encode.reference_side_info(config, corpus, sample, device,
                                     torch.float32)
    differ = sum(encode.side_info_differs(ref, j, low, j)
                 for j in range(len(sample)))
    return {"side_info_mismatch_pct": 100.0 * differ / len(sample),
            "blocks": len(sample)}


def decode_control(files: dict, seed: int, device: str, folder: int = 0,
                   precision: str = "float32") -> dict:
    import numpy as np
    import torch

    from benchmark import material
    from benchmark.entries import decode, encode
    from benchmark.reference import integer, stream

    config, traffic = files["config"], files["traffic"]
    f = config["format"]
    corpus = material.make_corpus(
        traffic["material"], traffic["corpus_tracks"],
        traffic["track_seconds"], f["sampling_rate"],
        traffic["folder_tracks"], seed, device)
    one = corpus._replace(folders=[corpus.folders[folder]])
    streams = decode.Program(config, traffic, device, one).streams
    tracks = corpus.folders[folder]
    parsed = stream.parse_streams(streams, config["layer_num_params"])
    if any(parsed.bad):
        raise RuntimeError(f"the program's streams do not read: {parsed.bad}")
    dev = torch.device(device)
    decoded = {}  # (stream, block) -> [C, n]
    largest = 0.0
    for n, g in parsed.groups.items():
        t = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
        layers = [tuple(t(v) for v in lay) for lay in encode.side_layers(
            g, slice(None), config["layer_num_params"])]
        x = integer.synthesize(
            t(g.residual), f["mid_side"], t(g.pprev), t(g.pcoef), layers,
            torch.float32,
            integer.tf32 if precision == "tf32" else None)
        largest = max(largest, integer.synthesize.largest_sum)
        for r, key in enumerate(parsed.members[n]):
            decoded[key] = x[r].cpu().numpy()
    wrong = 0
    for si, ti in enumerate(tracks):
        start = 0
        want = corpus.tracks[ti]
        for bi, (btype, n, _g, row) in enumerate(parsed.blocks[si]):
            part = want[:, start : start + n]
            if btype == stream.BLOCK_COMPRESS:
                got = decoded[(si, bi)]
            elif btype == stream.BLOCK_RAW:
                got = parsed.raw[row]
            else:
                got = np.zeros_like(part)
            wrong += int(np.count_nonzero(got != part))
            start += n
    return {"samples_wrong": wrong, "tracks": len(tracks),
            "precision": precision, "largest_prediction_sum": largest}


def main(argv=None) -> int:
    from benchmark import run

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--precision", choices=("float32", "tf32"),
                    default=None, help="the decode control's arithmetic "
                    "(default float32)")
    args = ap.parse_args(argv)
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    files = run.cell_files(bench, args.workload)
    fn = {"encode": encode_control,
          "decode": decode_control}[files["traffic"]["entry"]]
    kw = {}
    if args.precision:
        kw["precision"] = args.precision
    for seed in args.seeds:
        out = fn(files, seed, args.device, **kw)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
