"""Cold encodes of two checkouts of this repository, in alternating pairs:
the port's CLI (`-e -m 7`) on a 30 s and on a 180 s WAV (2 and 12 full
64-block batches), and its corpus tool (`encode_corpus -m 7`) on four
30 s WAVs (4 full 128-block batches), each in a fresh process, as a user
runs them: every process builds its encoder, loads the kernels and,
where the checkout has them, captures its stage graphs anew.

A run is `python -c` in the checkout's root. It initialises CUDA, then
times the entry point's `main()` (WAVs read, encoded, written; the card
synchronised after it); the whole process is timed from outside too. The
streams of the two checkouts must be byte-identical, run after run.

Usage (on a machine with a card):
  python -m linne_tpu_torch.tools.ab_cold --base DIR [--pairs 10]
      [--out FILE.json]
DIR is the other checkout (the parent commit, say, unpacked with
`git archive`); the checkout that holds this file is the change. Before
the pairs, each checkout runs each entry once untimed (its kernels are
built then). The summary gives each side's median and interquartile
range, the change/base ratio of the pairs' medians, and the pairs the
change won.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

from ..io.wav import write_wav

ROOT = pathlib.Path(__file__).resolve().parents[2]
RATE = 44100

# one run: CUDA up first, then the entry point's main() timed
_CHILD = """
import json, sys, time
import torch
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
main = __import__(sys.argv[1], fromlist=["main"]).main
t0 = time.perf_counter()
rc = main(sys.argv[2:])
torch.cuda.synchronize()
print(json.dumps({"rc": rc, "main_s": time.perf_counter() - t0}))
"""


def make_track(seconds: float, seed: int) -> np.ndarray:
    """Stereo 16-bit: two tones whose level moves, under noise."""
    rng = np.random.default_rng(seed)
    n = int(seconds * RATE)
    t = np.arange(n) / RATE
    level = 0.55 + 0.45 * np.sin(2 * np.pi * 0.13 * t)
    left = level * (7000 * np.sin(2 * np.pi * 220 * t)
                    + 2500 * np.sin(2 * np.pi * 1375 * t))
    left = left + rng.normal(0, 600, n)
    right = 0.7 * left + rng.normal(0, 500, n)
    return np.clip(np.round(np.stack([left, right])), -32768,
                   32767).astype(np.int32)


def run(checkout: pathlib.Path, module: str, args) -> dict:
    """One fresh process of `module`'s main(args) in `checkout`."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, module, *map(str, args)],
        cwd=checkout, capture_output=True, text=True)
    process_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"{module} in {checkout} exited "
                         f"{proc.returncode}:\n{proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    if out["rc"] != 0:
        raise SystemExit(f"{module} in {checkout} returned {out['rc']}")
    return {"main_s": out["main_s"], "process_s": process_s}


def outputs(path: pathlib.Path) -> dict:
    files = sorted(path.glob("*.lnn")) if path.is_dir() else [path]
    return {f.name: f.read_bytes() for f in files}


def summary(values) -> dict:
    q1, med, q3 = np.percentile(np.asarray(values), [25, 50, 75])
    return {"median": float(med), "q1": float(q1), "q3": float(q3)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m linne_tpu_torch.tools.ab_cold",
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--base", required=True, type=pathlib.Path)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    sides = {"base": args.base.resolve(), "change": ROOT}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(f"card: {card}")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        short, long_ = tmp / "short.wav", tmp / "long.wav"
        write_wav(str(short), make_track(30.0, 1), RATE, 16)
        write_wav(str(long_), make_track(180.0, 6), RATE, 16)
        corpus = tmp / "corpus"
        corpus.mkdir()
        for i in range(4):
            write_wav(str(corpus / f"track{i}.wav"), make_track(30.0, 2 + i),
                      RATE, 16)
        entries = {
            "cli_30s": ("linne_tpu_torch.cli",
                        lambda out: ["-e", "-m", "7", short,
                                     out / "out.lnn"]),
            "cli_180s": ("linne_tpu_torch.cli",
                         lambda out: ["-e", "-m", "7", long_,
                                      out / "out.lnn"]),
            "encode_corpus": ("linne_tpu_torch.tools.encode_corpus",
                              lambda out: [corpus, out, "-m", "7"]),
        }
        runs = {e: {s: [] for s in sides} for e in entries}
        streams = {}
        for turn in range(args.pairs + 1):  # turn 0 builds, untimed
            order = ("base", "change") if turn % 2 == 0 else ("change",
                                                               "base")
            for entry, (module, argv_of) in entries.items():
                for side in order:
                    out = tmp / f"{entry}_{side}"
                    out.mkdir(exist_ok=True)
                    got = run(sides[side], module, argv_of(out))
                    made = outputs(out if entry == "encode_corpus"
                                   else out / "out.lnn")
                    want = streams.setdefault(entry, made)
                    if made != want:
                        raise SystemExit(f"{entry}: {side}'s streams differ "
                                         "from the first run's")
                    if turn:
                        runs[entry][side].append(got)

    report = {"card": card, "pairs": args.pairs, "entries": {}}
    for entry, by_side in runs.items():
        rec = {"runs": by_side}
        for key in ("main_s", "process_s"):
            base = [r[key] for r in by_side["base"]]
            change = [r[key] for r in by_side["change"]]
            ratio = [c / b for c, b in zip(change, base)]
            rec[key] = {"base": summary(base), "change": summary(change),
                        "ratio": summary(ratio),
                        "change_won": int(sum(c < b for c, b in
                                              zip(change, base)))}
            print(f"{entry} {key}: base median "
                  f"{rec[key]['base']['median']:.4f} s (IQR "
                  f"{rec[key]['base']['q1']:.4f}-"
                  f"{rec[key]['base']['q3']:.4f}), change median "
                  f"{rec[key]['change']['median']:.4f} s (IQR "
                  f"{rec[key]['change']['q1']:.4f}-"
                  f"{rec[key]['change']['q3']:.4f}), change/base median "
                  f"ratio {rec[key]['ratio']['median']:.4f} (IQR "
                  f"{rec[key]['ratio']['q1']:.4f}-"
                  f"{rec[key]['ratio']['q3']:.4f}), change faster in "
                  f"{rec[key]['change_won']} of {args.pairs} pairs")
        report["entries"][entry] = rec
    print("streams byte-identical between the checkouts, every run")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
