"""Corpus-scale batch encoder: every full block of every track in one
device stream, optionally split over a device list.
Counterpart of tools/encode_corpus.py.

This is the throughput entry of the port (its CLI encodes one file):
`TorchEncoder.encode_many` batches full blocks across the tracks of one
format group, so the card always sees full batches, and `--devices`
splits each batch's rows over a device list (parallel/mesh.py); blocks
are independent, so the bytes equal the one-device encode's.

Usage:
  python -m linne_tpu_torch.tools.encode_corpus CORPUS OUT [-m MODE]
      [--device DEV | --devices LIST] [--batch-blocks 128]
  python -m linne_tpu_torch.tools.encode_corpus --selftest
      [--device DEV | --devices LIST]

`--device` defaults to cuda; `--devices cuda:0,cuda:1` names a list and
`--devices all` every card. Without a card both raise; the tool never
falls back to the CPU, which it uses only when asked (`--device cpu`).
The selftest checks the device against [device, device], or the list's
first entry against the list.
Tracks are found with rglob("*.wav") and written flat as <stem>.lnn, so
two tracks of one name in different folders overwrite each other, as in
the reference tool.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile
import time

import numpy as np

from ..codec.encoder import TorchEncoder
from ..codec.params import EncodeParameter
from ..constants import CH_PROCESS_MS, CH_PROCESS_NONE
from ..io.wav import read_wav, write_wav
from ..parallel.mesh import make_block_mesh


def encode_corpus(wavs, out_dir, mode, device=None, devices=None,
                  batch_blocks=128):
    """Encode a list of WAV paths into out_dir; returns (total_samples,
    total_seconds). Tracks are grouped by (channels, bps, rate), and each
    group is one encode_many call, so full blocks batch across tracks.
    `device`/`devices` as TorchEncoder takes them (default "cuda")."""
    groups = {}
    for w in wavs:
        fmt, samples = read_wav(str(w))
        key = (fmt.num_channels, fmt.bits_per_sample, fmt.sampling_rate)
        groups.setdefault(key, []).append((pathlib.Path(w), fmt, samples))

    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    total_samples = 0
    total_secs = 0.0
    for (nch, bps, rate), members in groups.items():
        # the default tail_mode ("auto"), as the reference tool's encoder
        enc = TorchEncoder(batch_blocks=batch_blocks, device=device,
                           devices=devices)
        enc.set_encode_parameter(EncodeParameter(
            num_channels=nch, bits_per_sample=bps, sampling_rate=rate,
            preset=mode,
            ch_process_method=(CH_PROCESS_MS if nch >= 2
                               else CH_PROCESS_NONE)))
        tracks = [[m[2][c] for c in range(nch)] for m in members]
        lengths = [m[1].num_samples for m in members]
        datas = enc.encode_many(tracks, lengths)
        for (w, fmt, _), data in zip(members, datas):
            (out_dir / (w.stem + ".lnn")).write_bytes(data)
            total_samples += fmt.num_samples * nch
            total_secs += fmt.num_samples / rate
    return total_samples, total_secs


def parse_devices(text: str):
    """--devices: "all" (every card) or a comma-separated list."""
    if text == "all":
        return make_block_mesh()
    return make_block_mesh([d.strip() for d in text.split(",")
                            if d.strip()])


def selftest(one, split) -> int:
    """Encode a synthetic corpus at mode 0 on the device `one` and assert
    every stream lossless under the host Decoder; encode it again over the
    device list `split` and assert the same bytes."""
    from ..codec.decoder import Decoder

    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory(prefix="linne_corpus_") as tmp_name:
        tmp = pathlib.Path(tmp_name)
        wavs = []
        for i in range(3):
            n = 10240 * (2 + i) + 777 * i
            sig = np.clip(rng.normal(0, 4000, (2, n)), -32768,
                          32767).astype(np.int32)
            p = tmp / f"t{i}.wav"
            write_wav(str(p), sig, 44100, 16)
            wavs.append(p)
        encode_corpus(wavs, tmp / "plain", mode=0, device=one)
        encode_corpus(wavs, tmp / "split", mode=0, devices=split,
                      batch_blocks=max(8, len(split)))
        for w in wavs:
            plain = (tmp / "plain" / (w.stem + ".lnn")).read_bytes()
            _, orig = read_wav(str(w))
            dec = Decoder().decode_whole(plain)
            if not all(np.array_equal(dec[c], orig[c]) for c in range(2)):
                raise AssertionError(f"{w.name}: not lossless")
            if (tmp / "split" / (w.stem + ".lnn")).read_bytes() != plain:
                raise AssertionError(
                    f"{w.name}: the device list's bytes differ")
    print(f"selftest OK ({one} against {[str(d) for d in split]})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m linne_tpu_torch.tools.encode_corpus",
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("corpus", nargs="?", help="directory of WAV files")
    ap.add_argument("out", nargs="?", help="output directory for .lnn files")
    ap.add_argument("-m", "--mode", type=int, default=0)
    where = ap.add_mutually_exclusive_group()
    where.add_argument("--device", default=None,
                       help="torch device of the encode (default cuda)")
    where.add_argument("--devices", default=None,
                       help="split each batch over a device list: "
                            "comma-separated, or 'all' for every card")
    ap.add_argument("--batch-blocks", type=int, default=128)
    ap.add_argument("--selftest", action="store_true")
    args = ap.parse_args(argv)

    # resolve the devices first: without a card this raises before any
    # file is read
    devices = parse_devices(args.devices) if args.devices else None
    device = None if devices else make_block_mesh([args.device or "cuda"])[0]
    if args.selftest:
        return (selftest(devices[0], devices) if devices
                else selftest(device, [device, device]))
    if not args.corpus or not args.out:
        print("corpus and out directories required", file=sys.stderr)
        return 1
    wavs = sorted(pathlib.Path(args.corpus).rglob("*.wav"))
    if not wavs:
        print("no .wav files found", file=sys.stderr)
        return 1

    t0 = time.perf_counter()
    nsamp, secs = encode_corpus(wavs, args.out, args.mode, device, devices,
                                args.batch_blocks)
    dt = time.perf_counter() - t0
    print(f"{len(wavs)} tracks, {secs:.1f}s audio in {dt:.2f}s "
          f"({secs/dt:.1f}x realtime, {nsamp/1e6/dt:.1f} Msamples/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
