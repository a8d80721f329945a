"""linne-compatible command-line codec on the PyTorch port.

Same flag surface as linne_tpu.cli (reference:
tools/linne_codec/linne_codec.c:15-33). `-e` runs the batched TorchEncoder
(on CUDA unless `--device` says otherwise), `-d` the host Decoder,
`--exact` the byte-exact host ExactEncoder. Learning (`-l`), AF refinement
(`-a N`), `--exact-device` and `--threads` are not ported yet: they exit
with code 2.

Usage:  python -m linne_tpu_torch.cli -e [-m 4] in.wav out.lnn
        python -m linne_tpu_torch.cli -d out.lnn restored.wav
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from linne_tpu.codec.params import DecoderConfig, EncodeParameter, EncoderConfig
from linne_tpu.constants import CH_PROCESS_MS, CH_PROCESS_NONE
from linne_tpu.format.header import FormatError
from linne_tpu.io.wav import read_wav, write_wav


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="linne_tpu_torch",
        description="LINNE lossless audio codec (PyTorch/CUDA port)")
    p.add_argument("-e", "--encode", action="store_true", help="Encode mode")
    p.add_argument("-d", "--decode", action="store_true", help="Decode mode")
    p.add_argument("-m", "--mode", type=int, default=0,
                   help="Compress mode: 0(fast) .. 7(high compression)")
    p.add_argument("-l", "--enable-learning", action="store_true",
                   help="Gradient-train the predictor (not ported yet)")
    p.add_argument("-a", "--auxiliary-function-iteration", type=int,
                   default=0, metavar="N",
                   help="Auxiliary-function method iterations (not ported "
                        "yet)")
    p.add_argument("-c", "--no-crc-check", action="store_true",
                   help="Do NOT check CRC16 when decoding")
    p.add_argument("--exact", action="store_true",
                   help="Use the bit-exact host encoder (byte-identical "
                        "with the reference C encoder)")
    p.add_argument("--exact-device", action="store_true",
                   help="Bit-exact encode with device fitting (not ported "
                        "yet)")
    p.add_argument("--threads", type=int, default=None, metavar="N",
                   help="Threaded exact encode (not ported yet)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the batched encoder (default "
                        "cuda)")
    p.add_argument("-V", "--verbose", action="store_true")
    p.add_argument("-v", "--version", action="store_true",
                   help="Show version information")
    p.add_argument("input", nargs="?")
    p.add_argument("output", nargs="?")
    return p


def _not_ported(args):
    """The name of the first requested feature this port lacks, or None."""
    if args.enable_learning:
        return "-l"
    if args.auxiliary_function_iteration:
        return "-a"
    if args.exact_device:
        return "--exact-device"
    if args.threads is not None:
        return "--threads"
    return None


def do_encode(args) -> int:
    fmt, samples = read_wav(args.input)
    param = EncodeParameter(
        num_channels=fmt.num_channels,
        bits_per_sample=fmt.bits_per_sample,
        sampling_rate=fmt.sampling_rate,
        preset=args.mode,
        ch_process_method=(CH_PROCESS_MS if fmt.num_channels >= 2
                           else CH_PROCESS_NONE),
    )

    def progress(done, total):  # per-block/batch progress like the C CLI
        print(f"progress... {100.0 * done / total:.2f}% \r", end="",
              flush=True)

    t0 = time.perf_counter()
    if args.exact:
        from linne_tpu.exact.encoder import ExactEncoder

        enc = ExactEncoder(EncoderConfig())
    else:
        from .codec.encoder import TorchEncoder

        enc = TorchEncoder(EncoderConfig(), device=args.device)
    enc.set_encode_parameter(param)
    data = enc.encode_whole(
        [samples[c] for c in range(fmt.num_channels)], fmt.num_samples,
        progress_cb=progress)
    dt = time.perf_counter() - t0
    with open(args.output, "wb") as f:
        f.write(data)
    in_size = os.path.getsize(args.input)
    print(f"finished: {in_size} -> {len(data)} "
          f"({100.0 * len(data) / in_size:6.2f} %)")
    if args.verbose:
        secs = fmt.num_samples / fmt.sampling_rate
        print(f"encode: {dt:.3f}s for {secs:.1f}s audio "
              f"({secs / dt:.1f}x realtime)")
    return 0


def do_decode(args) -> int:
    from linne_tpu.codec.decoder import Decoder

    with open(args.input, "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    dec = Decoder(DecoderConfig(check_crc=not args.no_crc_check))
    channels = dec.decode_whole(data)
    dt = time.perf_counter() - t0
    header = dec.header
    write_wav(args.output, channels, header.sampling_rate,
              header.bits_per_sample)
    if args.verbose:
        secs = header.num_samples / header.sampling_rate
        print(f"decode: {dt:.3f}s for {secs:.1f}s audio "
              f"({secs / dt:.1f}x realtime)")
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.version:
        from linne_tpu.constants import CODEC_VERSION

        print("LINNE -- LInear-predictive Neural Net Encoder "
              f"Version.{CODEC_VERSION} (linne_tpu_torch)")
        return 0
    if args.encode == args.decode or args.input is None or args.output is None:
        print("specify exactly one of -e (encode) / -d (decode) "
              "plus input and output files", file=sys.stderr)
        return 1
    missing = _not_ported(args)
    if missing is not None:
        print(f"error: {missing} is not ported yet", file=sys.stderr)
        return 2
    try:
        return do_encode(args) if args.encode else do_decode(args)
    except FileNotFoundError as e:
        print(f"error: {e.filename}: no such file", file=sys.stderr)
        return 1
    except FormatError as e:
        print(f"error: {args.input}: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
