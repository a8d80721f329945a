"""Entry `exact_encode`: each folder of tracks goes through one long-lived
`DeviceExactEncoder` with `encode_many`, the Python API's pooled
byte-exact encode (the folder's full blocks share the card's fit
chunks, and the framing overlaps a worker thread's fits of later
chunks). The port's CLI (`--exact-device`) calls `encode_whole` one file
at a time, and the corpus tool runs the batched `TorchEncoder`: neither
is this path.

`correct` is decided by three numbers, each against its limit of 0:
- `invalid_streams` and `lossless_failures`: the stream and residual
  checks of `entries/encode.py`, run by its judge (whose check of the
  batched analysis's side information is run on one block and left out
  here: it judges another algorithm);
- `exact_block_mismatches`: of the first `check.blocks` blocks of
  `check.tracks` tracks drawn from the seed, the blocks of the window's
  outputs whose type, or whose side information (pre-emphasis, unit
  counts, shifts, quantized coefficients, Rice partitions and
  parameters), differs from what the upstream C encoder writes, as the
  plain strict-order reference (reference/exact.py) works it out from
  the track's start. With the residual, which `lossless_failures`
  checks, these fix the block's bytes. A block missing from a stream
  counts too.
Every distinct output of the window is judged; an output that fails any
check fails the run's verdict.
"""

from __future__ import annotations

import time

import numpy as np

from .. import roofline
from ..reference import exact, stream
from . import encode

NAMES = ("invalid_streams", "lossless_failures", "exact_block_mismatches")


class Program:
    """The system under test: one byte-exact encoder for the whole run."""

    def __init__(self, config: dict, traffic: dict, device: str, corpus):
        from linne_tpu_torch.exact.device_encoder import DeviceExactEncoder

        self.corpus = corpus
        self.enc = DeviceExactEncoder(device=device)
        self.enc.set_encode_parameter(encode.parameter(config))

    def inputs(self, folder):
        return ([self.corpus.tracks[i] for i in folder],
                [self.corpus.num_samples[i] for i in folder])

    def __call__(self, tracks, lengths):
        return self.enc.encode_many(tracks, lengths)

    def counters(self) -> dict:
        """The guard's counters, the framing's wait for fit rows and the
        host refits (where the program keeps them), the kernel libraries
        loaded, and each exact kernel's launches by shape under the key
        (kernel, *shape)."""
        from linne_tpu_torch.ops import _kernels, exact_serial

        e = self.enc
        out = {name: getattr(e, name) for name in (
            "guard_rows_total", "guard_rows_flagged",
            "guard_decisions_flagged", "fit_wait_s", "host_refit_rows")
            if hasattr(e, name)}
        out["kernel_libraries"] = len(_kernels._libs)
        for kernel, shapes in getattr(exact_serial, "LAUNCH_SHAPES",
                                      {}).items():
            for shape, count in shapes.items():
                out[(kernel,) + shape] = count
        return out

    def settled(self, before: dict, after: dict) -> bool:
        """Whether a pass over the corpus built or loaded no kernel and
        launched none at a shape not launched before."""
        return (after.keys() == before.keys() and after["kernel_libraries"]
                == before["kernel_libraries"])

    def close(self) -> None:
        self.enc = None


def sample_tracks(traffic: dict, tracks, seed: int) -> list:
    """The tracks whose first blocks the check compares, drawn from the
    seed."""
    tracks = sorted(tracks)
    rng = np.random.default_rng([int(seed) % (1 << 63), 0xE7AC7])
    take = min(traffic["check"]["tracks"], len(tracks))
    return [tracks[i] for i in
            sorted(rng.choice(len(tracks), size=take, replace=False))]


def same_block(block_type: int, field, ref) -> bool:
    """Whether a block of type `block_type`, whose side information
    `field(name)` gives by the names of exact.FIELDS, is the reference
    Block `ref`: the same type and, for a compressed block, every field
    equal."""
    return block_type == ref.block_type and (
        ref.block_type != stream.BLOCK_COMPRESS
        or all(np.array_equal(field(name), getattr(ref, name))
               for name in exact.FIELDS))


def block_mismatches(parsed, si: int, want) -> int:
    """Of the Blocks `want` (reference/exact.py), those that block for
    block differ from stream si's first blocks, or that it lacks."""
    blocks = parsed.blocks[si]
    bad = max(0, len(want) - len(blocks))
    for (block_type, n, _g, row), ref in zip(blocks, want):
        bad += not same_block(
            block_type, lambda name: getattr(parsed.groups[n], name)[row],
            ref)
    return bad


def judge(config: dict, traffic: dict, corpus, outputs, seed: int,
          device: str) -> dict:
    """Judge the window's outputs [(track, bytes)]: the numbers of the
    checks, the verdict per output, and what the metric readers use."""
    base = encode.judge(config, dict(traffic, check={"analysis_blocks": 1}),
                        corpus, outputs, seed, device)
    parsed, keys = base["parsed"], base["keys"]
    tick = time.perf_counter()
    f = config["format"]
    spb = f["num_samples_per_block"]
    picked = sample_tracks(traffic, {ti for ti, _k in keys}, seed)
    blocks = min([traffic["check"]["blocks"]]
                 + [corpus.num_samples[ti] // spb for ti in picked])
    ref = dict(zip(picked, exact.analyse_tracks(
        [corpus.tracks[ti] for ti in picked], blocks, config)
        if blocks else ()))
    bad = {}  # stream -> mismatching blocks
    for si, (ti, _k) in enumerate(keys):
        if ti in ref and parsed.bad[si] is None:
            bad[si] = block_mismatches(parsed, si, ref[ti])
    index = {key: si for si, key in enumerate(keys)}
    _versions, which = encode._distinct(outputs)
    verdict = [ok and not bad.get(index[key], 0)
               for ok, key in zip(base["verdict"], which)]
    numbers = dict(base["numbers"])
    del numbers["side_info_mismatch_pct"]
    numbers["exact_block_mismatches"] = int(sum(bad.values()))
    times = dict(base["times"])
    del times["analysis_s"]
    times["exact_s"] = time.perf_counter() - tick
    return dict(base, numbers=numbers, verdict=verdict, times=times)


# Each exact kernel's work a launch, from its launch shape (as
# exact_serial.LAUNCH_SHAPES keys it), by the functions of roofline.py:
# the autocorrelation of `segments` segments, the recursion of `segments`
# rows, the mean of `rows` rows over samples start..n, and the prediction
# of each unit's samples by its taps.
WORK = {
    "autocorr_serial": lambda nseg, ns, lags: roofline.autocorr_serial_work(
        nseg, ns, lags),
    "levinson_serial": lambda nseg, order: roofline.levinson_serial_work(
        nseg, order),
    "serial_abs_mean": lambda rows, _len, start, n:
        roofline.serial_abs_mean_work(rows, n - start),
    "chain_predict": lambda rows, n, units, taps: roofline.chain_predict_work(
        rows * units, n // units, taps),
}


def kernel_roofline(ctx: dict, kernel: str, names) -> float | None:
    """`kernel`'s share of its roofline in the traced window: the work of
    the launches the window tallied by shape, at the FP64 peak or the
    memory bandwidth, over the summed device seconds of the device
    functions `names` in the trace; nothing where the program keeps no
    tally or the trace holds none of them."""
    t = ctx["trace"]
    if t is None:
        return None
    secs = sum(t.kernel_s.get(name, 0.0) for name in names)
    launches = [(key[1:], count) for key, count in ctx["counters"].items()
                if isinstance(key, tuple) and key[0] == kernel and count]
    if not secs or not launches:
        return None
    ops = nbytes = 0.0
    for shape, count in launches:
        o, b = WORK[kernel](*shape)
        ops += count * o
        nbytes += count * b
    return roofline.share_pct(ops, roofline.FP64_FLOPS, nbytes, secs)
