"""Entry `learn_encode`: `entries/encode.py`'s program with the
configuration's `"learning": true`, so every batch of `encode_many` trains
its blocks' layer cascades between the two stage graphs (`-l`).

`correct` is decided by four numbers, each against its limit:
- `invalid_streams` and `lossless_failures`: `entries/encode.py`'s checks,
  run by its judge (its untrained side information check on one block is
  left out), limit 0;
- `learned_side_info_mismatch_pct`: of a sample of full blocks drawn from
  the seed, the share of (block, output) pairs whose block type or side
  information differs from the trained float64 reference's
  (`reference/training.py`). Training amplifies last bits over its
  iterations, so a sound run reads a share; a lower precision, a trainer
  cut short or no training at all reads a larger one;
- `learned_l1_excess_pct`: 100 x (the summed |integer residual| of the
  sample's compress blocks in the streams, over the reference's) - 1,
  over the pairs that both call compress: it stays continuous where a
  near-tie tips the side information either way, and an untrained or
  cut-short predictor leaves a larger residual.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import encode
from ..reference import analysis, stream
from ..reference import training as learned

NAMES = ("invalid_streams", "lossless_failures",
         "learned_side_info_mismatch_pct", "learned_l1_excess_pct")
TRAIN_COUNTERS = ("train_batches", "train_iterations", "train_row_iterations",
                  "train_active_row_iterations", "train_s")
CHUNK = 128  # blocks a chunk of the reference's layer fits


class Program(encode.Program):
    """The system under test: one encoder for the whole run, with the
    trainer's counters where the program has them."""

    def counters(self) -> dict:
        out = super().counters()
        for name in TRAIN_COUNTERS:
            value = getattr(self.enc, name, None)
            if value is not None:
                out[name] = value
        return out


def reference(config: dict, corpus, blocks, device: str,
              dtype=torch.float64) -> learned.Learned:
    """The trained reference's side information of full blocks [(track,
    block index)]: on the card in chunks of CHUNK blocks for the fits, the
    compress rows trained together."""
    f = config["format"]
    spb = f["num_samples_per_block"]
    x = np.stack([corpus.tracks[ti][:, b * spb : (b + 1) * spb]
                  for ti, b in blocks])
    out = learned.analyse(
        torch.from_numpy(x).to(device), config["layer_num_params"],
        config["ridge_terms"], f["bits_per_sample"], f["mid_side"], dtype,
        chunk=CHUNK)
    return learned.Learned(
        analysis.SideInfo(*(v.cpu() for v in out.side)),
        out.stops.cpu(), out.l1.cpu())


def compare(parsed, keys, bad, versions, sample, ref, n: int):
    """(pairs compared, pairs that differ, the streams' summed |residual|
    and the reference's over the pairs that both call compress) of the
    sampled blocks of every distinct output."""
    rowmap = {}
    for length, members in parsed.members.items():
        for r, key in enumerate(members):
            rowmap[key] = (length, r)
    index = {key: si for si, key in enumerate(keys)}
    compared = mismatched = 0
    got_l1 = want_l1 = 0.0
    for j, (ti, b) in enumerate(sample):
        for k in range(len(versions[ti])):
            si = index[(ti, k)]
            if bad[si] is not None:
                continue
            compared += 1
            btype = parsed.blocks[si][b][0]
            if btype != int(ref.side.block_type[j]):
                mismatched += 1
                continue
            if btype != stream.BLOCK_COMPRESS:
                continue
            length, r = rowmap[(si, b)]
            g = parsed.groups[length]
            mismatched += not all(
                np.array_equal(getattr(g, name)[r],
                               getattr(ref.side, name)[j].numpy())
                for name in encode.FIELDS)
            got_l1 += float(np.abs(g.residual[r].astype(np.int64)).sum())
            want_l1 += float(ref.l1[j].sum()) * n
    return compared, mismatched, got_l1, want_l1


def judge(config: dict, traffic: dict, corpus, outputs, seed: int,
          device: str) -> dict:
    """Judge the window's outputs [(track, bytes)]: the numbers of the
    checks, the verdict per output, and what the metric readers use."""
    base = encode.judge(config, dict(traffic, check={"analysis_blocks": 1}),
                        corpus, outputs, seed, device)
    tick = time.perf_counter()
    versions, _which = encode._distinct(outputs)
    sample = encode.sample_blocks(config, traffic, corpus, sorted(versions),
                                  seed)
    ref = reference(config, corpus, sample, device)
    compared, mismatched, got_l1, want_l1 = compare(
        base["parsed"], base["keys"], base["parsed"].bad, versions, sample,
        ref, config["format"]["num_samples_per_block"])
    numbers = dict(base["numbers"])
    del numbers["side_info_mismatch_pct"]
    numbers["learned_side_info_mismatch_pct"] = (
        100.0 * mismatched / max(compared, 1))
    numbers["learned_l1_excess_pct"] = (
        100.0 * (got_l1 / want_l1 - 1.0) if want_l1 > 0 else 0.0)
    times = dict(base["times"])
    del times["analysis_s"]
    times["learned_s"] = time.perf_counter() - tick
    stops = ref.stops[ref.side.block_type == stream.BLOCK_COMPRESS]
    return dict(base, numbers=numbers, times=times,
                compared_blocks=compared,
                reference_stops=stops.flatten().tolist())
