"""Entry `encode`: each folder of tracks goes through one long-lived
`TorchEncoder(batch_blocks=...)` with `encode_many`, the corpus tool's call
for one format group.

`correct` is decided by three numbers, each against its limit:
- `invalid_streams`: window outputs that do not read as a stream of the
  track (header, block frames, CRC-16, payloads), limit 0;
- `lossless_failures`: blocks of those streams that do not carry the
  track's samples bit for bit (a compress block's residual is worked out
  from the samples and the block's own side information, in the
  encoder's direction, and must equal the residual the block carries;
  raw blocks must hold the samples, silent blocks zeros), limit 0;
- `side_info_mismatch_pct`: of a sample of full blocks drawn from the
  seed, the share whose block type or side information (pre-emphasis,
  unit counts, shifts, quantized coefficients, Rice partitions and
  parameters) differs from the float64 reference analysis's
  (reference/analysis.py). Rounding can tip a near-tie either way, so a
  sound run reads a small share; a lower precision reads a large one.
Every output of the window is judged: outputs equal to a track's first
output share its verdict, any other is read and judged in full. Tail
blocks (shorter than a block) are framed by the program's byte-exact host
encoder, another algorithm: they are held to losslessness only.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..reference import analysis, integer, stream

NAMES = ("invalid_streams", "lossless_failures", "side_info_mismatch_pct")
FIELDS = ("pprev", "pcoef", "log2u", "rshift", "coefs", "porder", "k2")


def parameter(config: dict):
    from linne_tpu_torch.codec.params import EncodeParameter

    f = config["format"]
    return EncodeParameter(
        num_channels=f["num_channels"], bits_per_sample=f["bits_per_sample"],
        sampling_rate=f["sampling_rate"],
        num_samples_per_block=f["num_samples_per_block"],
        preset=config["preset"], ch_process_method=1 if f["mid_side"] else 0,
        num_afmethod_iterations=config["afmethod_iterations"],
        enable_learning=config["learning"])


class Program:
    """The system under test: one encoder for the whole run."""

    def __init__(self, config: dict, traffic: dict, device: str, corpus):
        from linne_tpu_torch.codec.encoder import TorchEncoder

        self.corpus = corpus
        self.enc = TorchEncoder(batch_blocks=traffic["batch_blocks"],
                                device=device)
        self.enc.set_encode_parameter(parameter(config))

    def inputs(self, folder):
        return ([self.corpus.tracks[i] for i in folder],
                [self.corpus.num_samples[i] for i in folder])

    def __call__(self, tracks, lengths):
        return self.enc.encode_many(tracks, lengths)

    def counters(self) -> dict:
        g = list(self.enc._graphs.values())
        return {
            "graph_eager_runs": sum(x.eager_runs for x in g),
            "graph_captures": sum(x.captures for x in g),
            "graph_replays": sum(x.replays for x in g),
            "bytes_to_host": self.enc.bytes_to_host,
            "overflow_rows": self.enc.overflow_rows,
            "batches": len(self.enc.batch_widths),
        }

    def settled(self, before: dict, after: dict) -> bool:
        """Whether a pass over the corpus ran without an eager stage run
        or a capture: every shape of the traffic replays a graph."""
        return (after["graph_eager_runs"] == before["graph_eager_runs"]
                and after["graph_captures"] == before["graph_captures"])

    def close(self) -> None:
        self.enc = None


def _distinct(outputs):
    """{track: [distinct outputs, first seen first]} and, for every window
    output, the index of its version: [(track, version)]."""
    versions = {}
    which = []
    for ti, data in outputs:
        vs = versions.setdefault(ti, [])
        for k, v in enumerate(vs):
            if v == data:
                which.append((ti, k))
                break
        else:
            vs.append(data)
            which.append((ti, len(vs) - 1))
    return versions, which


def side_layers(g, rows, orders):
    """(coefs, log2u, rshift) of each layer of rows `rows` of a parsed
    CompressGroup, the layers in the encoder's order."""
    out = []
    col = 0
    for li, order in enumerate(orders):
        out.append((g.coefs[rows, :, col : col + order], g.log2u[rows, :, li],
                    g.rshift[rows, :, li]))
        col += order
    return out


def judge(config: dict, traffic: dict, corpus, outputs, seed: int,
          device: str) -> dict:
    """Judge the window's outputs [(track, bytes)]; returns the check's
    numbers, the verdict per output, and what the metric readers use."""
    f = config["format"]
    orders = config["layer_num_params"]
    spb = f["num_samples_per_block"]
    nch = f["num_channels"]
    versions, which = _distinct(outputs)
    keys = [(ti, k) for ti in sorted(versions)
            for k in range(len(versions[ti]))]
    streams = [versions[ti][k] for ti, k in keys]
    tick = time.perf_counter()
    parsed = stream.parse_streams(streams, orders)
    times = {"parse_s": time.perf_counter() - tick}
    bad = list(parsed.bad)
    for si, (ti, _k) in enumerate(keys):
        h = parsed.headers[si]
        if h is not None and bad[si] is None and (
                h.num_samples != corpus.num_samples[ti]
                or h.num_channels != nch
                or h.sampling_rate != f["sampling_rate"]
                or h.bits_per_sample != f["bits_per_sample"]
                or h.num_samples_per_block != spb
                or h.preset != config["preset"]
                or h.ch_process_method != (1 if f["mid_side"] else 0)):
            bad[si] = "header does not describe the track"

    # losslessness, block by block
    lossy = np.zeros(len(streams), np.int64)
    for si, (ti, _k) in enumerate(keys):
        if bad[si] is not None:
            continue
        start = 0
        for btype, n, _g, row in parsed.blocks[si]:
            if btype == stream.BLOCK_RAW:
                if not np.array_equal(parsed.raw[row],
                                      corpus.tracks[ti][:, start : start + n]):
                    lossy[si] += 1
            elif btype == stream.BLOCK_SILENT:
                if np.any(corpus.tracks[ti][:, start : start + n]):
                    lossy[si] += 1
            start += n
    dev = torch.device(device)
    starts = {}  # (stream, block) -> its first sample in the track
    for si in range(len(keys)):
        pos = 0
        for bi, (_t, bn, _g, _r) in enumerate(parsed.blocks[si]):
            starts[(si, bi)] = pos
            pos += bn
    for n, g in parsed.groups.items():
        members = parsed.members[n]
        step = 256
        for a in range(0, len(members), step):
            rows = np.arange(a, min(a + step, len(members)))
            samples = np.stack([
                corpus.tracks[keys[si][0]][:, starts[(si, bi)] :
                                           starts[(si, bi)] + n]
                for si, bi in (members[r] for r in rows)])
            t = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            res = integer.residual_of(
                t(samples).long(), f["mid_side"], t(g.pprev[rows]),
                t(g.pcoef[rows]),
                [tuple(t(v) for v in lay)
                 for lay in side_layers(g, rows, orders)])
            ok = (res == t(g.residual[rows])).flatten(1).all(-1).cpu().numpy()
            for r in rows[~ok]:
                lossy[members[r][0]] += 1

    times["lossless_s"] = time.perf_counter() - tick - times["parse_s"]
    # side information of a seeded sample of full blocks
    sample = sample_blocks(config, traffic, corpus, sorted(versions), seed)
    ref = reference_side_info(config, corpus, sample, device, torch.float64)
    compared = mismatched = 0
    rowmap = {}
    for n, members in parsed.members.items():
        for r, key in enumerate(members):
            rowmap[key] = (n, r)
    index = {key: si for si, key in enumerate(keys)}
    for j, (ti, b) in enumerate(sample):
        for k in range(len(versions[ti])):
            si = index[(ti, k)]
            if bad[si] is not None:
                continue
            compared += 1
            btype = parsed.blocks[si][b][0]
            if btype != int(ref.block_type[j]):
                mismatched += 1
                continue
            if btype != stream.BLOCK_COMPRESS:
                continue
            n, r = rowmap[(si, b)]
            g = parsed.groups[n]
            same = all(np.array_equal(getattr(g, name)[r],
                                      getattr(ref, name)[j].numpy())
                       for name in FIELDS)
            mismatched += not same
    times["analysis_s"] = (time.perf_counter() - tick - times["parse_s"]
                           - times["lossless_s"])
    verdict = [bad[index[key]] is None and lossy[index[key]] == 0
               for key in which]
    numbers = {
        "invalid_streams": sum(
            1 for key in which if bad[index[key]] is not None),
        "lossless_failures": int(sum(lossy[index[key]] for key in which)),
        "side_info_mismatch_pct": 100.0 * mismatched / max(compared, 1),
    }
    kinds = {"compress": 0, "silent": 0, "raw": 0}
    for si, (_ti, k) in enumerate(keys):
        for btype, *_ in (parsed.blocks[si] if k == 0 else ()):
            kinds[("compress", "silent", "raw")[btype]] += 1
    return {"numbers": numbers, "verdict": verdict, "parsed": parsed,
            "block_types": kinds,
            "keys": keys, "bad": [b for b in bad if b][:3],
            "compared_blocks": compared, "times": times}


def sample_blocks(config: dict, traffic: dict, corpus, tracks,
                  seed: int) -> list:
    """The full blocks [(track, block index)] whose side information the
    check compares: `analysis_blocks` of the tracks' full blocks, drawn
    from the seed."""
    spb = config["format"]["num_samples_per_block"]
    full = [(ti, b) for ti in tracks
            for b in range(corpus.num_samples[ti] // spb)]
    rng = np.random.default_rng([int(seed) % (1 << 63), 0x5EED])
    take = min(traffic["check"]["analysis_blocks"], len(full))
    pick = sorted(rng.choice(len(full), size=take, replace=False).tolist())
    return [full[i] for i in pick]


def side_info_differs(a, i: int, b, j: int) -> bool:
    """Whether block i of side information `a` and block j of `b` (both
    SideInfo) differ in type or, for a compress block, in any field."""
    if int(a.block_type[i]) != int(b.block_type[j]):
        return True
    if int(a.block_type[i]) != stream.BLOCK_COMPRESS:
        return False
    return not all(torch.equal(getattr(a, f)[i], getattr(b, f)[j])
                   for f in FIELDS)


def reference_side_info(config: dict, corpus, blocks, device: str,
                        dtype=torch.float64):
    """The reference analysis's side information of full blocks
    [(track, block index)], in chunks of 128 blocks."""
    f = config["format"]
    spb = f["num_samples_per_block"]
    parts = []
    for a in range(0, len(blocks), 128):
        x = np.stack([corpus.tracks[ti][:, b * spb : (b + 1) * spb]
                      for ti, b in blocks[a : a + 128]])
        side = analysis.analyse(
            torch.from_numpy(x).to(device), config["layer_num_params"],
            config["ridge_terms"], f["bits_per_sample"], f["mid_side"], dtype)
        parts.append(analysis.SideInfo(*(v.cpu() for v in side)))
    return analysis.SideInfo(*(torch.cat(v) for v in zip(*parts)))


def unit_rows(parsed, orders, times, length=None) -> list:
    """(n, order, units) of every prediction (or synthesis) row of the
    compress blocks of parsed streams: a block's channels and layers,
    `times[stream]` times each; only blocks of `length` samples where it
    is given."""
    rows = []
    for si, blocks in enumerate(parsed.blocks):
        if not times.get(si) or parsed.bad[si] is not None:
            continue
        for btype, n, gkey, r in blocks:
            if btype != stream.BLOCK_COMPRESS or (length and n != length):
                continue
            log2u = parsed.groups[gkey].log2u[r]
            rows.extend([(n, order, 1 << int(log2u[ch, li]))
                         for ch in range(log2u.shape[0])
                         for li, order in enumerate(orders)] * times[si])
    return rows


def predict_rows(config: dict, judged: dict, counts: dict) -> list:
    """The prediction rows the window's full compress blocks need, from
    each track's first output's side information, as often as the track
    was encoded in the window."""
    times = {si: counts.get(ti, 0) for si, (ti, k) in
             enumerate(judged["keys"]) if k == 0}
    return unit_rows(judged["parsed"], config["layer_num_params"], times,
                     config["format"]["num_samples_per_block"])
