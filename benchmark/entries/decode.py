"""Entry `decode`: the corpus is encoded once in set-up by the port's
`TorchEncoder` (the configuration's preset, `batch_blocks` of the traffic);
each folder of those streams then goes through one long-lived
`TorchDecoder` with `decode_many`.

`correct` is decided by one number against its limit: `samples_wrong`,
the samples of the window's outputs that differ from the tracks the
benchmark made, limit 0. Every output of the window is compared.
The streams come from the program's encoder, so a lossy encoder fails
this cell too; its streams are not judged here (the encode cells judge
them).
"""

from __future__ import annotations

import gc

import numpy as np

from ..reference import stream
from .encode import parameter, unit_rows

NAMES = ("samples_wrong",)


class Program:
    """The system under test: the decoder, and the streams it decodes."""

    def __init__(self, config: dict, traffic: dict, device: str, corpus):
        from linne_tpu_torch.codec.encoder import TorchEncoder
        from linne_tpu_torch.codec.torch_decoder import TorchDecoder

        enc = TorchEncoder(batch_blocks=traffic["batch_blocks"],
                           device=device)
        enc.set_encode_parameter(parameter(config))
        self.streams = []
        for folder in corpus.folders:
            self.streams.extend(enc.encode_many(
                [corpus.tracks[i] for i in folder],
                [corpus.num_samples[i] for i in folder]))
        del enc
        gc.collect()
        self.dec = TorchDecoder(device=device)

    def inputs(self, folder):
        return ([self.streams[i] for i in folder],)

    def __call__(self, streams):
        return self.dec.decode_many(streams)

    def counters(self) -> dict:
        from linne_tpu_torch.ops import synthesis

        return {"bytes_up": self.dec.bytes_up,
                "bytes_down": self.dec.bytes_down,
                "flagged_rows": self.dec.flagged_rows,
                "synthesize_rows_launches": synthesis.KERNEL_LAUNCHES}

    def settled(self, before: dict, after: dict) -> bool:
        return True

    def close(self) -> None:
        self.dec = None


def judge(config: dict, traffic: dict, corpus, outputs, seed: int,
          device: str) -> dict:
    """outputs: [(track, decoded channels)]."""
    wrong = []
    for ti, chans in outputs:
        want = corpus.tracks[ti]
        try:
            got = np.stack([np.asarray(c) for c in chans])
        except ValueError:
            wrong.append(want.size)
            continue
        if got.shape != want.shape:
            wrong.append(want.size)
        else:
            wrong.append(int(np.count_nonzero(got != want)))
    return {"numbers": {"samples_wrong": int(sum(wrong))},
            "verdict": [w == 0 for w in wrong], "bad": []}


def synthesis_rows(config: dict, streams, counts: dict) -> list:
    """The synthesis rows the window's decodes need: each compress block's
    channels and layers, read from the streams, as often as the track was
    decoded in the window."""
    orders = config["layer_num_params"]
    return unit_rows(stream.parse_streams(streams, orders), orders, counts)
