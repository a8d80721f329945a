"""The benchmark's audio: a corpus of stereo 16-bit tracks made from a seed.

The recipe follows the port's bench material (`make_signal`: detuned
harmonic partials over a filtered noise floor, scaled and rounded to
16 bits) and widens it so that a corpus holds what music holds: each
track has its own fundamental, partial count and decay, noise level and
colour, inter-channel correlation and amplitude envelope; some tracks
start or end in digital silence (silent blocks) and some carry a stretch
of loud broadband noise (raw blocks).

Every seed gets the same set of tracks: the traffic file's ranges are
cut into as many strata as there are tracks, and each track takes one
stratum of each parameter, shuffled by a fixed design seed. The run's
seed then jitters each value within a few percent, draws the phases and
every noise sample, and shuffles the tracks into folders. So two seeds
cost the same work in another order and on other samples.

The signal is made on the device in a few large calls (a
`torch.Generator` seeded from the run's seed) and copied to the host
once.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch

_DESIGN_SEED = 0x11AE


class Corpus(NamedTuple):
    tracks: List[np.ndarray]     # [channels, samples] int32, one a track
    num_samples: List[int]
    folders: List[List[int]]     # track indices, one list a folder
    bits_per_sample: int


def _strata(rng: np.random.Generator, count: int, lo: float, hi: float,
            log: bool = False) -> np.ndarray:
    """One value from each of `count` equal strata of [lo, hi], shuffled."""
    q = (np.arange(count) + 0.5) / count
    v = (np.exp(np.log(lo) + q * (np.log(hi) - np.log(lo))) if log
         else lo + q * (hi - lo))
    return v[rng.permutation(count)]


def design(material: dict, count: int) -> dict:
    """The corpus's fixed set of track parameters (independent of the run's
    seed): one array of `count` values a parameter."""
    rng = np.random.default_rng(_DESIGN_SEED)
    m = material
    d = {
        "f0": _strata(rng, count, *m["fundamental_hz"], log=True),
        "partials": np.round(_strata(rng, count, *m["partials"])).astype(int),
        "decay": _strata(rng, count, *m["partial_decay"]),
        "detune": _strata(rng, count, *m["detune_hz"]),
        "noise": _strata(rng, count, *m["noise_level"], log=True),
        "colour": _strata(rng, count, *m["noise_colour_samples"], log=True),
        "corr": _strata(rng, count, *m["channel_correlation"]),
        "tremolo_hz": _strata(rng, count, *m["tremolo_hz"], log=True),
        "tremolo_depth": _strata(rng, count, *m["tremolo_depth"]),
        "peak": _strata(rng, count, *m["peak"]),
    }
    # silence and noise bursts go to fixed tracks with fixed lengths
    kinds = np.zeros(count, int)  # 0 none, 1 leading, 2 trailing silence
    order = rng.permutation(count)
    ns = min(m["silent_tracks"], count)
    kinds[order[: ns // 2]] = 1
    kinds[order[ns // 2 : ns]] = 2
    d["silence_kind"] = kinds
    d["silence_s"] = np.zeros(count)
    d["silence_s"][order[:ns]] = _strata(rng, ns, *m["silence_seconds"])
    nb = min(m["burst_tracks"], count - ns)
    burst = order[ns : ns + nb]
    d["burst_s"] = np.zeros(count)
    d["burst_s"][burst] = _strata(rng, nb, *m["burst_seconds"])
    return d


def make_corpus(material: dict, count: int, seconds: float, rate: int,
                folder_tracks: int, seed: int, device) -> Corpus:
    """`count` tracks of `seconds` each, in folders of `folder_tracks`."""
    d = design(material, count)
    n = int(round(seconds * rate))
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (1 << 63))
    f64 = torch.float64
    jitter = 1.0 + material["jitter"] * (
        2.0 * torch.rand(count, 4, generator=g, device=dev, dtype=f64) - 1.0)
    kmax = int(d["partials"].max())
    phases = 2 * math.pi * torch.rand(count, 2, kmax, generator=g,
                                      device=dev, dtype=f64)
    noise = torch.randn(count, 3, n + 64, generator=g, device=dev, dtype=f64)
    burst = 2.0 * torch.rand(count, 2, n, generator=g, device=dev,
                             dtype=f64) - 1.0
    where = torch.rand(count, generator=g, device=dev, dtype=f64)
    perm = torch.randperm(count, generator=g, device=dev).cpu().numpy()
    t = torch.arange(n, device=dev, dtype=f64) / rate
    full = float((1 << 15) - 1)
    out = torch.empty(count, 2, n, dtype=torch.int32, device=dev)
    taps = torch.arange(32, device=dev, dtype=f64)
    for i in range(count):
        j = jitter[i]
        f0 = float(d["f0"][i]) * j[0]
        k = torch.arange(1, int(d["partials"][i]) + 1, device=dev, dtype=f64)
        amp = k ** -float(d["decay"][i])
        freqs = f0 * k
        freqs = freqs[freqs < 0.45 * rate]
        m = freqs.numel()
        arg = 2 * math.pi * freqs[:, None] * t[None, :]
        left = (amp[:m, None] * torch.sin(arg + phases[i, 0, :m, None])).sum(0)
        right = (amp[:m, None] * torch.sin(
            arg + 2 * math.pi * float(d["detune"][i]) * t[None, :]
            + phases[i, 1, :m, None])).sum(0)
        tonal = torch.stack([left, right]) / amp.sum()
        # coloured noise: an exponential kernel of the track's length,
        # scaled to unit gain in power
        kern = torch.exp(-taps / (float(d["colour"][i]) * j[1]))
        kern = (kern / kern.norm()).tolist()
        coloured = torch.zeros(3, n, device=dev, dtype=f64)
        for m, c in enumerate(kern):
            coloured += c * noise[i, :, 31 - m : 31 - m + n]
        rho = float(d["corr"][i])
        nl = coloured[0]
        nr = rho * coloured[0] + math.sqrt(1 - rho * rho) * coloured[1]
        level = float(d["noise"][i]) * j[2]
        env = 1.0 - float(d["tremolo_depth"][i]) * 0.5 * (1.0 - torch.cos(
            2 * math.pi * float(d["tremolo_hz"][i]) * t))
        fade = torch.clamp(torch.minimum(t, t[-1] - t) / 0.05, max=1.0)
        sig = (float(d["peak"][i]) * j[3] * full * tonal * env * fade
               + level * torch.stack([nl, nr]))
        sb = int(round(float(d["burst_s"][i]) * rate))
        if sb:
            at = int(float(where[i]) * (n - sb))
            sig[:, at : at + sb] = full * burst[i, :, at : at + sb]
        ss = int(round(float(d["silence_s"][i]) * rate))
        if d["silence_kind"][i] == 1:
            sig[:, :ss] = 0.0
        elif d["silence_kind"][i] == 2:
            sig[:, n - ss :] = 0.0
        out[i] = torch.clamp(torch.round(sig), -full - 1, full).to(torch.int32)
    host = out.cpu().numpy()
    tracks = [host[int(p)] for p in perm]
    folders = [list(range(s, min(s + folder_tracks, count)))
               for s in range(0, count, folder_tracks)]
    return Corpus(tracks, [n] * count, folders, 16)
