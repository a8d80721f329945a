"""The port's corpus encode tool (linne_tpu_torch/tools/encode_corpus.py)
against the JAX package's tools/encode_corpus.py: the same files, byte for
byte, on a corpus of three format groups.

Both encoders analyze in float64 on the CPU, so equal bytes are expected,
not a tolerance. The JAX tool is loaded by path and run once per module
(its compile dominates).
"""

import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import REPO_ROOT
from linne_tpu_torch.codec.decoder import Decoder
from linne_tpu_torch.io.wav import read_wav, write_wav
from linne_tpu_torch.tools import encode_corpus as tool

MODE = 7
SPB = 10240  # EncodeParameter's default block, which both tools take

# (name, channels, bps, rate, samples): three format groups, 2-3 blocks a
# track; t1 and m1 end in a partial tail (the host ExactEncoder's, under
# the default tail_mode on both sides)
_TRACKS = [
    ("s0", 2, 16, 44100, 2 * SPB),
    ("t1", 2, 16, 44100, SPB + 3001),
    ("m0", 1, 24, 48000, 2 * SPB),
    ("m1", 1, 24, 48000, 2 * SPB + 1500),
    ("w0", 2, 16, 48000, 3 * SPB),
]


def _track(nch, bps, rate, n, seed):
    rng = np.random.default_rng(seed)
    if seed == 1:
        # t1: a tail whose bytes differ between the host encoder and the
        # batched stages (tail_mode "host" against "device"), so that the
        # comparison sees which one the tool took
        t = np.arange(n)
        sig = (9000 * np.sin(2 * np.pi * 220 * t / 44100)
               + 3000 * np.sin(2 * np.pi * 1234 * t / 44100)
               + np.random.default_rng(3).normal(0, 200, (2, n)))
        return np.clip(np.round(sig), -32768, 32767).astype(np.int32)
    t = np.arange(n) / rate
    peak = (1 << (bps - 1)) - 1
    rows = [0.4 * peak * np.sin(2 * np.pi * (220 + 37 * c + seed) * t)
            + rng.normal(0, peak / 300, n) for c in range(nch)]
    return np.clip(np.round(np.stack(rows)), -peak - 1, peak).astype(np.int32)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    for seed, (name, nch, bps, rate, n) in enumerate(_TRACKS):
        sub = root / ("sub" if seed % 2 else "")  # rglob reaches subfolders
        sub.mkdir(exist_ok=True)
        write_wav(str(sub / f"{name}.wav"), _track(nch, bps, rate, n, seed),
                  rate, bps)
    return root


@pytest.fixture(scope="module")
def jax_files(corpus, tmp_path_factory):
    """The JAX tool's encode_corpus bytes, by file name."""
    spec = importlib.util.spec_from_file_location(
        "jax_encode_corpus", REPO_ROOT / "tools" / "encode_corpus.py")
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    out = tmp_path_factory.mktemp("jax_out")
    jax_tool.encode_corpus(sorted(corpus.rglob("*.wav")), out, MODE)
    return {p.name: p.read_bytes() for p in out.glob("*.lnn")}


@pytest.fixture
def one_torch_thread():
    """One intra-op thread per test: the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _files(out):
    return {p.name: p.read_bytes() for p in pathlib.Path(out).glob("*.lnn")}


@pytest.mark.parametrize("where", [["--device", "cpu"],
                                   ["--devices", "cpu,cpu"],
                                   ["--devices", "cpu,cpu,cpu",
                                    "--batch-blocks", "4"]])
def test_tool_matches_jax_tool(corpus, jax_files, tmp_path, where,
                               one_torch_thread, capsys):
    """The port's tool, on one device or a device list, writes the JAX
    tool's files byte for byte, and each decodes losslessly."""
    out = tmp_path / "out"
    assert tool.main([str(corpus), str(out), "-m", str(MODE), *where]) == 0
    assert "5 tracks" in capsys.readouterr().out
    got = _files(out)
    assert sorted(got) == sorted(f"{t[0]}.lnn" for t in _TRACKS)
    assert got == jax_files
    for wav in corpus.rglob("*.wav"):
        _, orig = read_wav(str(wav))
        dec = Decoder().decode_whole(got[wav.stem + ".lnn"])
        assert all(np.array_equal(d, o) for d, o in zip(dec, orig))


def test_selftest_on_cpu():
    """`python -m ... --selftest --device cpu` exits 0."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "PYTHONSTARTUP")}
    env["OMP_NUM_THREADS"] = "1"  # the test workers share the cores
    r = subprocess.run(
        [sys.executable, "-m", "linne_tpu_torch.tools.encode_corpus",
         "--selftest", "--device", "cpu"],
        cwd=REPO_ROOT, capture_output=True, text=True, env=env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("selftest OK")


@pytest.mark.parametrize("argv", [[], ["--devices", "all"],
                                  ["--devices", "cuda:0,cuda:0"]])
def test_no_card_raises_before_encoding(corpus, tmp_path, monkeypatch, argv):
    """Without a card, and without --device cpu, the tool raises and
    encodes nothing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    monkeypatch.setattr(tool, "encode_corpus",
                        lambda *a, **k: calls.append(a))
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tool.main([str(corpus), str(out), *argv])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tool.main(["--selftest", *argv])
    assert not calls and not out.exists()


def test_empty_corpus_and_missing_arguments(tmp_path, capsys):
    assert tool.main([str(tmp_path), str(tmp_path / "o"), "--device",
                      "cpu"]) == 1
    assert tool.main(["--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "no .wav files found" in err and "required" in err
