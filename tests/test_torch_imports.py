"""The PyTorch port imports no jax and nothing of the JAX package, builds
nothing on import, and sets its dtype policy."""

import ast
import os
import subprocess
import sys
import textwrap

from conftest import REPO_ROOT

_PORT = REPO_ROOT / "linne_tpu_torch"

# every module of the port, packages included
_MODULES = sorted(
    ".".join(p.relative_to(REPO_ROOT).with_suffix("").parts)
    .removesuffix(".__init__")
    for p in _PORT.rglob("*.py"))


def _run(code):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "PYTHONSTARTUP")}  # no sitecustomize
    env["OMP_NUM_THREADS"] = "1"  # the test workers share the cores
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env)


def test_port_imports_no_jax():
    code = (
        "import sys, importlib; "
        f"sys.path.insert(0, {str(REPO_ROOT)!r}); "
        f"[importlib.import_module(m) for m in {_MODULES!r}]; "
        "assert 'jax' not in sys.modules, 'the port imported jax'; "
        "import torch; "
        "assert not torch.backends.cuda.matmul.allow_tf32; "
        "assert not torch.backends.cudnn.allow_tf32; "
        "from linne_tpu_torch.ops import ANALYSIS_DTYPE; "
        "assert ANALYSIS_DTYPE == torch.float64; "
        "print('ok')")
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_importing_kernels_builds_nothing(tmp_path):
    """The kernel library is built at first use, never on import."""
    from linne_tpu_torch.ops import _kernels

    before = set(_kernels._BUILD_DIR.glob("*")) if _kernels._BUILD_DIR.exists() else set()
    r = _run(
        "import sys; "
        f"sys.path.insert(0, {str(REPO_ROOT)!r}); "
        "import linne_tpu_torch.ops.synthesis, linne_tpu_torch.ops._kernels, "
        "linne_tpu_torch.ops.exact_serial, linne_tpu_torch.ops.exact_device, "
        "linne_tpu_torch.exact.device_encoder; "
        "print('ok')")
    assert r.returncode == 0, r.stderr
    after = set(_kernels._BUILD_DIR.glob("*")) if _kernels._BUILD_DIR.exists() else set()
    assert after == before


def test_convert_roundtrip():
    import numpy as np
    import torch

    from linne_tpu_torch.convert import to_numpy, to_torch

    tree = {"a": (np.arange(4, dtype=np.int32), [np.ones((2, 2))]),
            "b": np.uint32(7), "c": "keep"}
    t = to_torch(tree)
    assert isinstance(t["a"], tuple) and isinstance(t["a"][1], list)
    assert t["a"][0].dtype == torch.int32
    assert t["a"][1][0].dtype == torch.float64
    assert t["c"] == "keep"
    back = to_numpy(t)
    assert back["a"][0].dtype == np.int32
    assert np.array_equal(back["a"][1][0], np.ones((2, 2)))
    assert back["b"] == 7


def _port_sources():
    # chip_smoke.py imports tests/torch_hostile_streams.py on the card
    return sorted(_PORT.rglob("*.py")) + [
        REPO_ROOT / "chip_smoke.py",
        REPO_ROOT / "tests" / "torch_hostile_streams.py"]


def _imported_names(tree):
    """Every module name an import statement names, at any depth of the
    tree (function bodies included). Relative imports are skipped: they
    resolve inside the package that holds them."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_port_sources_import_nothing_of_linne_tpu():
    """No file of the port, and not chip_smoke.py or the test helper it
    imports, imports `linne_tpu` or jax in any form; `linne_tpu_torch` is
    allowed."""
    bad = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for lineno, name in _imported_names(tree):
            if name.split(".")[0] in ("linne_tpu", "jax", "jaxlib"):
                bad.append(f"{path.relative_to(REPO_ROOT)}:{lineno}: {name}")
    assert not bad, "imports of the JAX package or jax:\n" + "\n".join(bad)


def test_ast_scan_sees_lazy_imports():
    """The scan sees imports inside functions and both import forms."""
    tree = ast.parse(textwrap.dedent("""
        import linne_tpu_torch.native
        def f():
            from linne_tpu.exact import encoder
            import linne_tpu.native as n
        from . import native
    """))
    names = sorted(name for _, name in _imported_names(tree))
    assert names == ["linne_tpu.exact", "linne_tpu.native",
                     "linne_tpu_torch.native"]


_BLOCKED_RUN = """
import importlib, importlib.abc, pathlib, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("linne_tpu", "jax"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
root = pathlib.Path(REPO)
sys.path.insert(0, str(root))
mods = sorted(".".join(p.relative_to(root).with_suffix("").parts)
              .removesuffix(".__init__")
              for p in (root / "linne_tpu_torch").rglob("*.py"))
for m in mods:
    importlib.import_module(m)

import numpy as np
from linne_tpu_torch import cli
from linne_tpu_torch.codec.decoder import Decoder
from linne_tpu_torch.codec.encoder import TorchEncoder
from linne_tpu_torch.codec.params import EncodeParameter, compress_viable
from linne_tpu_torch.codec.torch_decoder import TorchDecoder
from linne_tpu_torch.io.wav import read_wav, write_wav

rng = np.random.default_rng(5)
spb = 2048
n = 2 * spb + 300  # the 300-sample tail takes the host ExactEncoder
t = np.arange(n)
sig = np.round(8000 * np.sin(2 * np.pi * 440 * t / 44100)
               + rng.normal(0, 300, n)).astype(np.int32)[None]
enc = TorchEncoder(batch_blocks=2, device="cpu")
enc.set_encode_parameter(EncodeParameter(
    num_channels=1, bits_per_sample=16, sampling_rate=44100,
    num_samples_per_block=spb, preset=7))
assert compress_viable(enc.preset, spb, n - 2 * spb)
data = enc.encode_whole([sig[0]], n)
assert np.array_equal(TorchDecoder(device="cpu").decode_whole(data)[0], sig[0])
assert np.array_equal(Decoder().decode_whole(data)[0], sig[0])
split = TorchEncoder(batch_blocks=2, devices=["cpu", "cpu"])
split.set_encode_parameter(enc.parameter)
assert split.encode_whole([sig[0]], n) == data
assert np.array_equal(
    TorchDecoder(devices=["cpu"] * 3).decode_whole(data)[0], sig[0])

tmp = pathlib.Path(TMP)
from linne_tpu_torch.utils.profiling import StageTimer, trace
timer = StageTimer()
with trace(str(tmp / "trace")), timer.stage("decode"):
    TorchDecoder(device="cpu").decode_whole(data)
assert list((tmp / "trace").glob("*.pt.trace.json")) and timer.counts["decode"] == 1
wav = np.round(6000 * np.sin(2 * np.pi * 220 * np.arange(2 * 10240) / 44100)
               + rng.normal(0, 200, 2 * 10240)).astype(np.int32)[None]
write_wav(str(tmp / "in.wav"), wav, 44100, 16)
assert cli.main(["-e", "--exact", str(tmp / "in.wav"),
                 str(tmp / "out.lnn")]) == 0
assert cli.main(["-d", str(tmp / "out.lnn"), str(tmp / "back.wav")]) == 0
assert np.array_equal(read_wav(str(tmp / "back.wav"))[1], wav)
assert cli.main(["-e", "--exact", "--threads", "2", "-a", "1",
                 str(tmp / "in.wav"), str(tmp / "thr.lnn")]) == 0
assert cli.main(["-e", "--exact-device", "--device", "cpu",
                 str(tmp / "in.wav"), str(tmp / "dev.lnn")]) == 0
assert (tmp / "dev.lnn").read_bytes() == (tmp / "out.lnn").read_bytes()
assert cli.main(["-d", str(tmp / "thr.lnn"), str(tmp / "back2.wav")]) == 0
assert np.array_equal(read_wav(str(tmp / "back2.wav"))[1], wav)
# noise, whose training stops after ~110 iterations (a pure tone trains
# to the 2000-iteration cap)
noise = np.round(np.random.default_rng(1).normal(0, 6000, (1, 10240 + 500)))
noise = noise.astype(np.int32)
write_wav(str(tmp / "noise.wav"), noise, 44100, 16)
assert cli.main(["-e", "--device", "cpu", "-m", "1", "-a", "1", "-l",
                 str(tmp / "noise.wav"), str(tmp / "al.lnn")]) == 0
from linne_tpu_torch.codec.streaming import StreamingDecoder
stream = StreamingDecoder((tmp / "al.lnn").read_bytes())
assert np.array_equal(stream.read(noise.shape[1] + 1), noise)

loaded = [m for m in sys.modules if m.split(".")[0] in ("linne_tpu", "jax")]
assert not loaded, loaded
print("ok", len(mods))
"""


def test_port_runs_with_linne_tpu_and_jax_blocked(tmp_path):
    """Every module of the port imports, and the encoder (with a tail that
    takes the host ExactEncoder, and over a two-entry device list), both
    decoders (the pooled one over three entries too), a profiling trace,
    the CLI's --exact, --exact --threads 2 -a 1, --exact-device and
    batched -m 1 -a 1 -l encodes, its decode and a StreamingDecoder read
    run on the CPU, with imports of `linne_tpu` and jax refused."""
    code = (f"REPO = {str(REPO_ROOT)!r}\nTMP = {str(tmp_path)!r}\n"
            + _BLOCKED_RUN)
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1].startswith("ok ")
