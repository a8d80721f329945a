"""The PyTorch port imports no jax, builds nothing on import, and sets its
dtype policy."""

import os
import subprocess
import sys

from conftest import REPO_ROOT

_MODULES = [
    "linne_tpu_torch",
    "linne_tpu_torch.convert",
    "linne_tpu_torch.cli",
    "linne_tpu_torch.ops",
    "linne_tpu_torch.ops.windows",
    "linne_tpu_torch.ops.intops",
    "linne_tpu_torch.ops.analysis",
    "linne_tpu_torch.ops.rice_search",
    "linne_tpu_torch.ops.synthesis",
    "linne_tpu_torch.ops._kernels",
    "linne_tpu_torch.codec",
    "linne_tpu_torch.codec.encoder",
    "linne_tpu_torch.codec.torch_decoder",
]


def _run(code):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "PYTHONSTARTUP")}  # no sitecustomize
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
        "import linne_tpu_torch.ops.synthesis, linne_tpu_torch.ops._kernels; "
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
