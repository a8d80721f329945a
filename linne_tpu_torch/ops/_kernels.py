"""Build and load the package's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface. It is compiled with nvcc
into `csrc/build/lib<name>.so` at first use, rebuilt when the source is
newer than the library, and loaded with ctypes. Importing this module
builds nothing. A missing nvcc or a failed build raises: there is no
fallback.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading

_CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = _CSRC / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict = {}


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, else PATH, else /usr/local/cuda/bin."""
    candidates = []
    home = os.environ.get("CUDA_HOME")
    if home:
        candidates.append(os.path.join(home, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def build(name: str) -> pathlib.Path:
    """Compile csrc/<name>.cu unless an up-to-date library exists; return
    the library's path."""
    src = _CSRC / f"{name}.cu"
    lib = _BUILD_DIR / f"lib{name}.so"
    if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {src} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib
