"""ctypes bindings for the native host runtime (csrc/linne_host.cpp).

The port's own copy of linne_tpu/native.py and native/linne_host.cpp. The
library is compiled on demand with g++ (-O3 -fwrapv for the format's
two's-complement wraparound semantics) and cached under csrc/build/. If no
compiler is available the package falls back to the pure-Python format layer
transparently (`available()` -> False).
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import sys
import threading
from typing import Optional

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parent / "csrc"
_SRC = _ROOT / "linne_host.cpp"
_BUILD_DIR = _ROOT / "build"
_WIN = sys.platform == "win32"
_LIB_PATH = _BUILD_DIR / ("linne_host.dll" if _WIN else "linne_host.so")

_lock = threading.Lock()
_lib = None
_tried = False

_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_i16p = np.ctypeslib.ndpointer(dtype=np.int16, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")


def _build_cmds(out: str):
    """Candidate compiler invocations writing the library to `out`, best
    first. Windows tries MSVC's cl, then clang-cl, then a MinGW g++
    (matching the reference's full-speed 4-OS CI matrix, reference:
    .github/workflows/c-cpp.yml:14-18); everything else is g++ with a
    -march=native -> generic fallback."""
    src = str(_SRC)
    if _WIN:
        # /fp:precise + the in-source `#pragma fp_contract(off)` keep the
        # exact float64 helpers rounding every product before adding.
        # MSVC has no -fwrapv; the format's wraparound arithmetic is done
        # on unsigned/explicitly-cast values in the hot paths, and the
        # byte-exact golden suite gates any build that gets this wrong.
        cl = ["cl", "/nologo", "/O2", "/fp:precise", "/std:c++17", "/EHsc",
              "/DLINNE_HOST_BUILD_DLL", "/LD", src, f"/Fe:{out}",
              f"/Fo:{str(_BUILD_DIR)}\\"]
        clangcl = ["clang-cl", "/O2", "/fp:precise", "/std:c++17", "/EHsc",
                   "/DLINNE_HOST_BUILD_DLL", "/LD", src, f"/Fe:{out}"]
        for arch in ("/arch:AVX512", "/arch:AVX2", None):
            extra = [arch] if arch else []
            yield cl[:1] + extra + cl[1:]
            yield clangcl[:1] + extra + clangcl[1:]
        yield ["g++", "-O3", "-fwrapv", "-ffp-contract=off", "-shared",
               "-std=c++17", "-DLINNE_HOST_BUILD_DLL", "-march=native",
               src, "-o", out]
        yield ["g++", "-O3", "-fwrapv", "-ffp-contract=off", "-shared",
               "-std=c++17", "-DLINNE_HOST_BUILD_DLL", src, "-o", out]
        return
    # -ffp-contract=off: the exact float64 helpers must round every product
    # before adding (matching the numpy oracle); the helpers also carry a
    # per-function attribute so differently-flagged builds stay exact.
    # The library is always built on the machine it runs on, so tune for
    # it; fall back to generic codegen if the toolchain rejects it.
    base = ["g++", "-O3", "-fwrapv", "-ffp-contract=off", "-fPIC",
            "-shared", "-std=c++17", "-pthread"]
    for extra in (["-march=native"], []):
        yield base + extra + [src, "-o", out]


def _build() -> bool:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if (_LIB_PATH.exists()
            and _LIB_PATH.stat().st_mtime >= _SRC.stat().st_mtime):
        return True
    # build under a per-process name and rename into place, so processes
    # that build at once never load a half-written library
    tmp = _BUILD_DIR / f"{_LIB_PATH.stem}.{os.getpid()}.tmp{_LIB_PATH.suffix}"
    for cmd in _build_cmds(str(tmp)):
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            if tmp.exists():
                os.replace(tmp, _LIB_PATH)
                return True
        except (OSError, subprocess.CalledProcessError):
            continue
    return False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("LINNE_NO_NATIVE"):
            return None
        if not _build():
            return None
        lib = ctypes.CDLL(str(_LIB_PATH))

        lib.linne_crc16.restype = ctypes.c_uint16
        lib.linne_crc16.argtypes = [_u8p, ctypes.c_uint64]

        lib.linne_pack_compress_payload.restype = ctypes.c_int64
        lib.linne_pack_compress_payload.argtypes = [
            _i32p, _i32p, _i32p, _i32p, _i32p, _i32p, _i32p, _i32p,
            _u32p, _u8p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            _i32p, ctypes.c_int32, ctypes.c_int32,
            _u8p, ctypes.c_int64,
        ]

        lib.linne_unpack_compress_payload.restype = ctypes.c_int64
        lib.linne_unpack_compress_payload.argtypes = [
            _u8p, ctypes.c_int64,
            _i16p, _i16p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            _i32p, ctypes.c_int32,
            _i32p, _i32p, _i32p, _i32p, _i32p, _i32p,
        ]

        lib.linne_synthesize_block.restype = None
        lib.linne_synthesize_block.argtypes = [
            _i32p, _i32p, _i32p, _i32p, _i32p, _i32p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            _i32p, ctypes.c_int32, ctypes.c_int32,
        ]

        lib.linne_deemphasis.restype = None
        lib.linne_deemphasis.argtypes = [
            _i32p, ctypes.c_int32, _i32p, _i32p, ctypes.c_int32,
        ]

        lib.linne_finish_rows.restype = None
        lib.linne_finish_rows.argtypes = [
            _i32p, ctypes.c_int64, _i32p, _i64p, ctypes.c_int32,
            _i32p, _i32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, _i32p, ctypes.c_int64,
        ]

        lib.linne_decode_stream.restype = ctypes.c_int32
        lib.linne_decode_stream.argtypes = [
            _u8p, ctypes.c_int64, ctypes.c_int64,
            _i16p, _i16p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _i32p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            _i32p,
        ]

        lib.linne_unpack_bits.restype = None
        lib.linne_unpack_bits.argtypes = [
            _u32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, _i32p,
        ]

        lib.linne_predict_layer.restype = None
        lib.linne_predict_layer.argtypes = [
            _i32p, _i32p, ctypes.c_int32, _i32p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
        ]

        lib.linne_exact_autocorr.restype = None
        lib.linne_exact_autocorr.argtypes = [
            _f64p, ctypes.c_int64, ctypes.c_int32, _f64p,
        ]

        lib.linne_preemph_coef.restype = ctypes.c_int32
        lib.linne_preemph_coef.argtypes = [_i32p, ctypes.c_int64]

        lib.linne_exact_unit_predict.restype = None
        lib.linne_exact_unit_predict.argtypes = [
            _f64p, ctypes.c_int64, _f64p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, _f64p,
        ]

        lib.linne_exact_levinson.restype = None
        lib.linne_exact_levinson.argtypes = [
            _f64p, ctypes.c_int32, ctypes.c_double, _f64p, _f64p,
        ]

        lib.linne_exact_rice_search.restype = ctypes.c_int32
        lib.linne_exact_rice_search.argtypes = [
            _i32p, ctypes.c_int64, _i32p,
        ]

        lib.linne_exact_af_normal.restype = None
        lib.linne_exact_af_normal.argtypes = [
            _f64p, ctypes.c_int64, _f64p, ctypes.c_int32, ctypes.c_double,
            _f64p, _f64p, _f64p,
        ]

        lib.linne_exact_cholesky_solve.restype = ctypes.c_int32
        lib.linne_exact_cholesky_solve.argtypes = [
            _f64p, _f64p, ctypes.c_int32, _f64p,
        ]

        lib.linne_exact_layer_backward.restype = None
        lib.linne_exact_layer_backward.argtypes = [
            _f64p, _f64p, _f64p, _f64p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, _f64p,
        ]

        lib.linne_exact_train.restype = None
        lib.linne_exact_train.argtypes = [
            _f64p, ctypes.c_int64, ctypes.c_int32, _i32p, _i32p,
            _f64p, _f64p, _f64p, ctypes.c_int32,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, _f64p,
        ]

        lib.linne_exact_fit_layer.restype = ctypes.c_int32
        lib.linne_exact_fit_layer.argtypes = [
            _f64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            _f64p, _i64p, _i32p, ctypes.c_int32,
            _f64p, _f64p, _f64p, _f64p, _f64p, _f64p,
        ]

        lib.linne_exact_fit_network.restype = ctypes.c_int32
        lib.linne_exact_fit_network.argtypes = [
            _f64p, ctypes.c_int64, ctypes.c_int32, _i32p, ctypes.c_int32,
            _f64p, ctypes.c_int32, ctypes.c_double, ctypes.c_double,
            _f64p, _i64p, _i32p, _i32p, _i32p,
            _f64p, _f64p, _f64p, _f64p, _f64p, _i32p, _f64p, _f64p,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def lib():
    out = _load()
    if out is None:
        raise RuntimeError("native linne_host library unavailable")
    return out


# -- numpy-facing helpers ----------------------------------------------------


def crc16(data: bytes) -> int:
    arr = np.frombuffer(data, dtype=np.uint8)
    if arr.size == 0:
        return 0
    return int(lib().linne_crc16(arr, arr.size))


def pack_compress_payload(
    residuals: np.ndarray,      # [nch, n] int32
    coefs: np.ndarray,          # [nch, total_order] int32
    log2_units: np.ndarray,     # [nch, nlayers] int32
    rshifts: np.ndarray,        # [nch, nlayers] int32
    preemph_prev: np.ndarray,   # [nch, nstages] int32
    preemph_coef: np.ndarray,   # [nch, nstages] int32
    porder: np.ndarray,         # [nch] int32
    k2s: np.ndarray,            # [nch, max_parts] int32
    huff_codes: np.ndarray,     # [256] uint32
    huff_lens: np.ndarray,      # [256] uint8
    bps: int,
    orders: np.ndarray,         # [nlayers] int32
) -> bytes:
    nch, n = residuals.shape
    nlayers = orders.shape[0]
    nstages = preemph_prev.shape[1]
    max_parts = k2s.shape[1]
    # generous headroom: adversarial planes can cost several bits per sample
    cap = 8 * residuals.nbytes + (1 << 16) + coefs.nbytes * 4
    out = np.empty(cap, dtype=np.uint8)
    size = lib().linne_pack_compress_payload(
        np.ascontiguousarray(residuals, np.int32),
        np.ascontiguousarray(coefs, np.int32),
        np.ascontiguousarray(log2_units, np.int32),
        np.ascontiguousarray(rshifts, np.int32),
        np.ascontiguousarray(preemph_prev, np.int32),
        np.ascontiguousarray(preemph_coef, np.int32),
        np.ascontiguousarray(porder, np.int32),
        np.ascontiguousarray(k2s, np.int32),
        huff_codes, huff_lens,
        nch, n, bps, nlayers,
        np.ascontiguousarray(orders, np.int32), nstages, max_parts,
        out, cap)
    if size < 0:
        raise RuntimeError("payload packing overflow")
    return out[:size].tobytes()


def unpack_compress_payload(
    data: bytes, huff_node0: np.ndarray, huff_node1: np.ndarray,
    huff_root: int, num_symbols: int, nch: int, n: int, bps: int,
    orders: np.ndarray,
):
    nlayers = orders.shape[0]
    nstages = 2
    total_order = int(orders.sum())
    arr = np.frombuffer(data, dtype=np.uint8)
    residuals = np.empty((nch, n), dtype=np.int32)
    coefs = np.empty((nch, total_order), dtype=np.int32)
    log2_units = np.empty((nch, nlayers), dtype=np.int32)
    rshifts = np.empty((nch, nlayers), dtype=np.int32)
    pprev = np.empty((nch, nstages), dtype=np.int32)
    pcoef = np.empty((nch, nstages), dtype=np.int32)
    consumed = lib().linne_unpack_compress_payload(
        arr, arr.size, huff_node0, huff_node1, huff_root, num_symbols,
        nch, n, bps, nlayers, np.ascontiguousarray(orders, np.int32),
        nstages, residuals, coefs, log2_units, rshifts, pprev, pcoef)
    if consumed < 0:
        # same error family as decode_stream so per-block callers
        # (StreamingDecoder, Decoder.decode_block) can map it to the
        # public FormatError contract
        raise StreamDecodeError("corrupt block payload")
    return residuals, coefs, log2_units, rshifts, pprev, pcoef, int(consumed)


def decode_stream(
    body: bytes,                 # stream bytes starting at the first block
    total_samples: int,
    huff_node0: np.ndarray, huff_node1: np.ndarray,
    huff_root: int, num_symbols: int,
    nch: int, bps: int, orders: np.ndarray,
    ms: bool, check_crc: bool, num_threads: int = 0,
) -> np.ndarray:
    """Decode every block of a .lnn stream body into [nch, total_samples]
    int32 planes in one native call (threaded over independent blocks).
    Returns the planes; raises on malformed/corrupt streams with the status
    code in the message ('crc' for CRC mismatches)."""
    arr = np.frombuffer(body, dtype=np.uint8)
    # np.empty is sound: the native scan verifies the blocks cover exactly
    # total_samples before decoding, every success path writes all samples
    # (silent blocks memset), and every failure path raises (the partially
    # written buffer is discarded) — zero-filling 4B/sample was pure waste
    out = np.empty((nch, total_samples), dtype=np.int32)
    st = lib().linne_decode_stream(
        arr, arr.size, total_samples, huff_node0, huff_node1, huff_root,
        num_symbols, nch, bps, orders.shape[0],
        np.ascontiguousarray(orders, np.int32), 2, int(ms), int(check_crc),
        int(num_threads), out)
    if st == -2:
        raise StreamCrcError("block CRC mismatch")
    if st != 0:
        raise StreamDecodeError(f"malformed stream (status {st})")
    return out


class StreamDecodeError(RuntimeError):
    pass


class StreamCrcError(StreamDecodeError):
    pass


def unpack_bits(words: np.ndarray, width: int, n: int,
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """[..., words_per_row] int32/uint32 words -> [..., n] int32 samples
    (W-bit two's complement, little-endian bit order within words), into
    `out` when given (a C-contiguous int32 array of that shape)."""
    lead = words.shape[:-1]
    wpr = words.shape[-1]
    w = np.ascontiguousarray(words).view(np.uint32).reshape(-1, wpr)
    if out is None:
        out = np.empty(lead + (n,), dtype=np.int32)
    elif (out.shape != lead + (n,) or out.dtype != np.int32
          or not out.flags.c_contiguous):
        raise ValueError(f"unpack_bits: out must be a C-contiguous int32 "
                         f"array of shape {lead + (n,)}")
    lib().linne_unpack_bits(w, w.shape[0], wpr, width, n,
                            out.reshape(w.shape[0], n))
    return out


def deemphasis(data: np.ndarray, prevs: np.ndarray, coefs: np.ndarray) -> None:
    """In-place two-stage integer de-emphasis of one channel plane."""
    lib().linne_deemphasis(
        data, data.shape[0], np.ascontiguousarray(prevs, np.int32),
        np.ascontiguousarray(coefs, np.int32), prevs.shape[0])


def finish_rows(rows: np.ndarray, row0: np.ndarray, starts: np.ndarray,
                n: int, pprev: np.ndarray, pcoef: np.ndarray,
                out: np.ndarray, ms: bool) -> None:
    """Finish one stream's pooled-decoded blocks in one call: scatter the
    synthesized rows [nb*nch, rowlen] into out [nch, total] at starts and
    run de-emphasis + MS inverse per block (pprev/pcoef: [nb, nch, nstages])."""
    lib().linne_finish_rows(
        rows, rows.shape[-1], row0, starts, n, pprev, pcoef,
        row0.shape[0], out.shape[0], pprev.shape[-1], 1 if ms else 0,
        out, out.shape[-1])


def synthesize_block(
    chdata: np.ndarray, coefs: np.ndarray, log2_units: np.ndarray,
    rshifts: np.ndarray, preemph_prev: np.ndarray, preemph_coef: np.ndarray,
    orders: np.ndarray, ms: bool,
) -> None:
    nch, n = chdata.shape
    lib().linne_synthesize_block(
        chdata, np.ascontiguousarray(coefs, np.int32),
        np.ascontiguousarray(log2_units, np.int32),
        np.ascontiguousarray(rshifts, np.int32),
        np.ascontiguousarray(preemph_prev, np.int32),
        np.ascontiguousarray(preemph_coef, np.int32),
        nch, n, orders.shape[0], np.ascontiguousarray(orders, np.int32),
        2, int(ms))


def predict_layer(data: np.ndarray, n: int, coef: np.ndarray,
                  num_units: int, rshift: int) -> np.ndarray:
    """One integer FIR predict stage (encoder side): residual[t] =
    data[t] + ((half + sum coef*x) >> rshift) per unit, wrapping int32 —
    same arithmetic as exact/intlpc.py:predict (integer, so any
    implementation is bit-equal)."""
    if data.shape[0] < n:
        raise ValueError(f"predict_layer: n={n} exceeds len(data)="
                         f"{data.shape[0]}")
    out = np.empty(n, dtype=np.int32)
    lib().linne_predict_layer(
        np.ascontiguousarray(data[:n], np.int32), out, n,
        np.ascontiguousarray(coef, np.int32), coef.shape[0], rshift,
        num_units)
    return out


def exact_autocorr(x: np.ndarray, nlags: int) -> np.ndarray:
    """Strict serial-order float64 autocorrelation (bit-identical to the
    numpy mul-then-cumsum oracle, exact/lpc.py)."""
    out = np.empty(nlags, dtype=np.float64)
    lib().linne_exact_autocorr(
        np.ascontiguousarray(x, np.float64), x.shape[0], nlags, out)
    return out


def preemph_coef(x: np.ndarray, n: int) -> int:
    """4-bit pre-emphasis coefficient, one fused serial-order pass
    (bit-identical to exact/filters.py:preemphasis_calculate_coefficient)."""
    return int(lib().linne_preemph_coef(
        np.ascontiguousarray(x[:n], np.int32), n))


def exact_unit_predict(
    x: np.ndarray, params: np.ndarray, num_units: int, npu: int,
    include_base: bool,
) -> np.ndarray:
    """Strict serial-order per-sample unit-filter accumulation (bit-identical
    to exact/network.py:_unit_predictions). Requires num_units | len(x)."""
    n = x.shape[0]
    out = np.empty(n, dtype=np.float64)
    lib().linne_exact_unit_predict(
        np.ascontiguousarray(x, np.float64), n,
        np.ascontiguousarray(params, np.float64), num_units, npu,
        int(include_base), out)
    return out


def exact_levinson(ac: np.ndarray, order: int, flt_eps: float,
                   lpc_coef: np.ndarray, parcor_coef: np.ndarray) -> None:
    """In-place strict-order Levinson-Durbin on the caller's arena arrays
    (bit-identical to exact/lpc.py:levinson_durbin, same write extents)."""
    lib().linne_exact_levinson(ac, order, flt_eps, lpc_coef, parcor_coef)


def exact_rice_search(residuals: np.ndarray):
    """(porder, k2s[1 << porder]) for one int32 residual plane — exact
    arithmetic of format/rice.py:choose_partition."""
    k2s = np.empty(1024, dtype=np.int32)
    porder = int(lib().linne_exact_rice_search(
        np.ascontiguousarray(residuals, np.int32), residuals.shape[0], k2s))
    return porder, k2s[: 1 << porder]


def exact_af_normal(data: np.ndarray, n: int, a: np.ndarray, order: int,
                    eps: float):
    """(r_mat, r_vec, raw_obj) of the IRLS normal equations — exact
    arithmetic of exact/lpc.py:_af_matrix_and_vector (obj undivided)."""
    r_mat = np.empty((order, order), dtype=np.float64)
    r_vec = np.empty(order, dtype=np.float64)
    obj = np.empty(1, dtype=np.float64)
    lib().linne_exact_af_normal(
        np.ascontiguousarray(data[:n], np.float64), n,
        np.ascontiguousarray(a, np.float64), order, eps, r_mat, r_vec, obj)
    return r_mat, r_vec, float(obj[0])


def exact_cholesky_solve(amat: np.ndarray, bvec: np.ndarray):
    """In-place Cholesky solve (mutates amat like the oracle); returns the
    solution vector or None on a non-positive pivot."""
    dim = amat.shape[0]
    x = np.empty(dim, dtype=np.float64)
    st = lib().linne_exact_cholesky_solve(
        amat, np.ascontiguousarray(bvec, np.float64), dim, x)
    return None if st else x


def exact_train(
    data: np.ndarray, n: int, num_units: np.ndarray, num_params: np.ndarray,
    params: np.ndarray, dparams: np.ndarray, momentum: np.ndarray,
    max_iterations: int, learning_rate: float, loss_epsilon: float,
    alpha: float, flt_max: float,
) -> None:
    """Whole -l trainer loop, bit-identical to the oracle
    (exact/network.py:TrainerState.train). params/dparams/momentum are the
    per-layer arrays concatenated and are mutated in place."""
    nl = num_units.shape[0]
    work = np.empty((nl + 3) * n, dtype=np.float64)
    lib().linne_exact_train(
        data, n, nl, num_units, num_params, params, dparams, momentum,
        max_iterations, learning_rate, loss_epsilon, alpha, flt_max, work)


def exact_fit_layer(
    data: np.ndarray, n: int, num_params: int, num_af_iterations: int,
    regular_term: float, flt_eps: float, flt_max: float,
    weights: np.ndarray, w_off: np.ndarray, level_units: np.ndarray,
    buffer: np.ndarray, auto_corr: np.ndarray, lpc_coef: np.ndarray,
    parcor_coef: np.ndarray, params_out: np.ndarray,
    pred_scratch: np.ndarray,
) -> int:
    """Whole-layer unit search + refit, bit-identical to the oracle's
    per-layer fitting loop (exact/network.py). Mutates the arena arrays
    (buffer/auto_corr/lpc_coef/parcor_coef, preserving stale-scratch
    semantics) and params_out. Returns the chosen unit count, or -1 when
    the native path can't reproduce the oracle (caller must fall back)."""
    return int(lib().linne_exact_fit_layer(
        data, n, num_params, num_af_iterations, regular_term, flt_eps,
        flt_max, weights, w_off, level_units, level_units.shape[0],
        buffer, auto_corr, lpc_coef, parcor_coef, params_out,
        pred_scratch))


def exact_fit_network(
    data: np.ndarray, n: int, num_params: np.ndarray,
    num_af_iterations: int, ridge_terms: np.ndarray, flt_eps: float,
    flt_max: float, weights: np.ndarray, w_off: np.ndarray,
    level_units: np.ndarray, level_off: np.ndarray, level_cnt: np.ndarray,
    buffer: np.ndarray, auto_corr: np.ndarray, lpc_coef: np.ndarray,
    parcor_coef: np.ndarray, params_out: np.ndarray, units_out: np.ndarray,
    data_buffer: np.ndarray, pred_scratch: np.ndarray,
) -> int:
    """Whole-network ridge sweep + final refit for one block-channel,
    bit-identical to the oracle's search (exact/network.py:
    set_units_and_parameters; reference: linne_network.c:582-630). Mutates
    the arena arrays, params_out (per-layer taps concatenated), units_out
    and data_buffer. Callers must precheck the envelope (see linne_host.h);
    returns 0 on success."""
    return int(lib().linne_exact_fit_network(
        data, n, num_params.shape[0], num_params, num_af_iterations,
        ridge_terms, ridge_terms.shape[0], flt_eps, flt_max, weights,
        w_off, level_units, level_off, level_cnt, buffer, auto_corr,
        lpc_coef, parcor_coef, params_out, units_out, data_buffer,
        pred_scratch))


def exact_layer_backward(din: np.ndarray, dout: np.ndarray,
                         grad_inout: np.ndarray, params: np.ndarray,
                         num_units: int, npu: int, n: int,
                         dparams: np.ndarray) -> None:
    """Trainer layer backward, bit-identical to the oracle's chains
    (exact/network.py:LayerState.backward). Mutates grad_inout/dparams."""
    lib().linne_exact_layer_backward(
        din, dout, grad_inout, params, num_units, npu, n, dparams)
