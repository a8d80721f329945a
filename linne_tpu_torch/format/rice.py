"""Partitioned recursive-Rice coding of signed residual planes.

Wire-compatible with the reference residual coder
(reference: libs/linne_coder/src/linne_coder.c:85-327):

- residuals are zigzag-mapped to unsigned;
- the plane is split into 2^porder equal partitions, porder chosen by an
  exact code-length search over porder in [0, max_porder] where max_porder is
  bounded by divisibility of the sample count and by 10;
- per-partition two-stage Rice parameters (k1 = k2 + 1) are derived from the
  partition mean via a geometric-distribution MLE closed form;
- the chosen porder is emitted in 10 bits, the first k2 in 5 bits, and each
  subsequent k2 as a gamma-coded zigzagged delta, followed by the samples.

Partition means are computed bottom-up by halving merges in float64 — the
merge order is arithmetic-significant and reproduced exactly.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from ..constants import LOG2_MAX_NUM_PARTITIONS, RICE_PARAMETER_BITS
from .bitstream import BitReader, BitWriter
from .zigzag import zigzag_encode_array, zigzag_decode_scalar, zigzag_encode_scalar

# Solution of (x - 1)^2 + ln(2) x ln(x) = 0; fixed by the format's parameter
# selection rule (reference: linne_coder.c:177).
_OPTX = 0.5127629514437670454896078808815218508243560791015625
_LOG_OPTX = math.log(_OPTX)
_INV_LOGE2 = 1.4426950408889634
_U32 = 0xFFFFFFFF


def optimal_rice_params(mean: float) -> Tuple[int, int]:
    """Optimal (k1, k2) for a partition with the given mean of zigzagged
    values. Scalar libm math on purpose: the selection must match the
    reference's double-precision evaluation exactly."""
    rho = 1.0 / (1.0 + mean)
    one_minus_rho = 1.0 - rho
    if one_minus_rho <= 0.0:
        # mean == 0: log(0) -> -inf in C, ratio -> +0, Log2 -> -inf, k2 = 0
        return 1, 0
    ratio = _LOG_OPTX / math.log(one_minus_rho)
    if ratio <= 0.0:
        k2 = 0
    else:
        k2f = math.floor(math.log(ratio) * _INV_LOGE2)
        k2 = int(max(0.0, k2f))
    return k2 + 1, k2


def gamma_put(writer: BitWriter, val: int) -> None:
    """Elias-gamma style code (reference: linne_coder.c:85-103)."""
    if val == 0:
        writer.put(1, 1)
        return
    ndigit = (val + 1).bit_length()  # == LOG2CEIL(val + 2)
    writer.put_zeros(ndigit - 1)
    writer.put(val + 1, ndigit)


def gamma_get(reader: BitReader) -> int:
    run = reader.get_zero_run_length()
    if run == 0:
        return 0
    if run >= 32:  # corrupt: every gamma code in this format fits 32 bits
        raise ValueError("corrupt gamma code")
    rest = reader.get(run)
    return (1 << run) + rest - 1


def _gamma_bits(uval: int) -> int:
    return 1 if uval == 0 else 2 * (uval + 1).bit_length() - 1


def _partition_means(uvals: np.ndarray, max_porder: int) -> List[np.ndarray]:
    """means[p] = per-partition means at split order p, built bottom-up with
    the exact float64 halving merges of the reference."""
    num = uvals.shape[0]
    nparts = 1 << max_porder
    nsmpl = num // nparts
    sums = uvals.astype(np.uint64).reshape(nparts, nsmpl).sum(axis=1)
    means = [None] * (max_porder + 1)
    means[max_porder] = sums.astype(np.float64) / float(nsmpl)
    for p in range(max_porder - 1, -1, -1):
        upper = means[p + 1]
        means[p] = (upper[0::2] + upper[1::2]) / 2.0
    return means


def _max_porder(num_samples: int) -> int:
    p = 1
    while num_samples % (1 << p) == 0:
        p += 1
    return min(p - 1, LOG2_MAX_NUM_PARTITIONS)


def _code_length_total(uvals: np.ndarray, k1: int, k2: int) -> int:
    """Sum of per-sample recursive-Rice code lengths (exact)."""
    k1pow = np.uint64(1 << k1)
    u = uvals.astype(np.uint64)
    small = u < k1pow
    nbits_small = int(np.count_nonzero(small)) * (k1 + 1)
    big = u[~small]
    nbits_big = int(((big - k1pow) >> np.uint64(k2)).sum()) + big.shape[0] * (k2 + 2)
    return nbits_small + nbits_big


def choose_partition(data: np.ndarray) -> Tuple[int, List[Tuple[int, int]]]:
    """Search the optimal partition order; return (best_porder, [(k1, k2)]
    per partition of the best order)."""
    num_samples = data.shape[0]
    uvals = zigzag_encode_array(data)
    max_porder = _max_porder(num_samples)
    means = _partition_means(uvals, max_porder)

    best_porder = 0
    min_bits = _U32
    params_by_porder = []
    for porder in range(max_porder + 1):
        nsmpl = num_samples >> porder
        bits = 0
        prevk2 = 0
        params = []
        for part in range(1 << porder):
            k1, k2 = optimal_rice_params(float(means[porder][part]))
            params.append((k1, k2))
            bits += _code_length_total(
                uvals[part * nsmpl : (part + 1) * nsmpl], k1, k2)
            if part == 0:
                bits += RICE_PARAMETER_BITS
            else:
                bits += _gamma_bits(zigzag_encode_scalar(k2 - prevk2))
            prevk2 = k2
        params_by_porder.append(params)
        bits &= _U32  # the reference accumulates in uint32
        if min_bits > bits:
            min_bits = bits
            best_porder = porder
    return best_porder, params_by_porder[best_porder]


def encode_plane(writer: BitWriter, data: np.ndarray) -> None:
    """Encode one residual plane (int32 array) into the bit stream."""
    num_samples = data.shape[0]
    best_porder, params = choose_partition(data)
    uvals = zigzag_encode_array(data)

    writer.put(best_porder, LOG2_MAX_NUM_PARTITIONS)
    nsmpl = num_samples >> best_porder
    prevk2 = 0
    for part, (k1, k2) in enumerate(params):
        if part == 0:
            writer.put(k2, RICE_PARAMETER_BITS)
        else:
            gamma_put(writer, zigzag_encode_scalar(k2 - prevk2))
        prevk2 = k2
        k1pow = 1 << k1
        k2mask = (1 << k2) - 1
        put = writer.put
        put_zeros = writer.put_zeros
        for uval in uvals[part * nsmpl : (part + 1) * nsmpl].tolist():
            if uval < k1pow:
                put((1 << k1) | uval, k1 + 1)
            else:
                uval -= k1pow
                put_zeros(1 + (uval >> k2))
                put(1, 1)
                put(uval & k2mask, k2)


def encode_plane_with_params(
    writer: BitWriter, data: np.ndarray, porder: int, k2s
) -> None:
    """Emit one residual plane with externally chosen partition order and
    per-partition k2 parameters (e.g. from the device-side search)."""
    num_samples = data.shape[0]
    uvals = zigzag_encode_array(data)
    writer.put(porder, LOG2_MAX_NUM_PARTITIONS)
    nsmpl = num_samples >> porder
    prevk2 = 0
    for part in range(1 << porder):
        k2 = int(k2s[part])
        if part == 0:
            writer.put(k2, RICE_PARAMETER_BITS)
        else:
            gamma_put(writer, zigzag_encode_scalar(k2 - prevk2))
        prevk2 = k2
        k1 = k2 + 1
        k1pow = 1 << k1
        k2mask = (1 << k2) - 1
        put = writer.put
        put_zeros = writer.put_zeros
        for uval in uvals[part * nsmpl : (part + 1) * nsmpl].tolist():
            if uval < k1pow:
                put((1 << k1) | uval, k1 + 1)
            else:
                uval -= k1pow
                put_zeros(1 + (uval >> k2))
                put(1, 1)
                put(uval & k2mask, k2)


_M64 = (1 << 64) - 1
_M32 = 0xFFFFFFFF


def _decode_partition(reader: BitReader, k2: int, nsmpl: int, out: list) -> None:
    """Bulk Rice(k2+1, k2) decode of one partition, appending zigzag-decoded
    ints to `out`. Mirrors the native rice_run: drain left-aligned 64-bit
    windows (several symbols per 8-byte load), with a per-symbol generic
    path for window-spanning runs and the buffer tail. uval wraps to uint32
    BEFORE the zigzag decode, like the reference's uint32 accumulator (so
    corrupt-stream output matches the native decoder sample-for-sample)."""
    data = reader._data
    end = len(data)
    bitpos = reader.bit_position()
    k1 = k2 + 1
    k1pow = 1 << k1
    kmask = (1 << k2) - 1
    s = 0
    while s < nsmpl:
        byte = bitpos >> 3
        if byte + 8 <= end:
            w = int.from_bytes(data[byte : byte + 8], "big")
            sh = bitpos & 7
            w = (w << sh) & _M64
            avail = 64 - sh
            used = 0
            while s < nsmpl:
                q = 64 - (w | 1).bit_length()
                need = q + 1 + (k2 if q else k1)
                if used + need >= avail:
                    break
                if q:
                    payload = (w >> (63 - q - k2)) & kmask
                    uval = (payload + k1pow + ((q - 1) << k2)) & _M32
                else:
                    uval = (w >> (62 - k2)) & (kmask * 2 + 1)
                out.append((uval >> 1) ^ -(uval & 1))
                s += 1
                w = (w << need) & _M64
                used += need
            bitpos += used
            if used:
                continue
        # generic single symbol (tail of buffer / window-spanning run)
        reader.seek_bit(bitpos)
        quot = reader.get_zero_run_length()
        if quot == 0:
            uval = reader.get(k1)
        else:
            uval = (reader.get(k2) + k1pow + ((quot - 1) << k2)) & _M32
        out.append((uval >> 1) ^ -(uval & 1))
        s += 1
        bitpos = reader.bit_position()
    reader.seek_bit(bitpos)


def decode_plane(reader: BitReader, num_samples: int) -> np.ndarray:
    """Decode one residual plane of `num_samples` int32 samples."""
    best_porder = reader.get(LOG2_MAX_NUM_PARTITIONS)
    nsmpl = num_samples >> best_porder
    # valid streams only carry porders that divide the sample count (the
    # encoder's max_porder rule); mirror the native decoder's rejection
    if (nsmpl << best_porder) != num_samples:
        raise ValueError("corrupt partition order")
    vals: list = []
    k2 = 0
    for part in range(1 << best_porder):
        if part == 0:
            k2 = reader.get(RICE_PARAMETER_BITS)
        else:
            k2 = k2 + zigzag_decode_scalar(gamma_get(reader))
            if not 0 <= k2 <= 31:  # 5-bit wire range, like the native path
                raise ValueError("corrupt rice parameter")
        _decode_partition(reader, k2, nsmpl, vals)
    # values are already zigzag-decoded from uint32-wrapped uvals
    return np.asarray(vals, dtype=np.int32)
