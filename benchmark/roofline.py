"""Peaks of the card and the operations and bytes of each hand-written
kernel's work, counted from the shapes and side information the benchmark
fed in, never from a kernel's launch arguments: so they count the same
work whatever implements it.

A kernel's share of its roofline is the least time the card could take
for that work, the larger of operations over the operation peak and bytes
over the memory bandwidth, over the kernel's profiled device seconds.
Each input byte is counted read once and each output byte written once.
Where the work depends on the data (a unit split, a block type), the
count is what these inputs need, not the most a kernel could do.

Peaks of one NVIDIA H100 SXM5 (80 GB HBM3), at its 700 W power limit:
- HBM3 bandwidth 3.35 TB/s (NVIDIA H100 Tensor Core GPU datasheet);
- FP64 (not on the tensor cores) 34 TFLOP/s, a multiply-add counted as two
  operations (the same datasheet);
- 32-bit integer multiply-add: 64 results a clock a multiprocessor at
  compute capability 9.0 (CUDA C++ Programming Guide, "Arithmetic
  Instructions", throughput table), times 132 multiprocessors at the
  1.98 GHz boost clock (datasheet): 16.73 T multiply-adds a second.
A card set below 700 W runs slower under load: the run reports the
card's power limit beside these shares.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12
INT32_MAD_PER_S = 64 * 132 * 1.98e9


def share_pct(ops: float, op_peak: float, nbytes: float,
              seconds: float) -> float | None:
    """Roofline share in %: least time over measured time; None where no
    time was measured."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * max(ops / op_peak, nbytes / HBM_BYTES_PER_S) / seconds


def unit_counts(order: int, n: int) -> list:
    """Unit counts a layer of `order` taps tries on blocks of n samples."""
    out, u = [], 1
    while u <= min(128, order):
        if order % u == 0 and n % u == 0 and n // u > order // u:
            out.append(u)
        u <<= 1
    return out


# -- the batched encode ------------------------------------------------------

def levinson_durbin_work(blocks: int, channels: int, n: int,
                         orders: Sequence[int], ridges: int
                         ) -> Tuple[float, float]:
    """(float64 operations, bytes) of every Levinson-Durbin recursion the
    batched analysis of `blocks` full blocks needs: one of order orders[0]
    a block and channel for the block-type estimate (with its reflection
    coefficients), and for every ridge term, layer and unit count one of
    order / units a unit. A recursion of order p takes p(p+1)
    multiply-adds and p divisions (counted as one operation each); it
    reads p + 1 autocorrelations and writes p coefficients (2p with the
    reflection coefficients), 8 bytes each."""
    rows = blocks * channels
    p = orders[0]
    ops = rows * (2 * p * (p + 1) + p)
    nbytes = rows * 8 * ((p + 1) + 2 * p)
    for order in orders:
        for u in unit_counts(order, n):
            q = order // u
            r = rows * ridges * u
            ops += r * (2 * q * (q + 1) + q)
            nbytes += r * 8 * ((q + 1) + q)
    return float(ops), float(nbytes)


def predict_rows_work(rows: Iterable[Tuple[int, int, int]]
                      ) -> Tuple[float, float]:
    """(int32 multiply-adds, bytes) of the unit-split integer prediction
    (or its inverse, the synthesis) of rows given as (samples n, layer
    order, unit count u): each unit of n / u samples filters all but its
    first order / u samples with order / u taps, so a row takes
    (n - order) * order / u multiply-adds; it reads n samples and order
    coefficients and writes n samples, 4 bytes each (and its unit count
    and shift)."""
    ops = 0
    nbytes = 0
    for n, order, u in rows:
        npu = order // u
        ns = n // u
        if npu and ns > npu:
            ops += u * (ns - npu) * npu
        nbytes += 4 * (2 * n + order + 2)
    return float(ops), float(nbytes)


def quantize_coefficients_work(blocks: int, channels: int,
                               orders: Sequence[int]) -> Tuple[float, float]:
    """(float64 operations, bytes) of the error-feedback quantizer of a
    block's layers: per tap a multiply-add, a rounding and a subtraction
    (4 operations), plus a maximum per tap; reads the float64
    coefficients, writes int32 coefficients and a shift a layer."""
    rows = blocks * channels
    taps = sum(orders)
    return (float(rows * 5 * taps),
            float(rows * (8 * taps + 4 * taps + 4 * len(orders))))


# -- the byte-exact fit ------------------------------------------------------

def autocorr_serial_work(segments: int, samples: int, lags: int
                         ) -> Tuple[float, float]:
    """(float64 operations, bytes) of serial-order autocorrelations of
    `segments` windowed segments of `samples` each at `lags` lags: a
    multiply-add a lag and sample (about samples - lag/2 a lag); reads
    each segment once, writes the lags."""
    ops = segments * 2 * lags * (samples - (lags - 1) / 2.0)
    return float(ops), float(segments * 8 * (samples + lags))


def levinson_serial_work(segments: int, order: int) -> Tuple[float, float]:
    """As `levinson_durbin_work` for `segments` recursions of one order:
    p(p+1) multiply-adds and p divisions; reads p + 1 values, writes p."""
    p = order
    return (float(segments * (2 * p * (p + 1) + p)),
            float(segments * 8 * (2 * p + 1)))


def serial_abs_mean_work(rows: int, samples: int) -> Tuple[float, float]:
    """Mean absolute value of `rows` rows: an add and an absolute value a
    sample; reads the row, writes one value."""
    return float(rows * 2 * samples), float(rows * 8 * (samples + 1))


def chain_predict_work(rows: int, samples: int, taps: int
                       ) -> Tuple[float, float]:
    """Float64 prediction of `rows` rows of `samples` by `taps` taps in
    serial order: a multiply-add a tap and predicted sample; reads the row
    and the taps, writes the residual."""
    pred = max(samples - taps, 0)
    return (float(rows * 2 * taps * pred),
            float(rows * 8 * (2 * samples + taps)))


def quantize_layer_work(rows: int, order: int) -> Tuple[float, float]:
    """The byte-exact quantizer of `rows` layers of `order` taps, counted
    as `quantize_coefficients_work` counts a layer."""
    return (float(rows * 5 * order),
            float(rows * (8 * order + 4 * order + 4)))
