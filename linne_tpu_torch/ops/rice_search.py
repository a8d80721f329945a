"""Batched partitioned-Rice parameter search. Counterpart of
linne_tpu/ops/rice_search.py.

Partition sums come from reshapes, per-partition Rice parameters from the
closed-form MLE, and exact per-sample code lengths are summed with the
wrap of the reference's uint32 accumulator
(reference: libs/linne_coder/src/linne_coder.c:217-279). torch's uint32
lacks shifts on the CPU, so every uint32 quantity here is held in int64 and
reduced modulo 2^32 (`& 0xFFFFFFFF`) where the reference wraps.

`rice_search` sends a CPU tensor to `_rice_search_plain`, these torch ops,
and a CUDA tensor to one launch of the hand-written kernel
(ops/analysis_scans.py:rice_search, csrc/analysis_scans.cu
rice_search_kernel), whose orders and parameters are the plain version's
on the same CUDA tensor, bit for bit.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..constants import LOG2_MAX_NUM_PARTITIONS, RICE_PARAMETER_BITS
from . import analysis_scans

_OPTX = 0.5127629514437670454896078808815218508243560791015625
_LOG_OPTX = math.log(_OPTX)
_MASK32 = 0xFFFFFFFF


def max_porder_for(num_samples: int) -> int:
    p = 1
    while num_samples % (1 << p) == 0:
        p += 1
    return min(p - 1, LOG2_MAX_NUM_PARTITIONS)


def _optimal_k2(mean: torch.Tensor) -> torch.Tensor:
    rho = 1.0 / (1.0 + mean)
    log1m = torch.log(torch.clamp(1.0 - rho, min=1e-300))
    ratio = _LOG_OPTX / log1m
    k2 = torch.floor(torch.log2(torch.clamp(ratio, min=1e-300)))
    k2 = torch.clamp(k2, 0.0, 31.0).to(torch.int32)
    return torch.where(mean <= 0.0, 0, k2)


def _zigzag_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 -> its uint32 zigzag code, held in int64 (exact there: the
    result of an int32 input lies in [0, 2^32))."""
    x = x.long()
    return (x << 1) ^ (x >> 31)


def _gamma_bits(uval: torch.Tensor) -> torch.Tensor:
    # 1 for 0, else 2*ceil(log2(v+2)) - 1
    nd = 32 - _clz32((uval + 1) & _MASK32)
    return torch.where(uval == 0, 1, 2 * nd.long() - 1) & _MASK32


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of a uint32 value (held in int64), via float64 log2
    as the reference computes it."""
    return torch.where(
        x == 0, 32,
        31 - torch.floor(torch.log2(torch.clamp(x.double(), min=1.0)))
    ).to(torch.int32)


def rice_search(
    data: torch.Tensor, compute_dtype=torch.float64
) -> Tuple[torch.Tensor, torch.Tensor]:
    """data: [..., n] int32 residual planes.
    Returns (best_porder[...] int32, k2[..., 2^max_porder] int32 where the
    first 2^best_porder entries are the per-partition parameters and the
    rest are 0). A CPU tensor takes `_rice_search_plain`; any other launches
    the kernel, whose partition means are float64 (the only compute_dtype
    it takes), or raises."""
    if data.device.type == "cpu":
        return _rice_search_plain(data, compute_dtype)
    if compute_dtype != torch.float64:
        raise ValueError(f"compute_dtype {compute_dtype}: the kernel "
                         "computes in torch.float64 only")
    n = data.shape[-1]
    max_porder = max_porder_for(n)
    best, k2 = analysis_scans.rice_search(
        data.reshape(-1, n).contiguous(), max_porder)
    lead = tuple(data.shape[:-1])
    return best.reshape(lead), k2.reshape(lead + (1 << max_porder,))


def _rice_search_plain(
    data: torch.Tensor, compute_dtype=torch.float64
) -> Tuple[torch.Tensor, torch.Tensor]:
    """rice_search as torch ops, a Python loop over the partition orders:
    the kernel's plain version."""
    n = data.shape[-1]
    lead = tuple(data.shape[:-1])
    max_porder = max_porder_for(n)
    max_parts = 1 << max_porder
    u = _zigzag_u32(data)
    sums = torch.sum(
        u.to(compute_dtype).reshape(lead + (max_parts, n // max_parts)),
        dim=-1)

    totals = []
    k2_padded = []
    for porder in range(max_porder, -1, -1):
        nparts = 1 << porder
        nsmpl = n >> porder
        k2 = _optimal_k2(sums / nsmpl)              # [..., nparts]
        uv = u.reshape(lead + (nparts, nsmpl))
        k2b = k2.unsqueeze(-1).long()
        # len(u) = k2+2 + max(q-2, 0) with q = u >> k2 (see the reference
        # module for the derivation); summed mod 2^32 like the reference's
        # uint32 total (which, with k2 fitted to the partition mean, stays
        # near 36 bits per sample and so far from wrapping)
        q = uv >> k2b
        lens = k2b + 2 + torch.where(q >= 2, q - 2, 0)
        bits = torch.sum(lens, dim=(-2, -1))
        # parameter header bits: 5 for the first k2, gamma(zigzag(delta))
        bits = bits + RICE_PARAMETER_BITS
        if nparts > 1:
            delta = k2[..., 1:] - k2[..., :-1]
            bits = bits + torch.sum(_gamma_bits(_zigzag_u32(delta)), dim=-1)
        totals.append(bits & _MASK32)
        k2_padded.append(F.pad(k2, (0, max_parts - nparts)))
        if porder > 0:
            sums = torch.sum(sums.reshape(lead + (nparts // 2, 2)), dim=-1)

    # stacks are in descending porder; best = first minimum in ASCENDING
    # porder order (reference iterates porder upward with strict >)
    tstack = torch.stack(totals[::-1], dim=0)
    best = torch.argmin(tstack, dim=0).to(torch.int32)
    kstack = torch.stack(k2_padded[::-1], dim=0)
    idx = best.long()[None, ..., None].expand((1,) + lead + (max_parts,))
    k2_sel = torch.gather(kstack, 0, idx)[0]
    return best, k2_sel
