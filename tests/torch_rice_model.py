"""A step-for-step model of rice_search_kernel (csrc/analysis_scans.cu)
on the CPU, residual planes whose orders tie on total bits, and planes
whose partition means lie at the parameter fit's edges. Imported
by tests/test_torch_rice.py (the model against the plain version on the
CPU) and tests/test_torch_cuda.py (the tie and edge planes, the kernel
against the plain version on the card).

The model takes the kernel's plan (threads, chunks of a finest partition)
and its steps: the finest partition sums of each item, added over the
chunks of a partition; the coarser orders' sums by pairs; every node's
parameter; each item's code lengths at every order from one pass over its
samples, the item that starts a partition adding that partition's
nsmpl (k + 2) and the gamma code of its parameter's difference from the
one before; the sums of the threads, the 5 bits of the first parameter,
the first minimum over the orders from order 0 up. Sums are uint64 and
uint32, wrapping as the kernel's do. The parameters come from the plain
version's `_optimal_k2` on the CPU, so the model is the plain version's
bits on the CPU as the kernel is on the card (where torch divides a
partition sum by the product with the reciprocal of its length, as the
kernel does).
"""

from __future__ import annotations

import numpy as np
import torch

from linne_tpu_torch.ops import rice_search as R

THREADS = 512  # kRsThreads
PARAMETER_BITS = 5  # RICE_PARAMETER_BITS


def plan(n: int, max_porder: int):
    """(threads, lcpp, chunk) of linne_rice_search's launch."""
    parts, length = 1 << max_porder, n >> max_porder
    threads = min(THREADS, max(32, (n // 16 + 31) // 32 * 32))
    lcpp = 0
    while (parts << lcpp) < threads and (2 << lcpp) <= length:
        lcpp += 1
    return threads, lcpp, (length + (1 << lcpp) - 1) >> lcpp


def zigzag(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.int32)
    return ((x.astype(np.uint32) << np.uint32(1))
            ^ (x >> 31).astype(np.uint32))


def gamma_bits(d: int) -> int:
    z = int(zigzag(np.asarray([d]))[0])
    return 1 if z == 0 else 2 * (z + 1).bit_length() - 1


def _fits(sums: np.ndarray, nsmpl: int) -> np.ndarray:
    mean = torch.from_numpy(sums.astype(np.float64)) / nsmpl
    return R._optimal_k2(mean).numpy().astype(np.uint32)


def row_model(row: np.ndarray):
    """One row through the kernel's steps: (best, k2 [2^mp] with zeros past
    2^best, totals [mp + 1] uint32)."""
    n = row.shape[0]
    mp = R.max_porder_for(n)
    parts, length = 1 << mp, n >> mp
    threads, lcpp, chunk = plan(n, mp)
    cpp = 1 << lcpp
    u = zigzag(row)
    items = [(f, c) for f in range(parts) for c in range(cpp)]

    def span(f, c):
        i0 = f * length + c * chunk
        return i0, min(i0 + chunk, (f + 1) * length)

    # (2) the finest sums, then the tree: level p at tree[p]
    finest = np.zeros(parts, np.uint64)
    for f, c in items:
        i0, i1 = span(f, c)
        finest[f] += np.sum(u[i0:i1], dtype=np.uint64)
    tree = {mp: finest}
    for p in range(mp - 1, -1, -1):
        tree[p] = tree[p + 1][0::2] + tree[p + 1][1::2]
    # (3) every node's parameter
    k2s = {p: _fits(tree[p], n >> p) for p in range(mp + 1)}
    # (4) each thread's sums over its items, then (5) over the threads
    acc = np.zeros((threads, mp + 1), np.uint32)
    for item, (f, c) in enumerate(items):
        t = item % threads
        i0, i1 = span(f, c)
        for p in range(mp + 1):
            sh = mp - p
            j = f >> sh
            k = int(k2s[p][j])
            add = 0
            if c == 0 and f & ((1 << sh) - 1) == 0:
                add += (n >> p) * (k + 2)
                if j > 0:
                    add += gamma_bits(k - int(k2s[p][j - 1]))
            q = u[i0:i1] >> np.uint32(k)
            add += int(np.sum(np.maximum(q, np.uint32(2)) - np.uint32(2),
                              dtype=np.uint64))
            acc[t, p] = np.uint32((int(acc[t, p]) + add) & 0xFFFFFFFF)
    totals = np.asarray([(PARAMETER_BITS + int(np.sum(acc[:, p],
                                                      dtype=np.uint64)))
                         & 0xFFFFFFFF for p in range(mp + 1)], np.uint64)
    best = 0
    for p in range(1, mp + 1):
        if totals[p] < totals[best]:
            best = p
    k2 = np.zeros(parts, np.int32)
    k2[:1 << best] = k2s[best]
    return best, k2, totals


def model(data: np.ndarray):
    """data [..., n] int32 -> (best [...] int32, k2 [..., 2^mp] int32),
    row by row."""
    lead, n = data.shape[:-1], data.shape[-1]
    rows = data.reshape(-1, n)
    out = [row_model(r) for r in rows]
    mp = R.max_porder_for(n)
    best = np.asarray([o[0] for o in out], np.int32).reshape(lead)
    k2 = np.stack([o[1] for o in out]).reshape(lead + (1 << mp,))
    return best, k2


def _totals(u: np.ndarray):
    """Each order's total bits and parameters of one row of codes (int64),
    as the plain version forms them, and whether every parameter is the
    same with the partition sums divided by their lengths (the CPU) and
    multiplied by the reciprocal (the card)."""
    n = u.shape[0]
    totals, params, same = [], [], True
    for p in range(R.max_porder_for(n) + 1):
        ns = n >> p
        uv = u.reshape(1 << p, ns)
        sums = torch.from_numpy(uv.sum(1).astype(np.float64))
        k = R._optimal_k2(sums / ns).numpy().astype(np.int64)
        same &= bool(np.array_equal(
            k, R._optimal_k2(sums * (1.0 / ns)).numpy()))
        bits = int(np.sum(k[:, None] + 2 + np.maximum((uv >> k[:, None]) - 2,
                                                      0)))
        bits += PARAMETER_BITS + sum(gamma_bits(int(d)) for d in np.diff(k))
        totals.append(bits & 0xFFFFFFFF)
        params.append(k)
    return np.asarray(totals, np.int64), params, same


def tie_row(seed: int, n: int = 10240) -> np.ndarray:
    """An int32 residual row whose lowest total bits two orders share.

    From seeded Laplacian noise (the first half quieter), it raises the
    codes of samples whose parameter at the order with the least total is
    below the one at the runner-up order by that parameter's power of two:
    each costs the first order one bit and the second less, until the two
    totals meet. The parameters must not depend on how the partition
    sums are divided by their lengths, so the tie holds on the card."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.laplace(0, 40.0, n)).astype(np.int64)
    x[:n // 2] = np.round(x[:n // 2] * 0.6)
    u = (x << 1) ^ (x >> 63)
    for _ in range(4000):
        totals, params, same = _totals(u)
        least = totals.min()
        if same and np.sum(totals == least) >= 2:
            return np.where(u % 2 == 0, u // 2, -(u + 1) // 2).astype(
                np.int32)
        lo = int(np.argmin(totals))
        rest = totals.copy()
        rest[lo] = np.iinfo(np.int64).max
        hi = int(np.argmin(rest))
        k_lo = np.repeat(params[lo], n >> lo)
        k_hi = np.repeat(params[hi], n >> hi)
        cand = np.nonzero((k_lo < k_hi) & ((u >> k_lo) >= 2))[0]
        if not len(cand):
            break
        step = max(1, int(totals[hi] - totals[lo]) // 4)
        pick = rng.choice(cand, size=min(step, len(cand)), replace=False)
        u[pick] += 1 << k_lo[pick]
    raise ValueError(f"no tie from seed {seed}")


# Seeds whose tie_row ties orders (7, 8), (6, 7) and (3, 7).
TIE_SEEDS = (2, 3, 9)


def tie_plane(n: int = 10240) -> np.ndarray:
    """[len(TIE_SEEDS), n] int32: the tie rows."""
    return np.stack([tie_row(s, n) for s in TIE_SEEDS])


def fit_edges() -> list:
    """The least partition mean with parameter j, j = 1..31, by bisection
    over the float64 means on the plain version's `_optimal_k2` (CPU)."""
    edges = []
    for j in range(1, 32):
        lo, hi = 0.0, float(1 << 33)
        for _ in range(200):
            mid = (lo + hi) / 2
            if mid in (lo, hi):
                break
            k = int(R._optimal_k2(torch.tensor([mid], dtype=torch.float64)))
            lo, hi = (lo, mid) if k >= j else (mid, hi)
        edges.append(hi)
    return edges


def edge_plane(n: int = 10240) -> np.ndarray:
    """[rows, n] int32 residual rows whose finest partitions (1024 of 10
    samples) have sums within 3 of each parameter edge's times 10, between
    silent partitions, so that the finest order wins and every parameter
    near an edge is in the output."""
    length = n >> R.max_porder_for(n)
    sums = [int(e * length) + d for e in fit_edges() for d in range(-3, 4)]
    parts = n // length // 2  # a silent partition after each
    sums += [0] * (-len(sums) % parts)
    rows = []
    for r in range(0, len(sums), parts):
        codes = np.zeros((parts, 2, length), np.int64)
        s = np.asarray(sums[r:r + parts], np.int64)
        codes[:, 0] = s[:, None] // length
        codes[:, 0] += np.arange(length)[None] < (s % length)[:, None]
        u = codes.reshape(-1)
        rows.append(np.where(u % 2 == 0, u // 2, -(u + 1) // 2))
    return np.stack(rows).astype(np.int32)
