"""`rice_search`'s share of its roofline: the partitioned-Rice parameter
search of the window's full blocks (the finish stage's, one launch a
batch), at the int32 issue rate or the memory bandwidth, over the summed
device seconds of `rice_search_kernel` in the trace.

Operations, from the shapes alone: each row (block and channel) of n
residuals has 2^mp finest partitions (mp the largest order whose
partitions divide n, at most 10); each sample costs its load, its
zigzag code and its add to the finest partition's sum, then a shift, a
clamp and an add at each of the mp + 1 orders: n (3 (mp + 1) + 3) a row,
counted as int32 operations at the multiply-add rate. Bytes: the residual plane read once, each row's
order and 2^mp parameters written once (int32). Left out: each
partition's float64 parameter fit (2^(mp+1) - 1 a row) and the device
tails (the blocks past a track's last full block), so the count is a
lower bound on the work and the share can only read low. Padding rows of
a part-filled batch are not counted either."""

from benchmark import roofline
from benchmark.reference.analysis import max_porder


def work(blocks: int, channels: int, n: int):
    """(int32 operations, bytes) of the Rice searches of `blocks` full
    blocks of `channels` channels and n samples."""
    rows = blocks * channels
    mp = max_porder(n)
    ops = rows * n * (3 * (mp + 1) + 3)
    nbytes = 4 * rows * n + 4 * rows * (1 + (1 << mp))
    return float(ops), float(nbytes)


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    secs = t.kernel_s.get("rice_search_kernel")
    if not secs:
        return None
    f = ctx["config"]["format"]
    ops, nbytes = work(ctx["full_blocks"], f["num_channels"],
                       f["num_samples_per_block"])
    return roofline.share_pct(ops, roofline.INT32_MAD_PER_S, nbytes, secs)
