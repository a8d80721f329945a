"""`lpc_autocorr`'s share of its roofline: the windowed autocorrelation
that the batched analysis of the window's full blocks needs (every
layer's candidate unit splits and the block-type estimate), at the FP64
peak or the memory bandwidth, over the summed device seconds of
`lpc_autocorr_kernel` in the trace.

Operations: a multiply-add is two. For each candidate unit count u of a
layer, each of the u units of ns = n / u samples forms lags 0..order / u,
lag l with ns - l products; the estimate forms lags 0..orders[0] over the
whole block. The first layer (whose input is the same for every ridge
term) and the estimate count once a block and channel, each later layer
once a ridge term too. Bytes: each distinct input read once (the
estimate's block, the first layer's input once for all the ridge terms,
each later layer's input once a ridge term, each window once) and every
autocorrelation written once (the first layer's once for all the ridge
terms)."""

from benchmark import roofline


def _mads(n: int, order: int, units) -> int:
    """Multiply-adds of one row's candidates: u units of n / u samples,
    lags 0..order / u."""
    total = 0
    for u in units:
        ns = n // u
        total += u * sum(max(0, ns - lag) for lag in range(order // u + 1))
    return total


def work(blocks: int, channels: int, n: int, orders, ridges: int):
    """(float64 operations, bytes) of the autocorrelations of `blocks` full
    blocks of `channels` channels and n samples under the layers `orders`
    and `ridges` ridge terms."""
    rows = blocks * channels
    est = orders[0] + 1
    mads = rows * _mads(n, orders[0], [1])
    nbytes = 8 * (rows * n + n + rows * est)  # block, window, ac
    for li, order in enumerate(orders):
        units = roofline.unit_counts(order, n)
        copies = rows * (1 if li == 0 else ridges)
        mads += copies * _mads(n, order, units)
        nbytes += 8 * copies * n  # the layer's input
        nbytes += 8 * sum(n // u for u in units)  # its windows
        nbytes += 8 * copies * sum(u * (order // u + 1) for u in units)
    return 2.0 * mads, float(nbytes)


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    secs = t.kernel_s.get("lpc_autocorr_kernel")
    if not secs:
        return None
    cfg = ctx["config"]
    f = cfg["format"]
    ops, nbytes = work(ctx["full_blocks"], f["num_channels"],
                       f["num_samples_per_block"], cfg["layer_num_params"],
                       len(cfg["ridge_terms"]))
    return roofline.share_pct(ops, roofline.FP64_FLOPS, nbytes, secs)
