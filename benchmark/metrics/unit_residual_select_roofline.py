"""`unit_residual_select`'s share of its roofline: the residual pass of
every layer's unit-count sweep that the batched analysis of the window's
full blocks needs, at the FP64 peak or the memory bandwidth, over the
summed device seconds of `unit_residual_kernel` in the trace.

Operations: for every ridge term, layer and candidate unit count u, each
row (block and channel) filters its n samples with order / u taps, a
multiply-add (two operations) a tap and sample; the winner's residual,
which the kernel computes again, is not counted. Bytes: each distinct
input read once (the first layer's input once for all the ridge terms,
each later layer's input once a ridge term, every candidate's
coefficients) and each output written once (the winner's residual,
coefficients, loss and unit count)."""

from benchmark import roofline


def work(blocks: int, channels: int, n: int, orders, ridges: int):
    """(float64 operations, bytes) of the residual passes of `blocks` full
    blocks of `channels` channels and n samples under the layers `orders`
    and `ridges` ridge terms."""
    rows = blocks * channels
    ops = nbytes = 0
    for li, order in enumerate(orders):
        units = roofline.unit_counts(order, n)
        ops += ridges * rows * sum(2 * n * (order // u) for u in units)
        nbytes += 8 * rows * n * (1 if li == 0 else ridges)  # the input
        nbytes += 8 * ridges * rows * order * len(units)  # coefficients
        nbytes += ridges * rows * (8 * n + 8 * order + 8 + 4)  # winners
    return float(ops), float(nbytes)


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    secs = t.kernel_s.get("unit_residual_kernel")
    if not secs:
        return None
    cfg = ctx["config"]
    f = cfg["format"]
    ops, nbytes = work(ctx["full_blocks"], f["num_channels"],
                       f["num_samples_per_block"], cfg["layer_num_params"],
                       len(cfg["ridge_terms"]))
    return roofline.share_pct(ops, roofline.FP64_FLOPS, nbytes, secs)
