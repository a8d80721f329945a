"""`predict_dense`'s share of its roofline: the integer prediction that
the window's full compress blocks need under the unit counts their
streams carry (benchmark/roofline.py), at the int32 multiply-add peak or
the memory bandwidth, over the summed device seconds of `predict_kernel`
in the trace."""

from benchmark import roofline
from benchmark.entries import encode


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    secs = t.kernel_s.get("predict_kernel")
    if not secs:
        return None
    rows = encode.predict_rows(ctx["config"], ctx["judged"], ctx["counts"])
    ops, nbytes = roofline.predict_rows_work(rows)
    return roofline.share_pct(ops, roofline.INT32_MAD_PER_S, nbytes, secs)
