"""`synthesize_rows`'s share of its roofline: the integer synthesis that
the window's decoded compress blocks need under the unit counts their
streams carry (benchmark/roofline.py), at the int32 multiply-add peak or
the memory bandwidth, over the summed device seconds of
`synth_rows_kernel` in the trace."""

from benchmark import roofline
from benchmark.entries import decode


def read(ctx):
    t = ctx["trace"]
    if t is None or not ctx["program_inputs"]:
        return None
    secs = t.kernel_s.get("synth_rows_kernel")
    if not secs:
        return None
    rows = decode.synthesis_rows(ctx["config"], ctx["program_inputs"],
                                 ctx["counts"])
    ops, nbytes = roofline.predict_rows_work(rows)
    return roofline.share_pct(ops, roofline.INT32_MAD_PER_S, nbytes, secs)
