"""`levinson_durbin`'s share of its roofline: the Levinson-Durbin
recursions the batched analysis of the window's full blocks needs
(benchmark/roofline.py), at the FP64 peak or the memory bandwidth, over
the summed device seconds of `levinson_kernel` in the trace."""

from benchmark import roofline


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    secs = t.kernel_s.get("levinson_kernel")
    if not secs:
        return None
    cfg = ctx["config"]
    f = cfg["format"]
    ops, nbytes = roofline.levinson_durbin_work(
        ctx["full_blocks"], f["num_channels"], f["num_samples_per_block"],
        cfg["layer_num_params"], len(cfg["ridge_terms"]))
    return roofline.share_pct(ops, roofline.FP64_FLOPS, nbytes, secs)
