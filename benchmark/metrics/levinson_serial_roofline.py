"""`levinson_serial`'s share of its roofline: the byte-exact fit's
Levinson-Durbin recursions, as many and at the shapes the window
launched (the program's tally, `exact_serial.LAUNCH_SHAPES`), at the
FP64 peak or the memory bandwidth (benchmark/roofline.py), over the
summed device seconds of `levinson_thread_kernel` and
`levinson_warp_kernel` in the trace."""

from benchmark.entries import exact_encode


def read(ctx):
    return exact_encode.kernel_roofline(
        ctx, "levinson_serial",
        ("levinson_thread_kernel", "levinson_warp_kernel"))
