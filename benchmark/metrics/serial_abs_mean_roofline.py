"""`serial_abs_mean`'s share of its roofline: the serial mean absolute
residuals that pick the byte-exact fit's unit counts and ridge terms, as
many and at the shapes the window launched (the program's tally,
`exact_serial.LAUNCH_SHAPES`), at the FP64 peak or the memory bandwidth
(benchmark/roofline.py), over the summed device seconds of
`abs_mean_kernel` in the trace."""

from benchmark.entries import exact_encode


def read(ctx):
    return exact_encode.kernel_roofline(
        ctx, "serial_abs_mean", ("abs_mean_kernel",))
