"""`autocorr_serial`'s share of its roofline: the serial-order
autocorrelations of the byte-exact fit's windowed unit segments, as many
and at the shapes the window launched (the program's tally,
`exact_serial.LAUNCH_SHAPES`), at the FP64 peak or the memory bandwidth
(benchmark/roofline.py), over the summed device seconds of
`autocorr_kernel` in the trace."""

from benchmark.entries import exact_encode


def read(ctx):
    return exact_encode.kernel_roofline(
        ctx, "autocorr_serial", ("autocorr_kernel",))
