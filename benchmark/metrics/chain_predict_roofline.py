"""`chain_predict`'s share of its roofline: the float64 tap chains of the
byte-exact fit's unit predictions, as many and at the shapes the window
launched (the program's tally, `exact_serial.LAUNCH_SHAPES`), at the
FP64 peak or the memory bandwidth (benchmark/roofline.py), over the
summed device seconds of `chain_predict_kernel` in the trace."""

from benchmark.entries import exact_encode


def read(ctx):
    return exact_encode.kernel_roofline(
        ctx, "chain_predict", ("chain_predict_kernel",))
