"""Share of the window in which the byte-exact encode's framing waited for
fit rows not yet back from the card (`DeviceExactEncoder.fit_wait_s`,
the window's delta, over the window's seconds); nothing where the
program keeps no such counter."""


def read(ctx):
    c = ctx["counters"]
    if "fit_wait_s" not in c or not ctx["window_s"]:
        return None
    return 100.0 * c["fit_wait_s"] / ctx["window_s"]
