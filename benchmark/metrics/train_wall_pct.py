"""Share of the window's host seconds spent inside the `-l` trainer
(`TorchEncoder.train_s`, the span `encode.train`, over the window, x 100).
Nothing where the program has no such counter."""


def read(ctx):
    c = ctx["counters"]
    if "train_s" not in c or not ctx["window_s"]:
        return None
    return 100.0 * c["train_s"] / ctx["window_s"]
