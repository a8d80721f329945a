"""The `-l` trainer's loop iterations a batch in the window
(`TorchEncoder.train_iterations` over `train_batches`): the loop runs until
the batch's last row stops, so this is the batch's slowest row. Nothing
where the program has no such counters or trained no batch."""


def read(ctx):
    c = ctx["counters"]
    if not c.get("train_batches"):
        return None
    return c["train_iterations"] / c["train_batches"]
