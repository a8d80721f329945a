"""Bytes the encoder copied from the card to the host in the window
(`TorchEncoder.bytes_to_host`: packed batches and rows fetched past the
residual width) over the full blocks encoded."""


def read(ctx):
    c = ctx["counters"]
    if "bytes_to_host" not in c or not ctx["full_blocks"]:
        return None
    return c["bytes_to_host"] / ctx["full_blocks"]
