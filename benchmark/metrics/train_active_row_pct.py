"""Share of the `-l` trainer's row-iterations in the window whose row was
still active (`train_active_row_iterations` over `train_row_iterations`,
x 100): the rest are computed and update nothing. Nothing where the
program has no such counters or trained no row."""


def read(ctx):
    c = ctx["counters"]
    if not c.get("train_row_iterations"):
        return None
    return 100.0 * c["train_active_row_iterations"] / c["train_row_iterations"]
