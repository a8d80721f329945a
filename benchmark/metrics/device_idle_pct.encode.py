"""Share of the traced window with no kernel or copy on the card; nothing
where the trace holds no device activity."""


def read(ctx):
    t = ctx["trace"]
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
