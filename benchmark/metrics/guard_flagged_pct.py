"""Share of the byte-exact fit's rows that the byte-identity guard sent to
the host oracle in the window (`DeviceExactEncoder.guard_rows_flagged`
over `guard_rows_total`, window deltas)."""


def read(ctx):
    c = ctx["counters"]
    if not c.get("guard_rows_total"):
        return None
    return 100.0 * c["guard_rows_flagged"] / c["guard_rows_total"]
