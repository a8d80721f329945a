"""Share of the window's stage runs served by a replay of a captured CUDA
graph (`StageGraphs` replays over replays and eager runs)."""


def read(ctx):
    c = ctx["counters"]
    runs = c.get("graph_replays", 0) + c.get("graph_eager_runs", 0)
    if not runs:
        return None
    return 100.0 * c["graph_replays"] / runs
