"""`graph_replay_pct`'s reading in the `-l` cell: the share of the
window's stage runs (graphs G1 and G2 around the eager trainer) served by
a replay of a captured CUDA graph. Split from it because this cell reports
`setup_s` and not the card time a minute of audio."""

import pathlib
import runpy

read = runpy.run_path(str(pathlib.Path(__file__).with_name(
    "graph_replay_pct.py")))["read"]
