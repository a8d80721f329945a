"""`device_idle_pct.encode`'s reading in the `-l` cell: the share of the
traced window with no kernel or copy on the card; nothing where the trace
holds no device activity. Split from it because this cell reports
`setup_s` and not the card time a minute of audio."""

import pathlib
import runpy

read = runpy.run_path(str(pathlib.Path(__file__).with_name(
    "device_idle_pct.encode.py")))["read"]
