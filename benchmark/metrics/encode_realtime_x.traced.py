"""Seconds of audio in the folders encoded in the window over the
window's seconds (the upstream's encode time as a share of the tracks'
duration, inverted), read in the traced run, under the profiler. It is
a per-layer metric because the host clock's rate spreads from run to run
by more than the largest bound allows."""


def read(ctx):
    return ctx["audio_s"] / ctx["window_s"]
