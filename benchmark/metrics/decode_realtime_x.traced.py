"""Seconds of audio in the folders decoded in the window over the
window's seconds, read in the traced run, under the profiler. It is a
per-layer metric because the host clock's rate spreads from run to run
by more than the largest bound allows."""


def read(ctx):
    return ctx["audio_s"] / ctx["window_s"]
