"""Milliseconds in which the card ran anything (kernels and copies,
overlaps counted once) over the minutes of audio in the folders decoded
in the window: the card time a minute of audio occupies, which a user
pays for on a card that several jobs share, and the part of the wall
that no change on the host removes. The profiler records the window's
card activity; nothing where it holds none."""


def read(ctx):
    busy = ctx["device_busy_s"]
    if not busy or not ctx["audio_s"]:
        return None
    return 1e3 * busy / (ctx["audio_s"] / 60.0)
