"""Stream bytes over 16-bit PCM bytes, x 100, over the corpus's distinct
tracks, each taken at its first output of the window (the upstream's
compression rate). It does not depend on how many passes the window
made; it is left out where the window did not reach every track."""


def read(ctx):
    corpus = ctx["corpus"]
    first = {}
    for ti, data in ctx["outputs"]:
        first.setdefault(ti, data)
    if len(first) < len(corpus.tracks):
        return None
    width = corpus.bits_per_sample // 8
    pcm = sum(corpus.tracks[ti].size * width for ti in first)
    return 100.0 * sum(len(d) for d in first.values()) / pcm
