"""Seconds from the process's start to the first timed folder: imports,
the card's context, the kernels' builds or loads, the corpus, the
program's objects and their warm-up."""


def read(ctx):
    return ctx["setup_s"]
