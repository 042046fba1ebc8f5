"""setup_s: process start to the window's opening (host clock, s)."""


def read(run):
    return run.setup_s
