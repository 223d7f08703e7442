"""Process start to the first timed call (host clock, s)."""


def read(run):
    return run.setup_s
