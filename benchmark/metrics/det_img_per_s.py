"""Images detected in the window over its length (host clock)."""


def read(run):
    return run.items / run.seconds if run.seconds > 0 else None
