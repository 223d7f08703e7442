"""The profiled phase's share of wall time with no operation on the
device (%)."""

from benchmark.harness import idle_pct


def read(run):
    return idle_pct(run)
