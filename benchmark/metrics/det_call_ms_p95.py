"""95th percentile of every `Detector.__call__` of the window (host
clock, ms)."""

from benchmark.harness import percentile


def read(run):
    return percentile(run.latencies_ms, 95) if run.latencies_ms else None
