"""Milliseconds a call in the det_network span (the benchmark's wrapper; see the
entry's spans())."""

from benchmark.harness import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "det_network")
